// Device code shared by the colored sweep kernels (colored_sweeps.cu: K1;
// colored_sweeps_nbr.cu: K2 and K3) and the whole-round kernels
// (ensemble_round.cu). A sweep kernel's CTA owns one replica for all T
// sweeps, with its phi (f32) and m (int8) in shared memory; these helpers are
// the heat-bath draw, K1's flip list and the end-of-sweep energy that the
// sweep kernels run the same way, so that on one layout and one seed K1, K2
// and K3 compute the same function draw for draw. The neighbour-list phi
// update `gather_block` is the whole-round kernels'; K2/K3 run their own
// step gather (colored_sweeps_nbr.cu), which starts from phi as K1 does.
//
// Random numbers: Philox-4x32-10 with key = seed and counter = (spin column,
// replica, sweep, 0); the uniform is (bits >> 8) * 2^-24 as on the TPU. The
// two seed words are read from device memory, so the caller draws them on
// the card without a host sync. A non-null `uniforms` pointer
// ([T, R, n_pad] f32) replaces Philox so a kernel can be held against its
// plain torch version draw for draw.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace nmc {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t philox4x32_10_word0(
    uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3,
    uint32_t k0, uint32_t k1) {
  // Salmon et al., "Parallel random numbers: as easy as 1, 2, 3" (SC'11).
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

// What one replica's draws read. K1 multiplies beta_t * beta_spin[col]; the
// streamed kernels K2/K3 multiply (beta_t * beta_row) * beta_spin[col], in
// that order as the Pallas kernels do, and skip the last factor when
// beta_spin is null (the Pallas kernels multiply by 1 there).
struct ReplicaDraws {
  const float* beta_spin;  // this replica's row [n_pad], or null (K2/K3)
  const uint8_t* mask;     // this replica's update mask row [n_pad]
  const float* uniforms;   // [T, R, n_pad] injected draws, or null
  size_t u_offset;         // r * n_pad
  size_t u_sweep;          // R * n_pad
  float beta_row;          // per-replica factor (K2/K3)
  uint32_t r, seed0, seed1;
};

// Heat-bath draws for the n spins starting at column s: every unmasked spin
// takes +1 with p_up = (1 + tanh(beta * phi)) / 2 at once (exact Gibbs when
// they are an independent set). dm[i] gets new - old of spin s + i, as a
// float (K1) or an int8 (K2/K3).
template <bool kRowBeta, typename D>
__device__ __forceinline__ void draw_block(
    const ReplicaDraws& a, int t, float beta_t, int s, int n,
    const float* phi, int8_t* m, D* dm) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int col = s + i;
    D d = 0;
    if (a.mask[col]) {
      float u;
      if (a.uniforms != nullptr) {
        u = a.uniforms[(size_t)t * a.u_sweep + a.u_offset + col];
      } else {
        const uint32_t bits = philox4x32_10_word0(
            (uint32_t)col, a.r, (uint32_t)t, 0u, a.seed0, a.seed1);
        u = (float)(bits >> 8) * 5.9604644775390625e-08f;  // 2^-24
      }
      float betab;
      if (kRowBeta) {
        betab = beta_t * a.beta_row;
        if (a.beta_spin != nullptr) betab = betab * a.beta_spin[col];
      } else {
        betab = beta_t * a.beta_spin[col];
      }
      const float p_up = 0.5f * (1.0f + tanhf(betab * phi[col]));
      const int8_t old = m[col];
      const int8_t nw = u < p_up ? 1 : -1;
      m[col] = nw;
      d = (D)(nw - old);
    }
    dm[i] = d;
  }
}

// Warp 0 lists the block's flipped spins (dm != 0) in spin order with a
// ballot (K1); the caller synchronises before and after.
__device__ __forceinline__ void list_flips(const float* dm, int* flips,
                                           int* num_flips, int B) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int count = 0;
  for (int chunk = 0; chunk < B; chunk += 32) {
    const int i = chunk + lane;
    const bool flipped = i < B && dm[i] != 0.f;
    const unsigned ballot = __ballot_sync(0xffffffffu, flipped);
    if (flipped) flips[count + __popc(ballot & ((1u << lane) - 1u))] = i;
    count += __popc(ballot);
  }
  if (lane == 0) *num_flips = count;
}

// The whole-round kernels' coupling layout (ops/round_cuda.py,
// RoundNeighbors), per row block b of B spins: the targets j with a coupling
// from a spin of b, and for each target its sources k in b in ascending k.
// The weights w[e] of an instance follow the source entries.
struct Neighbors {
  const int32_t* tgt_ptr;  // [nB + 1] block b's targets: [tgt_ptr[b], tgt_ptr[b+1])
  const int16_t* tgt;      // [n_tgt] target spin j
  const int32_t* src_ptr;  // [n_tgt + 1] target t's sources: [src_ptr[t], src_ptr[t+1])
  const int16_t* src;      // [nnz] source offset k - b * B within the block
};

// phi[j] += sum_k x[k - b * B] * w[k, j] for every target j of row block b:
// one thread owns a target, sums from 0 over its sources in ascending k
// with fmaf and adds the sum into phi once, so no atomics are needed and
// the work is the block's couplings, whatever x holds. x is the block's
// [B] values (dm, or m of the block). The caller synchronises before and
// after.
template <typename X>
__device__ __forceinline__ void gather_block(const Neighbors& nb,
                                             const float* w, int b,
                                             const X* x, float* phi) {
  const int t1 = __ldg(nb.tgt_ptr + b + 1);
  for (int t = __ldg(nb.tgt_ptr + b) + threadIdx.x; t < t1; t += blockDim.x) {
    const int e1 = __ldg(nb.src_ptr + t + 1);
    float acc = 0.f;
    for (int e = __ldg(nb.src_ptr + t); e < e1; ++e)
      acc = fmaf((float)x[__ldg(nb.src + e)], __ldg(w + e), acc);
    phi[__ldg(nb.tgt + t)] += acc;
  }
}

// Warp 0: E = -0.5 * m.(phi + h) into energies[t, r] and the running best
// (strict <). The xor butterfly leaves the same sum in every lane, so the
// best-state branch is warp-uniform. The caller synchronises after.
__device__ __forceinline__ void end_of_sweep(
    const int8_t* m, const float* phi, const float* h, int n_pad,
    float* energy_tr, float* m_best_r, float& e_best) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float acc = 0.f;
  for (int j = lane; j < n_pad; j += 32)
    acc += (float)m[j] * (phi[j] + h[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  const float e = -0.5f * acc;
  if (lane == 0) *energy_tr = e;
  if (e < e_best) {
    for (int j = lane; j < n_pad; j += 32) m_best_r[j] = (float)m[j];
    e_best = e;
  }
}

}  // namespace nmc
