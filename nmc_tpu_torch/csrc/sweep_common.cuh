// Device code shared by the colored sweep kernels (colored_sweeps_nbr.cu:
// K1, K2 and K3), the sequential sweeps (sequential_sweeps.cu) and the
// whole-round kernels (ensemble_round.cu): the Philox-4x32-10 generator all
// draw from, and the whole-round kernels' neighbour layout and its phi
// update `gather_block`. The sweep kernels run their own draws and phi
// updates, over P replicas per CTA.
//
// Random numbers: Philox-4x32-10 with key = seed and counter = (spin column,
// replica, sweep, 0) in the sweep kernels; the uniform is (bits >> 8) *
// 2^-24 as on the TPU. The two seed words are read from device memory, so
// the caller draws them on the card without a host sync. A non-null
// `uniforms` pointer ([T, R, n_pad] f32) replaces Philox so a kernel can be
// held against its plain torch version draw for draw.

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

}  // namespace nmc
