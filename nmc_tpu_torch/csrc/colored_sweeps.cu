// Colored-block heat-bath Gibbs sweeps with the replica state on chip.
//
// Replaces nmc_tpu/ops/sweeps_pallas.py::pallas_colored_sweeps (the Pallas
// TPU kernel `_kernel`). It computes the same function: T sweeps over the
// colour blocks of a graph-coloured layout; per block of B spins every spin
// draws from its heat-bath probability p_up = (1 + tanh(beta_t * beta_spin
// * phi)) / 2 at once (exact Gibbs, the block is an independent set), masked
// spins keep their value, and the cached local fields follow with
// phi += dm @ J[block, :]. Each sweep ends with E = -0.5 * m.(phi + h) per
// replica and a running best state and energy (strict <, e_best starting at
// +inf, m_best starting at m0).
//
// Design: one CTA owns one replica for all T sweeps (grid = R). Its phi
// (f32) and m (int8) stay in shared memory; J [n_pad, n_pad] f32 is read from
// global memory and at chimera-512 size (n_pad = 640, 1.6 MB) stays in the
// 50 MB L2. beta_spin and the mask are read from global memory per block.
// The phi update runs over the changed spins only (dm is 0 or +-2): after the
// draw, one warp compacts the block's flipped spins into a list (ballot, in
// spin order), and each thread then walks that list for its phi
// columns with the J-row loads independent of each other, so several are in
// flight at once. The FMAs run in spin order, so phi is bit-for-bit what a
// sequential pass over the flips gives.
//
// Bound: at most R * n_pad^2 FMAs per sweep on the CUDA cores; in practice
// the flip rate sets the work, and each flipped spin streams its whole J row
// (n_pad floats) from L2 although a sparse topology's row holds a handful of
// nonzeros, so L2 bandwidth bounds the kernel. Later versions restrict the
// update to the nonzero couplings or move it to wgmma (exact in bf16 for +-J
// couplings), and may bit-pack m.
//
// One replica per CTA was fastest on an H100 80GB HBM3 at 700 W, chimera-512
// (n_pad = 640), beta = 2: R = 2048, 2.8e10 attempts/s against 2.6e10 with 4
// and 1.7e10 with 8 replicas per CTA; R = 256, 1.35e10 against 8.3e9 with 2
// (fewer CTAs than SMs). The phi update streams the J rows of flipped spins
// from L2, and small CTAs keep 8 of them in flight per SM.
//
// Random numbers: Philox-4x32-10 with key = seed and counter = (spin column,
// replica, sweep, 0); the uniform is (bits >> 8) * 2^-24 as on the TPU. The
// two seed words are read from device memory, so the caller draws them on
// the card without a host sync. A non-null `uniforms`
// pointer ([T, R, n_pad] f32) replaces Philox so the kernel can be held
// against its plain torch version draw for draw.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

__global__ void __launch_bounds__(kThreads) colored_sweeps_kernel(
    const float* __restrict__ J,          // [n_pad, n_pad]
    const float* __restrict__ h,          // [n_pad]
    const float* __restrict__ m0,         // [R, n_pad]
    const float* __restrict__ phi0,       // [R, n_pad]
    const float* __restrict__ beta_spin,  // [R, n_pad]
    const uint8_t* __restrict__ mask,     // [R, n_pad] (bool storage)
    const float* __restrict__ beta_sweep, // [T]
    const float* __restrict__ uniforms,   // [T, R, n_pad] or null
    const int32_t* __restrict__ seed,     // [2], read when uniforms is null
    float* __restrict__ m_out,            // [R, n_pad]
    float* __restrict__ phi_out,          // [R, n_pad]
    float* __restrict__ m_best,           // [R, n_pad]
    float* __restrict__ e_best_out,       // [R]
    float* __restrict__ energies,         // [T, R]
    int R, int n_pad, int B, int T) {
  extern __shared__ float smem[];
  float* phi = smem;                                  // [n_pad]
  float* dm = phi + n_pad;                            // [B]
  int* flips = reinterpret_cast<int*>(dm + B);        // [B]
  int8_t* m = reinterpret_cast<int8_t*>(flips + B);   // [n_pad]
  __shared__ int num_flips;

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = (size_t)r * n_pad;
  uint32_t seed0 = 0u, seed1 = 0u;
  if (uniforms == nullptr) {
    seed0 = (uint32_t)seed[0];
    seed1 = (uint32_t)seed[1];
  }

  for (int k = tid; k < n_pad; k += blockDim.x) {
    const float mv = m0[base + k];
    m[k] = mv > 0.f ? 1 : -1;
    phi[k] = phi0[base + k];
    m_best[base + k] = mv;
  }
  float e_best = INFINITY;  // kept by warp 0, which computes the energies
  __syncthreads();

  const int num_blocks = n_pad / B;
  for (int t = 0; t < T; ++t) {
    const float beta_t = beta_sweep[t];
    for (int b = 0; b < num_blocks; ++b) {
      const int s = b * B;
      // heat-bath draw for every spin of the block
      for (int i = tid; i < B; i += blockDim.x) {
        const int col = s + i;
        const size_t g = base + col;
        float d = 0.f;
        if (mask[g]) {
          float u;
          if (uniforms != nullptr) {
            u = uniforms[(size_t)t * R * n_pad + g];
          } else {
            const uint32_t bits = philox4x32_10_word0(
                (uint32_t)col, (uint32_t)r, (uint32_t)t, 0u, seed0, seed1);
            u = (float)(bits >> 8) * 5.9604644775390625e-08f;  // 2^-24
          }
          const float betab = beta_t * beta_spin[g];
          const float p_up = 0.5f * (1.0f + tanhf(betab * phi[col]));
          const int8_t old = m[col];
          const int8_t nw = u < p_up ? 1 : -1;
          m[col] = nw;
          d = (float)(nw - old);
        }
        dm[i] = d;
      }
      __syncthreads();
      // list the flipped spins, in spin order
      if (warp == 0) {
        int count = 0;
        for (int chunk = 0; chunk < B; chunk += 32) {
          const int i = chunk + lane;
          const bool flipped = i < B && dm[i] != 0.f;
          const unsigned ballot = __ballot_sync(0xffffffffu, flipped);
          if (flipped) flips[count + __popc(ballot & ((1u << lane) - 1u))] = i;
          count += __popc(ballot);
        }
        if (lane == 0) num_flips = count;
      }
      __syncthreads();
      // phi[:] += sum_i dm[i] * J[s + i, :] over the flipped spins
      const int nf = num_flips;
      for (int j = tid; j < n_pad; j += blockDim.x) {
        float acc = phi[j];
#pragma unroll 4
        for (int f = 0; f < nf; ++f) {
          const int i = flips[f];
          acc = fmaf(dm[i], __ldg(J + (size_t)(s + i) * n_pad + j), acc);
        }
        phi[j] = acc;
      }
      __syncthreads();
    }
    // energy in warp 0; the xor butterfly leaves the same sum in every lane,
    // so the best-state branch is warp-uniform
    if (warp == 0) {
      float acc = 0.f;
      for (int j = lane; j < n_pad; j += 32)
        acc += (float)m[j] * (phi[j] + h[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      const float e = -0.5f * acc;
      if (lane == 0) energies[(size_t)t * R + r] = e;
      if (e < e_best) {
        for (int j = lane; j < n_pad; j += 32)
          m_best[base + j] = (float)m[j];
        e_best = e;
      }
    }
    __syncthreads();
  }

  for (int k = tid; k < n_pad; k += blockDim.x) {
    m_out[base + k] = (float)m[k];
    phi_out[base + k] = phi[k];
  }
  if (tid == 0) e_best_out[r] = e_best;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
int colored_sweeps_f32(const float* J, const float* h, const float* m0,
                       const float* phi0, const float* beta_spin,
                       const uint8_t* mask, const float* beta_sweep,
                       const float* uniforms, const int32_t* seed,
                       float* m_out, float* phi_out, float* m_best,
                       float* e_best, float* energies, int R, int n_pad,
                       int block_size, int num_sweeps, void* stream) {
  const size_t smem = (size_t)n_pad * sizeof(float)         // phi
                      + (size_t)block_size * sizeof(float)  // dm
                      + (size_t)block_size * sizeof(int)    // flips
                      + (size_t)n_pad;                      // m (int8)
  cudaError_t err = cudaFuncSetAttribute(
      colored_sweeps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (R == 0) return (int)cudaSuccess;
  colored_sweeps_kernel<<<R, kThreads, smem, (cudaStream_t)stream>>>(
      J, h, m0, phi0, beta_spin, mask, beta_sweep, uniforms, seed, m_out,
      phi_out, m_best, e_best, energies, R, n_pad, block_size, num_sweeps);
  return (int)cudaGetLastError();
}

}  // extern "C"
