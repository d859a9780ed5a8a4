// Colored-block heat-bath Gibbs sweeps with the replica state on chip, J dense.
//
// colored_sweeps_f32 replaces nmc_tpu/ops/sweeps_pallas.py::
// pallas_colored_sweeps (K1, J resident in VMEM on the TPU; n_pad <= 1536
// in the engine). It computes T sweeps over the colour blocks of a
// graph-coloured layout: per block of B spins every spin draws from its
// heat-bath probability p_up = (1 + tanh(beta * phi)) / 2 at once (exact
// Gibbs, the block is an independent set), masked spins keep their value,
// and the cached local fields follow with phi += dm @ J[block, :]. Each
// sweep ends with E = -0.5 * m.(phi + h) per replica and a running best
// state and energy (strict <, e_best starting at +inf, m_best starting at
// m0). beta = beta_t * beta_spin with a [R, n_pad] mask. The streamed
// kernels K2/K3 compute the same function over a neighbour layout
// (colored_sweeps_nbr.cu); on one layout and one seed the three agree bit
// for bit.
//
// Design: one CTA owns one replica for all T sweeps (grid = R). Its phi
// (f32) and m (int8) stay in shared memory (5 bytes per spin). The phi
// update runs over the changed spins only (dm is 0 or +-2): after the draw,
// one warp compacts the block's flipped spins into a list (ballot, in spin
// order), and each thread then walks that list for its phi columns with the
// J-row loads independent of each other, so several are in flight at once.
// The FMAs run in spin order, so phi is bit-for-bit what a sequential pass
// over the flips gives.
//
// Bound: per attempt one Philox-4x32-10 and one tanhf; per flip the kernel
// streams the whole J row (n_pad floats) although a sparse topology's row
// holds a handful of nonzeros. At chimera-512 (n_pad = 640) J is 1.6 MB and
// stays in the 50 MB L2, so L2 bandwidth bounds K1.
//
// One replica per CTA was fastest on an H100 80GB HBM3 at 700 W, chimera-512
// (n_pad = 640), beta = 2: R = 2048, 2.8e10 attempts/s against 2.6e10 with 4
// and 1.7e10 with 8 replicas per CTA; R = 256, 1.35e10 against 8.3e9 with 2
// (fewer CTAs than SMs). The phi update streams the J rows of flipped spins
// from L2, and small CTAs keep 8 of them in flight per SM.
//
// Random numbers: see sweep_common.cuh (Philox keyed by (seed, replica,
// sweep, spin), or injected uniforms).

#include "sweep_common.cuh"

namespace {

using nmc::kThreads;

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
  const size_t base = (size_t)r * n_pad;
  nmc::ReplicaDraws draws;
  draws.beta_spin = beta_spin + base;
  draws.mask = mask + base;
  draws.uniforms = uniforms;
  draws.u_offset = base;
  draws.u_sweep = (size_t)R * n_pad;
  draws.beta_row = 1.f;
  draws.r = (uint32_t)r;
  draws.seed0 = uniforms == nullptr ? (uint32_t)seed[0] : 0u;
  draws.seed1 = uniforms == nullptr ? (uint32_t)seed[1] : 0u;

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
      nmc::draw_block<false>(draws, t, beta_t, s, B, phi, m, dm);
      __syncthreads();
      nmc::list_flips(dm, flips, &num_flips, B);
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
    nmc::end_of_sweep(m, phi, h, n_pad, energies + (size_t)t * R + r,
                      m_best + base, e_best);
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

// K1. Launches the kernel on `stream`; returns the cudaError_t of the launch.
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
