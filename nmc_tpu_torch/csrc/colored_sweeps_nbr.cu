// Colored heat-bath Gibbs sweeps over a neighbour layout, one step per
// colour class, with the replica state on chip.
//
// Two entry points, one kernel body:
//   colored_sweeps_streamed_f32  replaces nmc_tpu/ops/sweeps_pallas.py::
//                                pallas_colored_sweeps_streamed (K2, dense J
//                                row blocks double-buffered from HBM on the
//                                TPU; the engine's route above n_pad 1536
//                                when most column tiles hold a coupling);
//   colored_sweeps_sparse_f32    replaces ::pallas_colored_sweeps_sparse (K3,
//                                each row block's nonzero column tiles; the
//                                route when they are few).
// Both compute what the Pallas kernels compute: T colored block-Jacobi
// heat-bath sweeps with beta = (beta_t * beta_row[r]) * beta_spin (beta_spin
// optional), a [1 | R, n_pad] update mask, per-sweep energies
// E = -1/2 m.(phi + h) and a running best (strict <, e_best from +inf, m_best
// from m0). Both read the couplings only through the layout that
// ops/sweeps_cuda.py builds once from dense J (K2) or from the tiles (K3)
// (`SweepNeighbors`), and they take the same arguments; they keep their
// names so that the two routes count their launches apart.
//
// Steps. The layout cuts the row blocks into steps: maximal runs of
// consecutive blocks with no coupling between two of them, which on a
// graph-coloured layout are its colour classes (chimera 16x16: 3 steps for
// 16 blocks; a random 3-regular graph at N = 4096: 4 for 33). Within a
// step every unmasked spin draws at once from the phi it has at the start
// of the step, with the Philox counter (column, replica, sweep) of
// sweep_common.cuh or its injected uniform. No spin of a step couples to
// another block of the step, so these are the draws of the block-by-block
// kernels, and a sweep costs 2 barriers per step (plus 1 for the energy)
// instead of 3 per block.
//
// Phi update. After a step's draws (dm = new - old, int8 in shared memory),
// one thread per target j of the step runs
//     acc = phi[j]; for each source k of j in the step, ascending:
//         if (dm[k] != 0) acc = fmaf(dm[k], w_kj, acc);
//     phi[j] = acc;
// which is the FMA sequence K1 (colored_sweeps.cu) runs over the same
// sweep: blocks ascending, flipped spins ascending, acc from phi[j]; the
// terms it skips are fmaf(dm, 0, acc), an identity. So on one layout and
// one seed K2 and K3 equal K1 bit for bit on any f32 couplings (a zero's
// sign aside). Distinct threads own distinct targets, so no atomics; the
// targets go longest source list first. The work per step is the step's
// couplings, not its tiles (K3 before: K * B slots per flip) or dense rows
// (K2 before: an n_pad-float J row from HBM per flip).
//
// Width. The thread count is a template parameter (256, 512 or 1024) that
// the wrapper chooses from R and the SM count (ops/sweeps_cuda.py,
// sweep_threads): at small R most SMs would be idle with narrow CTAs, and a
// step's ~680 draws and ~1200 targets (chimera 16x16) spread over more
// threads; at large R narrow CTAs keep more replicas resident. The result
// does not depend on the width: draws are per spin, each target's sum has
// one owner, and the energy is warp 0's (nmc::end_of_sweep, as K1).
//
// Shared memory: phi (f32), m and dm (int8): 6 bytes per spin, 192 KB at
// the int16 layout's limit n_pad = 32768.
//
// Bound on the H100: operation-bound. Per attempted spin update one
// Philox-4x32-10 and one tanhf (about 110 operations); per flip one FMA per
// nonzero coupling; the layout (94 KB at chimera 16x16) stays in L1 and L2.
// At R <= 256 a sweep is latency, not work: ~5.6 us at chimera 16x16 on
// one CTA per replica, of which the gather's dependent loads are ~40% and
// warp 0's energy ~15% (chip_smoke.py --sweep-ablation; loading a target's
// sources four at a time was slower). PERF.md has the numbers.

#include "sweep_common.cuh"

namespace {

struct Sweeps {
  const int32_t* step_ptr;  // [n_steps + 1] step s: row blocks [step_ptr[s], step_ptr[s+1])
  const int32_t* tgt_ptr;   // [n_steps + 1] step s's targets
  const int16_t* tgt;       // [n_tgt] target spin j
  const int32_t* src_ptr;   // [n_tgt + 1] target t's sources
  const int16_t* src;       // [nnz] source spin k, ascending per target
  const float* w;           // [nnz] J[k, j]
  const float* h;           // [n_pad]
  const float* m0;          // [R, n_pad]
  const float* phi0;        // [R, n_pad]
  const float* beta_spin;   // [R, n_pad] or null (= 1)
  const uint8_t* mask;      // [mask_rows, n_pad] (bool storage)
  const float* beta_sweep;  // [T]
  const float* beta_row;    // [R]
  const float* uniforms;    // [T, R, n_pad] or null
  const int32_t* seed;      // [2], read when uniforms is null
  float* m_out;             // [R, n_pad]
  float* phi_out;           // [R, n_pad]
  float* m_best;            // [R, n_pad]
  float* e_best;            // [R]
  float* energies;          // [T, R]
  int R, n_pad, B, T, mask_rows, n_steps;
};

// phi[j] = K1's FMA chain over the flipped sources of j in step s, one
// thread per target; a weight is read only for a flipped source. The
// caller synchronises before and after.
__device__ __forceinline__ void gather_step(const Sweeps& a, int s,
                                            const int8_t* dm, float* phi) {
  const int t1 = __ldg(a.tgt_ptr + s + 1);
  for (int t = __ldg(a.tgt_ptr + s) + threadIdx.x; t < t1; t += blockDim.x) {
    const int j = __ldg(a.tgt + t);
    const int e1 = __ldg(a.src_ptr + t + 1);
    float acc = phi[j];
    for (int e = __ldg(a.src_ptr + t); e < e1; ++e) {
      const int d = dm[__ldg(a.src + e)];
      if (d != 0) acc = fmaf((float)d, __ldg(a.w + e), acc);
    }
    phi[j] = acc;
  }
}

template <int kWidth>
__global__ void __launch_bounds__(kWidth) colored_sweeps_nbr_kernel(Sweeps a) {
  extern __shared__ float smem[];
  const int n_pad = a.n_pad;
  float* phi = smem;                                   // [n_pad]
  int8_t* m = reinterpret_cast<int8_t*>(phi + n_pad);  // [n_pad]
  int8_t* dm = m + n_pad;                              // [n_pad]

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t base = (size_t)r * n_pad;
  nmc::ReplicaDraws draws;
  draws.beta_spin = a.beta_spin != nullptr ? a.beta_spin + base : nullptr;
  draws.mask = a.mask + (a.mask_rows == 1 ? 0 : base);
  draws.uniforms = a.uniforms;
  draws.u_offset = base;
  draws.u_sweep = (size_t)a.R * n_pad;
  draws.beta_row = a.beta_row[r];
  draws.r = (uint32_t)r;
  draws.seed0 = a.uniforms == nullptr ? (uint32_t)a.seed[0] : 0u;
  draws.seed1 = a.uniforms == nullptr ? (uint32_t)a.seed[1] : 0u;

  for (int k = tid; k < n_pad; k += kWidth) {
    const float mv = a.m0[base + k];
    m[k] = mv > 0.f ? 1 : -1;
    phi[k] = a.phi0[base + k];
    a.m_best[base + k] = mv;
  }
  float e_best = INFINITY;  // kept by warp 0, which computes the energies
  __syncthreads();

  for (int t = 0; t < a.T; ++t) {
    const float beta_t = a.beta_sweep[t];
    for (int s = 0; s < a.n_steps; ++s) {
      const int s0 = __ldg(a.step_ptr + s) * a.B;
      const int s1 = __ldg(a.step_ptr + s + 1) * a.B;
      nmc::draw_block<true>(draws, t, beta_t, s0, s1 - s0, phi, m, dm + s0);
      __syncthreads();
      gather_step(a, s, dm, phi);
      __syncthreads();
    }
    nmc::end_of_sweep(m, phi, a.h, n_pad, a.energies + (size_t)t * a.R + r,
                      a.m_best + base, e_best);
    __syncthreads();
  }

  for (int k = tid; k < n_pad; k += kWidth) {
    a.m_out[base + k] = (float)m[k];
    a.phi_out[base + k] = phi[k];
  }
  if (tid == 0) a.e_best[r] = e_best;
}

size_t shared_bytes(int n_pad) {
  return (size_t)n_pad * (sizeof(float) + 2);  // phi, m, dm
}

template <int kWidth>
int launch_width(const Sweeps& a, cudaStream_t stream) {
  const size_t smem = shared_bytes(a.n_pad);
  cudaError_t err = cudaFuncSetAttribute(
      colored_sweeps_nbr_kernel<kWidth>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (a.R == 0) return (int)cudaSuccess;
  colored_sweeps_nbr_kernel<kWidth><<<a.R, kWidth, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch(const int32_t* step_ptr, const int32_t* tgt_ptr,
           const int16_t* tgt, const int32_t* src_ptr, const int16_t* src,
           const float* w, const float* h, const float* m0,
           const float* phi0, const float* beta_spin, const uint8_t* mask,
           const float* beta_sweep, const float* beta_row,
           const float* uniforms, const int32_t* seed, float* m_out,
           float* phi_out, float* m_best, float* e_best, float* energies,
           int R, int n_pad, int block_size, int num_sweeps, int mask_rows,
           int num_steps, int threads, void* stream) {
  const Sweeps a{step_ptr, tgt_ptr, tgt, src_ptr, src, w, h, m0, phi0,
                 beta_spin, mask, beta_sweep, beta_row, uniforms, seed,
                 m_out, phi_out, m_best, e_best, energies, R, n_pad,
                 block_size, num_sweeps, mask_rows, num_steps};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (threads) {
    case 256: return launch_width<256>(a, s);
    case 512: return launch_width<512>(a, s);
    case 1024: return launch_width<1024>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int kWidth>
int occupancy(int smem_bytes, int* registers, int* ctas_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr,
                                          colored_sweeps_nbr_kernel<kWidth>);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  err = cudaFuncSetAttribute(colored_sweeps_nbr_kernel<kWidth>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, colored_sweeps_nbr_kernel<kWidth>, kWidth,
      (size_t)smem_bytes);
}

}  // namespace

extern "C" {

// K2, over the layout built from dense J. Launches on `stream`; returns the
// cudaError_t of the launch. beta_spin and uniforms may be null; mask has
// mask_rows (1 or R) rows; threads is 256, 512 or 1024.
int colored_sweeps_streamed_f32(
    const int32_t* step_ptr, const int32_t* tgt_ptr, const int16_t* tgt,
    const int32_t* src_ptr, const int16_t* src, const float* w,
    const float* h, const float* m0, const float* phi0,
    const float* beta_spin, const uint8_t* mask, const float* beta_sweep,
    const float* beta_row, const float* uniforms, const int32_t* seed,
    float* m_out, float* phi_out, float* m_best, float* e_best,
    float* energies, int R, int n_pad, int block_size, int num_sweeps,
    int mask_rows, int num_steps, int threads, void* stream) {
  return launch(step_ptr, tgt_ptr, tgt, src_ptr, src, w, h, m0, phi0,
                beta_spin, mask, beta_sweep, beta_row, uniforms, seed, m_out,
                phi_out, m_best, e_best, energies, R, n_pad, block_size,
                num_sweeps, mask_rows, num_steps, threads, stream);
}

// K3, over the layout built from the block-sparse tiles.
int colored_sweeps_sparse_f32(
    const int32_t* step_ptr, const int32_t* tgt_ptr, const int16_t* tgt,
    const int32_t* src_ptr, const int16_t* src, const float* w,
    const float* h, const float* m0, const float* phi0,
    const float* beta_spin, const uint8_t* mask, const float* beta_sweep,
    const float* beta_row, const float* uniforms, const int32_t* seed,
    float* m_out, float* phi_out, float* m_best, float* e_best,
    float* energies, int R, int n_pad, int block_size, int num_sweeps,
    int mask_rows, int num_steps, int threads, void* stream) {
  return launch(step_ptr, tgt_ptr, tgt, src_ptr, src, w, h, m0, phi0,
                beta_spin, mask, beta_sweep, beta_row, uniforms, seed, m_out,
                phi_out, m_best, e_best, energies, R, n_pad, block_size,
                num_sweeps, mask_rows, num_steps, threads, stream);
}

// The kernel's registers per thread at `threads` per CTA and the CTAs of it
// that fit on one SM with `smem_bytes` of dynamic shared memory (the CUDA
// runtime's figures).
int colored_sweeps_nbr_occupancy(int threads, int smem_bytes, int* registers,
                                 int* ctas_per_sm) {
  switch (threads) {
    case 256: return occupancy<256>(smem_bytes, registers, ctas_per_sm);
    case 512: return occupancy<512>(smem_bytes, registers, ctas_per_sm);
    case 1024: return occupancy<1024>(smem_bytes, registers, ctas_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
