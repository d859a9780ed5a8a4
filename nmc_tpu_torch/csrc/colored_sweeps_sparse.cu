// Block-sparse colored heat-bath Gibbs sweeps with the replica state on chip.
//
// Replaces nmc_tpu/ops/sweeps_pallas.py::pallas_colored_sweeps_sparse (K3,
// the Pallas kernel `_sparse_streamed_kernel`). It computes the same
// function as colored_sweeps.cu's K2 (T colored block-Jacobi heat-bath
// sweeps, beta = (beta_t * beta_row[r]) * beta_spin with beta_spin
// optional, a [1 | R, n_pad] update mask, per-sweep energies and a running
// best), but J comes as the block-sparse view of block_sparse_tiles: for
// each row block b, the K column tiles col_idx[b, :] that hold a nonzero
// coupling, as J_tiles[b, k] = J[bB:(b+1)B, col_idx[b,k]B:(col_idx[b,k]+1)B].
// Rows with fewer than K nonzero tiles are padded with zero tiles at
// column block 0. phi picks up dm @ J_tiles[b, k] on column block
// col_idx[b, k] only.
//
// Design: as K1/K2, one CTA owns one replica for all T sweeps (grid = R),
// with phi (f32) and m (int8) in shared memory (10 KB at n_pad = 2048,
// 28 KB at 5504), the heat-bath draw and the ballot flip list of
// sweep_common.cuh. The phi update runs in two passes so that a padding
// tile, which aliases column block 0, never races a real tile of the same
// block: (1) every (tile, column) slot of the K*B the block touches sums
// dm[i] * J_tiles[b, k, i, col] over the flipped spins i into a shared
// buffer [K*B]; (2) thread jj adds the K partial sums of its column jj to
// phi[col_idx[b, k] * B + jj] in tile order, as the Pallas kernel's loop
// over k does. Distinct threads own distinct columns, so the adds need no
// atomics and the result does not depend on the schedule. A block without
// flips skips both passes.
//
// Bound: per attempt one Philox-4x32-10 and one tanhf; per flip the K*B
// floats of the block's tile rows (640 at chimera 16x16, K = 5) from L2
// instead of a dense row's n_pad (2048). J_tiles is 5.2 MB at chimera
// 16x16 and stays in the 50 MB L2; a chimera row still holds at most 6 of
// those 640 couplings, so L2 bytes per flip remain the likely bound.
//
// Random numbers: see sweep_common.cuh; the counter is the same as K1's and
// K2's, so on one layout and one seed the three kernels agree draw for draw.

#include "sweep_common.cuh"

namespace {

using nmc::kThreads;

__global__ void __launch_bounds__(kThreads) colored_sweeps_sparse_kernel(
    const int32_t* __restrict__ col_idx,  // [nB, K]
    const float* __restrict__ J_tiles,    // [nB, K, B, B]
    const float* __restrict__ h,          // [n_pad]
    const float* __restrict__ m0,         // [R, n_pad]
    const float* __restrict__ phi0,       // [R, n_pad]
    const float* __restrict__ beta_spin,  // [R, n_pad] or null (= 1)
    const uint8_t* __restrict__ mask,     // [mask_rows, n_pad] (bool storage)
    const float* __restrict__ beta_sweep, // [T]
    const float* __restrict__ beta_row,   // [R]
    const float* __restrict__ uniforms,   // [T, R, n_pad] or null
    const int32_t* __restrict__ seed,     // [2], read when uniforms is null
    float* __restrict__ m_out,            // [R, n_pad]
    float* __restrict__ phi_out,          // [R, n_pad]
    float* __restrict__ m_best,           // [R, n_pad]
    float* __restrict__ e_best_out,       // [R]
    float* __restrict__ energies,         // [T, R]
    int R, int n_pad, int B, int K, int T, int mask_rows) {
  extern __shared__ float smem[];
  float* phi = smem;                                  // [n_pad]
  float* part = phi + n_pad;                          // [K * B]
  float* dm = part + (size_t)K * B;                   // [B]
  int* flips = reinterpret_cast<int*>(dm + B);        // [B]
  int* cols = flips + B;                              // [K]
  int8_t* m = reinterpret_cast<int8_t*>(cols + K);    // [n_pad]
  __shared__ int num_flips;

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t base = (size_t)r * n_pad;
  nmc::ReplicaDraws draws;
  draws.beta_spin = beta_spin != nullptr ? beta_spin + base : nullptr;
  draws.mask = mask + (mask_rows == 1 ? 0 : base);
  draws.uniforms = uniforms;
  draws.u_offset = base;
  draws.u_sweep = (size_t)R * n_pad;
  draws.beta_row = beta_row[r];
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
  const int slots = K * B;
  for (int t = 0; t < T; ++t) {
    const float beta_t = beta_sweep[t];
    for (int b = 0; b < num_blocks; ++b) {
      const int s = b * B;
      nmc::draw_block<true>(draws, t, beta_t, s, B, phi, m, dm);
      for (int k = tid; k < K; k += blockDim.x)
        cols[k] = col_idx[(size_t)b * K + k] * B;
      __syncthreads();
      nmc::list_flips(dm, flips, &num_flips, B);
      __syncthreads();
      const int nf = num_flips;
      if (nf > 0) {  // uniform: every thread read the same count
        // (1) part[k*B + jj] = sum_f dm[i_f] * J_tiles[b, k, i_f, jj]
        const float* tiles = J_tiles + (size_t)b * slots * B;
        for (int slot = tid; slot < slots; slot += blockDim.x) {
          const int k = slot / B;
          const int jj = slot - k * B;
          const float* col = tiles + (size_t)k * B * B + jj;
          float acc = 0.f;
#pragma unroll 4
          for (int f = 0; f < nf; ++f) {
            const int i = flips[f];
            acc = fmaf(dm[i], __ldg(col + (size_t)i * B), acc);
          }
          part[slot] = acc;
        }
        __syncthreads();
        // (2) scatter into phi in tile order, one column per thread
        for (int jj = tid; jj < B; jj += blockDim.x)
          for (int k = 0; k < K; ++k) phi[cols[k] + jj] += part[k * B + jj];
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

// K3. Launches the kernel on `stream`; returns the cudaError_t of the launch.
// beta_spin may be null; mask has mask_rows (1 or R) rows.
int colored_sweeps_sparse_f32(const int32_t* col_idx, const float* J_tiles,
                              const float* h, const float* m0,
                              const float* phi0, const float* beta_spin,
                              const uint8_t* mask, const float* beta_sweep,
                              const float* beta_row, const float* uniforms,
                              const int32_t* seed, float* m_out,
                              float* phi_out, float* m_best, float* e_best,
                              float* energies, int R, int n_pad,
                              int block_size, int num_tiles, int num_sweeps,
                              int mask_rows, void* stream) {
  const size_t smem =
      (size_t)n_pad * sizeof(float)                                // phi
      + (size_t)num_tiles * block_size * sizeof(float)             // part
      + (size_t)block_size * (sizeof(float) + sizeof(int))         // dm, flips
      + (size_t)num_tiles * sizeof(int)                            // cols
      + (size_t)n_pad;                                             // m (int8)
  cudaError_t err = cudaFuncSetAttribute(
      colored_sweeps_sparse_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (R == 0) return (int)cudaSuccess;
  colored_sweeps_sparse_kernel<<<R, kThreads, smem, (cudaStream_t)stream>>>(
      col_idx, J_tiles, h, m0, phi0, beta_spin, mask, beta_sweep, beta_row,
      uniforms, seed, m_out, phi_out, m_best, e_best, energies, R, n_pad,
      block_size, num_tiles, num_sweeps, mask_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
