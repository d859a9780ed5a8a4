// Colored heat-bath Gibbs sweeps over a neighbour layout, one step per
// colour class, with the state of P replicas per CTA on chip.
//
// Three entry points, one kernel body:
//   colored_sweeps_f32           replaces nmc_tpu/ops/sweeps_pallas.py::
//                                pallas_colored_sweeps (K1, dense J resident
//                                in VMEM on the TPU, r_tile replicas per
//                                program; the engine's route up to n_pad
//                                1536);
//   colored_sweeps_streamed_f32  replaces ::pallas_colored_sweeps_streamed
//                                (K2, dense J row blocks double-buffered from
//                                HBM on the TPU; the route above n_pad 1536
//                                when most column tiles hold a coupling);
//   colored_sweeps_sparse_f32    replaces ::pallas_colored_sweeps_sparse (K3,
//                                each row block's nonzero column tiles; the
//                                route when they are few).
// All compute what the Pallas kernels compute: T colored block-Jacobi
// heat-bath sweeps with beta = (beta_t * beta_row[r]) * beta_spin (beta_spin
// optional), a [1 | R, n_pad] update mask, per-sweep energies
// E = -1/2 m.(phi + h) and a running best (strict <, e_best from +inf, m_best
// from m0). K1's beta = beta_t * beta_spin is this with beta_row = 1, as
// beta_t * 1 == beta_t. They read the couplings only through the layout
// that ops/sweeps_cuda.py builds once from dense J (K1, K2) or from the
// tiles (K3) (`SweepNeighbors`), and they take the same arguments (K1 also
// the replicas per CTA); they keep their names so that the three routes
// count their launches apart. Each may also record the state after every
// sweep (M [T, R, n_pad], when its pointer is non-null).
//
// Steps. The layout cuts the row blocks into steps: maximal runs of
// consecutive blocks with no coupling between two of them, which on a
// graph-coloured layout are its colour classes (chimera 8x8: 3 steps for 5
// blocks; 16x16: 3 for 16; a random 3-regular graph at N = 4096: 4 for
// 33). Within a step every unmasked spin draws at once from the phi it has
// at the start of the step, with the Philox counter (column, replica,
// sweep) of sweep_common.cuh or its injected uniform. No spin of a step
// couples to another block of the step, so these are the draws of the
// block-by-block sweep, and a sweep costs 2 barriers per step (plus 1 for
// the energy) instead of 3 per block.
//
// Replicas per CTA. A CTA holds P replicas (1, 2, 4 or 8, a template
// parameter): replicas r0 = blockIdx.x * P .. r0 + P - 1, ceil(R / P) CTAs,
// the last CTA's missing replicas idle. A step's draws run over its spins
// of all P replicas at once, width / P threads (whole warps) per replica;
// in the phi update a thread owns a target j for all P replicas, loads each
// (source, weight) entry once and runs one FMA per replica whose source
// flipped; warp p sums replica p's energy. So P replicas share each
// coupling load, each loop and each barrier. K1 takes P from its wrapper
// (k1_launch); K2 and K3 run P = 1.
//
// Phi update. After a step's draws (dm = new - old, int8 in shared memory),
// per replica and target j of the step:
//     acc = phi[j]; for each source k of j in the step, ascending:
//         if (dm[k] != 0) acc = fmaf(dm[k], w_kj, acc);
//     phi[j] = acc;
// which is the FMA chain of the block-by-block dense-row sweep (blocks
// ascending, flipped spins ascending, acc from phi[j]); the terms it skips
// are fmaf(dm, 0, acc), identities. So on one layout and one seed K1, K2
// and K3 agree bit for bit on any f32 couplings (a zero's sign aside), and
// with the dense-row sweep of the Pallas kernels. Distinct threads own
// distinct targets, so no atomics; the targets go longest source list
// first. The work per step is the step's couplings, not its dense rows
// (an n_pad-float J row per flip) or tiles.
//
// Width. The thread count is a template parameter (128, 256, 512 or 1024,
// at least 32 P) that the wrapper chooses from R and the SM count (K1:
// with P, from R, n_pad and the SM count; ops/sweeps_cuda.py:
// sweep_threads, k1_launch). The result depends on neither the width nor P: draws are keyed per (spin,
// replica, sweep), each target's sum has one owner, and warp p sums
// replica p's energy in the order warp 0 sums it at P = 1.
//
// Shared memory: phi (f32), m and dm (int8) per replica: 6 P bytes per
// spin; 72 KB at K1's limit n_pad = 1536 with P = 8, 192 KB at P = 1 and
// the int16 layout's limit n_pad = 32768.
//
// Bound on the H100: operation-bound. Per attempted spin update one
// Philox-4x32-10 and one tanhf (about 110 operations); per flip one FMA per
// nonzero coupling; the layout (94 KB at chimera 16x16, 23 KB at 8x8)
// stays in L1 and L2. At small R a sweep is latency, not work: the
// gather's dependent loads and the energy are most of it. K1 at R = 2048
// (P = 8) spends about a third in the gather, a quarter in Philox and a
// third in the rest of the draw and the barriers (chip_smoke.py
// --sweep-ablation; PERF.md has the numbers).

#include <type_traits>

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
  float* M;                 // [T, R, n_pad] states after each sweep, or null
  int R, n_pad, B, T, mask_rows, n_steps;
  int replica_offset;       // added to the replica word of the Philox counter
};

// What one thread's draws read from device memory. The CTA's width / P
// threads of group g (whole warps) draw for replica r = r0 + g, so a
// thread's replica and rows are fixed for the launch.
struct Drawer {
  const uint8_t* mask;      // the replica's mask row (or the one shared row)
  const float* beta_spin;   // the replica's row, or null (= 1)
  const float* uniforms;    // the replica's row of sweep 0, or null
  size_t u_sweep;           // R * n_pad
  float beta_row;           // beta_row[r]
  uint32_t r, seed0, seed1;
};

// The thread's draws of the n spins from column s0 for its replica (phi, m,
// dm: the replica's shared-memory rows), columns c0, c0 + stride, ... of
// the step: every unmasked spin takes +1 with p_up = (1 + tanh(beta *
// phi)) / 2 at once, beta = (beta_t * beta_row[r]) * beta_spin[r, col] in
// that order as the Pallas kernels multiply (the last factor skipped when
// beta_spin is null), from the Philox counter (col, replica_offset + r, t)
// (the offset places a launch on a slice of a larger ladder) or the injected
// uniform; dm gets new - old (0 for a masked spin).
__device__ __forceinline__ void draw_step(const Drawer& d, int c0, int stride,
                                          int t, float beta_t, int s0, int n,
                                          const float* phi, int8_t* m,
                                          int8_t* dm) {
  for (int c = c0; c < n; c += stride) {
    const int col = s0 + c;
    int8_t delta = 0;
    if (d.mask[col]) {
      float u;
      if (d.uniforms != nullptr) {
        u = d.uniforms[(size_t)t * d.u_sweep + col];
      } else {
        const uint32_t bits = nmc::philox4x32_10_word0(
            (uint32_t)col, d.r, (uint32_t)t, 0u, d.seed0, d.seed1);
        u = (float)(bits >> 8) * 5.9604644775390625e-08f;  // 2^-24
      }
      float betab = beta_t * d.beta_row;
      if (d.beta_spin != nullptr) betab = betab * d.beta_spin[col];
      const float p_up = 0.5f * (1.0f + tanhf(betab * phi[col]));
      const int8_t nw = u < p_up ? 1 : -1;
      delta = (int8_t)(nw - m[col]);
      m[col] = nw;
    }
    dm[col] = delta;
  }
}

// phi[p, j] = the FMA chain over the flipped sources of j in step s, for
// each of the P replicas, one thread per target. At P > 1 each (source,
// weight) entry is loaded once for the P replicas; at P = 1 a weight is
// read only for a flipped source, which was faster there (PERF.md). The
// caller synchronises before and after.
template <int kP>
__device__ __forceinline__ void gather_step(const Sweeps& a, int s,
                                            const int8_t* dm, float* phi) {
  const int n_pad = a.n_pad;
  const int t1 = __ldg(a.tgt_ptr + s + 1);
  for (int t = __ldg(a.tgt_ptr + s) + threadIdx.x; t < t1; t += blockDim.x) {
    const int j = __ldg(a.tgt + t);
    const int e1 = __ldg(a.src_ptr + t + 1);
    float acc[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) acc[p] = phi[p * n_pad + j];
    for (int e = __ldg(a.src_ptr + t); e < e1; ++e) {
      const int k = __ldg(a.src + e);
      const float w = kP > 1 ? __ldg(a.w + e) : 0.f;
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int d = dm[p * n_pad + k];
        if (d != 0)
          acc[p] = fmaf((float)d, kP > 1 ? w : __ldg(a.w + e), acc[p]);
      }
    }
#pragma unroll
    for (int p = 0; p < kP; ++p) phi[p * n_pad + j] = acc[p];
  }
}

// One warp, replica r (its shared-memory rows m, phi): E = -1/2 m.(phi + h)
// into energies[t, r] and the running best (strict <). Lane l adds
// m_j (phi_j + h_j) over j = l, l + 32, ... from 0, then an xor butterfly
// leaves the same sum in every lane, so the best-state branch is
// warp-uniform. The caller synchronises after.
__device__ __forceinline__ void end_of_sweep(const Sweeps& a, int r, int t,
                                             const int8_t* m,
                                             const float* phi,
                                             float& e_best) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int j = lane; j < a.n_pad; j += 32)
    acc += (float)m[j] * (phi[j] + a.h[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  const float e = -0.5f * acc;
  if (lane == 0) a.energies[(size_t)t * a.R + r] = e;
  if (e < e_best) {
    float* best = a.m_best + (size_t)r * a.n_pad;
    for (int j = lane; j < a.n_pad; j += 32) best[j] = (float)m[j];
    e_best = e;
  }
}

// kRecord: write M after each sweep. A template flag, so that a launch
// that does not record runs the code it ran before the flag existed.
template <int kWidth, int kP, bool kRecord>
__global__ void __launch_bounds__(kWidth) colored_sweeps_nbr_kernel(Sweeps a) {
  static_assert(kWidth >= 32 * kP, "warp p sums replica p's energy");
  constexpr int kGroup = kWidth / kP;  // threads drawing for one replica
  extern __shared__ float smem[];
  const int n_pad = a.n_pad;
  float* phi = smem;                                        // [kP, n_pad]
  int8_t* m = reinterpret_cast<int8_t*>(phi + kP * n_pad);  // [kP, n_pad]
  int8_t* dm = m + kP * n_pad;                              // [kP, n_pad]

  const int r0 = blockIdx.x * kP;
  const int live = min(kP, a.R - r0);  // replicas of this CTA that exist
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  // the CTA's replicas are the consecutive rows r0 .. r0 + live - 1
  const size_t base = (size_t)r0 * n_pad;

  const int g = kP == 1 ? 0 : tid / kGroup;  // the replica it draws for
  const int c0 = tid - g * kGroup;
  const size_t row = (size_t)(r0 + g) * n_pad;
  Drawer d;
  d.mask = a.mask + (a.mask_rows == 1 ? 0 : row);
  d.beta_spin = a.beta_spin != nullptr ? a.beta_spin + row : nullptr;
  d.uniforms = a.uniforms != nullptr ? a.uniforms + row : nullptr;
  d.u_sweep = (size_t)a.R * n_pad;
  d.beta_row = g < live ? a.beta_row[r0 + g] : 1.f;
  d.r = (uint32_t)(r0 + g + a.replica_offset);
  d.seed0 = a.uniforms == nullptr ? (uint32_t)a.seed[0] : 0u;
  d.seed1 = a.uniforms == nullptr ? (uint32_t)a.seed[1] : 0u;

  for (int i = tid; i < kP * n_pad; i += kWidth) {
    if (i < live * n_pad) {
      const float mv = a.m0[base + i];
      m[i] = mv > 0.f ? 1 : -1;
      phi[i] = a.phi0[base + i];
      a.m_best[base + i] = mv;
    } else {  // a missing replica: never drawn, so its dm stays 0
      m[i] = 1;
      phi[i] = 0.f;
    }
    dm[i] = 0;
  }
  float e_best = INFINITY;  // warp p keeps replica p's
  __syncthreads();

  for (int t = 0; t < a.T; ++t) {
    const float beta_t = a.beta_sweep[t];
    for (int s = 0; s < a.n_steps; ++s) {
      const int s0 = __ldg(a.step_ptr + s) * a.B;
      const int s1 = __ldg(a.step_ptr + s + 1) * a.B;
      if (g < live)
        draw_step(d, c0, kGroup, t, beta_t, s0, s1 - s0, phi + g * n_pad,
                  m + g * n_pad, dm + g * n_pad);
      __syncthreads();
      gather_step<kP>(a, s, dm, phi);
      __syncthreads();
    }
    if constexpr (kRecord) {
      float* Mt = a.M + (size_t)t * a.R * n_pad + base;
      for (int i = tid; i < live * n_pad; i += kWidth) Mt[i] = (float)m[i];
    }
    if (warp < live)
      end_of_sweep(a, r0 + warp, t, m + warp * n_pad, phi + warp * n_pad,
                   e_best);
    __syncthreads();
  }

  for (int i = tid; i < live * n_pad; i += kWidth) {
    a.m_out[base + i] = (float)m[i];
    a.phi_out[base + i] = phi[i];
  }
  if ((tid & 31) == 0 && warp < live) a.e_best[r0 + warp] = e_best;
}

size_t shared_bytes(int n_pad, int P) {
  return (size_t)P * n_pad * (sizeof(float) + 2);  // phi, m, dm
}

// f(width, P) for a built shape, as std::integral_constants; a width below
// 32 P, or a width or P not built, gives cudaErrorInvalidValue.
template <int kWidth, int kP, typename F>
int shape(F f) {
  if constexpr (kWidth >= 32 * kP)
    return f(std::integral_constant<int, kWidth>(),
             std::integral_constant<int, kP>());
  else
    return (int)cudaErrorInvalidValue;
}

template <int kP, typename F>
int with_width(int threads, F f) {
  switch (threads) {
    case 128: return shape<128, kP>(f);
    case 256: return shape<256, kP>(f);
    case 512: return shape<512, kP>(f);
    case 1024: return shape<1024, kP>(f);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename F>
int with_shape(int threads, int P, F f) {
  switch (P) {
    case 1: return with_width<1>(threads, f);
    case 2: return with_width<2>(threads, f);
    case 4: return with_width<4>(threads, f);
    case 8: return with_width<8>(threads, f);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kRecord>
int launch_shape(const int32_t* step_ptr, const int32_t* tgt_ptr,
           const int16_t* tgt, const int32_t* src_ptr, const int16_t* src,
           const float* w, const float* h, const float* m0,
           const float* phi0, const float* beta_spin, const uint8_t* mask,
           const float* beta_sweep, const float* beta_row,
           const float* uniforms, const int32_t* seed, float* m_out,
           float* phi_out, float* m_best, float* e_best, float* energies,
           float* M, int R, int n_pad, int block_size, int num_sweeps,
           int mask_rows, int num_steps, int threads, int P,
           int replica_offset, void* stream) {
  const Sweeps a{step_ptr, tgt_ptr, tgt, src_ptr, src, w, h, m0, phi0,
                 beta_spin, mask, beta_sweep, beta_row, uniforms, seed,
                 m_out, phi_out, m_best, e_best, energies, M, R, n_pad,
                 block_size, num_sweeps, mask_rows, num_steps,
                 replica_offset};
  return with_shape(threads, P, [&](auto width, auto p) {
    constexpr int kWidth = decltype(width)::value, kP = decltype(p)::value;
    const size_t smem = shared_bytes(a.n_pad, kP);
    cudaError_t err = cudaFuncSetAttribute(
        colored_sweeps_nbr_kernel<kWidth, kP, kRecord>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (a.R == 0) return (int)cudaSuccess;
    colored_sweeps_nbr_kernel<kWidth, kP, kRecord>
        <<<(a.R + kP - 1) / kP, kWidth, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  });
}

// The recording instantiation when M is non-null, else the plain one.
int launch(const int32_t* step_ptr, const int32_t* tgt_ptr,
           const int16_t* tgt, const int32_t* src_ptr, const int16_t* src,
           const float* w, const float* h, const float* m0,
           const float* phi0, const float* beta_spin, const uint8_t* mask,
           const float* beta_sweep, const float* beta_row,
           const float* uniforms, const int32_t* seed, float* m_out,
           float* phi_out, float* m_best, float* e_best, float* energies,
           float* M, int R, int n_pad, int block_size, int num_sweeps,
           int mask_rows, int num_steps, int threads, int P,
           int replica_offset, void* stream) {
  auto f = M != nullptr ? launch_shape<true> : launch_shape<false>;
  return f(step_ptr, tgt_ptr, tgt, src_ptr, src, w, h, m0, phi0, beta_spin,
           mask, beta_sweep, beta_row, uniforms, seed, m_out, phi_out,
           m_best, e_best, energies, M, R, n_pad, block_size, num_sweeps,
           mask_rows, num_steps, threads, P, replica_offset, stream);
}

}  // namespace

extern "C" {

// K1, over the layout built from dense J, with `replicas_per_cta` (1, 2, 4
// or 8) replicas per CTA and `threads` (128, 256, 512 or 1024, at least 32
// per replica) per CTA. Launches on `stream`; returns the cudaError_t of
// the launch. beta_spin, uniforms and M may be null; mask has mask_rows (1
// or R) rows.
int colored_sweeps_f32(
    const int32_t* step_ptr, const int32_t* tgt_ptr, const int16_t* tgt,
    const int32_t* src_ptr, const int16_t* src, const float* w,
    const float* h, const float* m0, const float* phi0,
    const float* beta_spin, const uint8_t* mask, const float* beta_sweep,
    const float* beta_row, const float* uniforms, const int32_t* seed,
    float* m_out, float* phi_out, float* m_best, float* e_best,
    float* energies, float* M, int R, int n_pad, int block_size,
    int num_sweeps,
    int mask_rows, int num_steps, int threads, int replicas_per_cta,
    int replica_offset, void* stream) {
  return launch(step_ptr, tgt_ptr, tgt, src_ptr, src, w, h, m0, phi0,
                beta_spin, mask, beta_sweep, beta_row, uniforms, seed, m_out,
                phi_out, m_best, e_best, energies, M, R, n_pad, block_size,
                num_sweeps, mask_rows, num_steps, threads, replicas_per_cta,
                replica_offset, stream);
}

// K2, over the layout built from dense J, one replica per CTA; threads is
// 256, 512 or 1024.
int colored_sweeps_streamed_f32(
    const int32_t* step_ptr, const int32_t* tgt_ptr, const int16_t* tgt,
    const int32_t* src_ptr, const int16_t* src, const float* w,
    const float* h, const float* m0, const float* phi0,
    const float* beta_spin, const uint8_t* mask, const float* beta_sweep,
    const float* beta_row, const float* uniforms, const int32_t* seed,
    float* m_out, float* phi_out, float* m_best, float* e_best,
    float* energies, float* M, int R, int n_pad, int block_size,
    int num_sweeps,
    int mask_rows, int num_steps, int threads, int replica_offset,
    void* stream) {
  return launch(step_ptr, tgt_ptr, tgt, src_ptr, src, w, h, m0, phi0,
                beta_spin, mask, beta_sweep, beta_row, uniforms, seed, m_out,
                phi_out, m_best, e_best, energies, M, R, n_pad, block_size,
                num_sweeps, mask_rows, num_steps, threads, 1, replica_offset,
                stream);
}

// K3, over the layout built from the block-sparse tiles, one replica per
// CTA.
int colored_sweeps_sparse_f32(
    const int32_t* step_ptr, const int32_t* tgt_ptr, const int16_t* tgt,
    const int32_t* src_ptr, const int16_t* src, const float* w,
    const float* h, const float* m0, const float* phi0,
    const float* beta_spin, const uint8_t* mask, const float* beta_sweep,
    const float* beta_row, const float* uniforms, const int32_t* seed,
    float* m_out, float* phi_out, float* m_best, float* e_best,
    float* energies, float* M, int R, int n_pad, int block_size,
    int num_sweeps,
    int mask_rows, int num_steps, int threads, int replica_offset,
    void* stream) {
  return launch(step_ptr, tgt_ptr, tgt, src_ptr, src, w, h, m0, phi0,
                beta_spin, mask, beta_sweep, beta_row, uniforms, seed, m_out,
                phi_out, m_best, e_best, energies, M, R, n_pad, block_size,
                num_sweeps, mask_rows, num_steps, threads, 1, replica_offset,
                stream);
}

// The kernel's registers per thread at `threads` per CTA and
// `replicas_per_cta`, and the CTAs of it that fit on one SM with
// `smem_bytes` of dynamic shared memory (the CUDA runtime's figures).
int colored_sweeps_nbr_occupancy(int threads, int replicas_per_cta,
                                 int smem_bytes, int* registers,
                                 int* ctas_per_sm) {
  return with_shape(threads, replicas_per_cta, [&](auto width, auto p) {
    constexpr int kWidth = decltype(width)::value, kP = decltype(p)::value;
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(
        &attr, colored_sweeps_nbr_kernel<kWidth, kP, false>);
    if (err != cudaSuccess) return (int)err;
    *registers = attr.numRegs;
    err = cudaFuncSetAttribute(
        colored_sweeps_nbr_kernel<kWidth, kP, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, colored_sweeps_nbr_kernel<kWidth, kP, false>,
        kWidth,
        (size_t)smem_bytes);
  });
}

}  // extern "C"
