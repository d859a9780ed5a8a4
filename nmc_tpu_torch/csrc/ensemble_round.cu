// One whole ensemble NMC / PT swap round per launch, for every instance.
//
// Two entry points, one kernel body:
//   ensemble_round_f32         replaces nmc_tpu/ops/round_pallas.py::
//                              pallas_ensemble_round (K4, `_round_kernel`:
//                              dense J [I, n_pad, n_pad], VMEM-resident on
//                              the TPU; the engine's route up to n_pad 1536);
//   ensemble_round_sparse_f32  replaces ::pallas_ensemble_round_streamed
//                              (K5, `_streamed_round_kernel`: the family's
//                              union block-sparse tiles; above 1536).
// Both read the couplings only through the neighbour layout that
// ops/round_cuda.py builds from the dense J (K4) or the union tiles (K5)
// (`RoundNeighbors`, `Steps` below): the row blocks cut into steps, maximal
// runs of consecutive blocks with no coupling between two of them (the
// rule of the sweep kernels, ops/sweeps_cuda.py: sweep_steps; on a colored
// layout its colour classes: chimera 16x16 3 steps for 16 blocks); per step
// the targets j with a coupling from it and, for each, its sources k in
// the step in ascending k, so block after block, with per-instance weights
// [I, nnz] (exactly 0 where an instance lacks a union edge). The two entry
// points take the same arguments and launch the same body; they keep
// their names so that the two routes count their launches apart. On one
// layout and one seed they give the same result bit for bit.
//
// What a round computes, per (instance, replica slot): the static phase
// list of `_phase_list` (per cycle C, NC and, every full_update_frequency
// cycles, ALL). Per phase: the update mask and the heated beta are rebuilt
// from `act`, the backbone `cl` and the slot's NMC flag `dn` (C: dn ? cl &
// act : act, with beta_row * heat on dn & cl; NC: dn ? ~cl & act : act;
// ALL: act; heat = 1 + f32(temp_x_inv - 1) as the Pallas kernel computes
// it); phi = J m + h is rebuilt from scratch; sweeps_per_phase colored
// block-Jacobi heat-bath sweeps run with a strict-< phase best that starts
// at +inf and m; at the phase end NMC slots jump to their phase best and
// the round best takes it where strictly lower. After the last phase phi
// is rebuilt once more and e_carried = -1/2 m.(phi + h) is written.
//
// Design: one CTA per (replica slot, instance) for the whole round, I * R
// CTAs. A CTA claims its slot at its start: the SMs are split evenly among
// the instances by SM id, and a CTA takes the next free slot of its SM's
// instance (or, when those are taken, of the next instance with one free)
// from a per-instance counter, so that the CTAs on one SM mostly share an
// instance and its weights in L1. Each (slot, instance) is still computed
// once, with its own Philox counters, so which CTA computes it changes
// nothing. phi (f32), m, the phase-best m and the per-spin phase flags
// (int8 each) stay in shared memory, and dm (f32, so the gather's FMA
// takes it as it is) over the widest step: 7 bytes per spin plus 4 per
// spin of the widest step, 17 KB at chimera 16x16.
//
// Steps. A sweep walks the steps in order. Each step is one draw pass, a
// barrier, one gather and a barrier: every free spin of the step draws at
// once (all threads, strided over the step's columns) from the phi it has
// at the start of the step, and writes dm = new - old; then one thread
// owns each target j of the step and walks its sources in ascending k:
// acc starts at 0 and takes acc = fmaf(dm_k, w_kj, acc) over the sources
// of one row block, and where the block changes, and at the end,
// phi[j] += acc and acc restarts at 0. No spin of a step couples to
// another block of the step, so the draws are those of the block-by-block
// walk; and a target's sums are those of that walk's gathers (acc from 0
// over one block's sources, then phi[j] += acc), added to phi[j] in the
// same block order. So the float operations on each phi[j] are the block
// walk's, and the kernel computes bit for bit what that walk and the plain
// versions compute (`neighbor_phi_fns`, perfbench's reference), on any f32
// couplings. (K1-K3 start acc at phi[j]; that association would round
// differently.) The phi rebuild walks the steps the same way with m in
// place of dm, from phi = h. A sweep costs 2 barriers a step (plus 1 for
// the energy) instead of 2 a 128-spin block: 6 instead of 32 at chimera
// 16x16, and a step's draws keep every thread busy where a block's left
// half of 256 idle.
//
// Width. The CTA width is a template parameter that the wrapper takes from
// the launch's slot count (ops/round_cuda.py: round_threads): 256 threads
// with __launch_bounds__(256, 5), five CTAs on an SM, where the slots fill
// the SMs (640 CTAs at I = 20, R = 32 run in one wave on 132 SMs); 1024
// with __launch_bounds__(1024, 1) where every slot has an SM of its own
// (ShardedNPT's 16 slots a card), so a step's 1,000-2,800 spins and their
// targets spread over 32 warps. The width changes no result: draws and
// gathers are per spin and per target, and warp 0 sums the energy in the
// same order at any width. Flips are counted with a ballot per warp (for
// the flips-per-attempt figure).
//
// Bound on the H100. The operation bound is one Philox-4x32-10 and one
// tanhf an attempted spin update (about 110 operations), and one FMA per
// nonzero coupling in the phi update and rebuild (6 per chimera spin); the
// layout (about 1 MB for 20 chimera 16x16 instances) stays in L2. The
// kernel runs at about a tenth of it at 640 slots, and under a hundredth
// at 16 slots, which fill 16 of 132 SMs. On an H100 at 700 W the gather (a
// target's dependent loads of its layout entries and weights) is about
// half of a round at chimera 16x16 (20 x 32 slots) and 26x26 (16 slots),
// Philox a seventh, and warp 0's energy (n_pad / 32 dependent adds a lane
// while the other warps wait at the barrier) a tenth at 16x16 and a
// quarter at 26x26 on the wide CTA, where no other CTA fills the SM.
//
// Random numbers: Philox-4x32-10 with key = seed and counter = (column,
// replica + replica_offset, phase * sweeps_per_phase + sweep, instance +
// instance_offset); the uniform is (bits >> 8) * 2^-24. The offsets place a
// launch on a slice of a larger ensemble, so that a slice draws what the
// whole launch draws for those rows. Injected uniforms [P, T, I, R, n_pad]
// replace it.

#include "sweep_common.cuh"

namespace {

// The CTA widths (ops/round_cuda.py: ROUND_WIDTHS) and the CTAs on an SM
// that each one's launch bounds ask for.
constexpr int kNarrow = 256, kNarrowCtasPerSm = 5;
constexpr int kWide = 1024;
constexpr uint8_t kFree = 1;    // the spin is updated in this phase
constexpr uint8_t kHeated = 2;  // its beta is beta_row * heat

// The layout (ops/round_cuda.py, RoundNeighbors). The weights w[e] of an
// instance follow the source entries.
struct Steps {
  const int32_t* step_ptr;  // [n_steps + 1] step s: row blocks [step_ptr[s], step_ptr[s+1])
  const int32_t* tgt_ptr;   // [n_steps + 1] step s's targets: [tgt_ptr[s], tgt_ptr[s+1])
  const int16_t* tgt;       // [n_tgt] target spin j
  const int32_t* src_ptr;   // [n_tgt + 1] target t's sources: [src_ptr[t], src_ptr[t+1])
  const int16_t* src;       // [nnz] source spin k, ascending per target
};

struct Round {
  Steps nb;
  const float* w;          // [I, nnz]
  const float* h;          // [I, n_pad]
  const uint8_t* act;      // [n_pad]
  const float* m0;         // [I, R, n_pad]
  const uint8_t* cl;       // [I, R, n_pad]
  const uint8_t* do_nmc;   // [I, R]
  const float* beta_row;   // [I, R]
  const float* uniforms;   // [P, T, I, R, n_pad] or null
  const int32_t* seed;     // [2], read when uniforms is null
  float* m_out;            // [I, R, n_pad]
  float* m_best;           // [I, R, n_pad]
  float* e_best;           // [I, R]
  float* e_carried;        // [I, R]
  int32_t* flips_out;      // [I, R] or null
  int32_t* claims;         // [I] slots claimed per instance, zero at launch
  int I, R, n_pad, B, n_steps, step_spins, nnz, num_cycles, T,
      full_update_frequency;
  float heat;
  int replica_offset, instance_offset;  // added to the Philox counter words
  uint64_t block_magic;    // ceil(2^32 / B): k / B = (k * block_magic) >> 32
};

size_t shared_bytes(int n_pad, int step_spins) {
  return (size_t)n_pad * sizeof(float)             // phi
         + (size_t)step_spins * sizeof(float)      // dm
         + (size_t)n_pad * 3;                      // m, mpb, flag
}

// Warp 0: -1/2 m.(phi + h); every lane of warp 0 gets the same sum.
__device__ __forceinline__ float warp0_energy(const int8_t* m, const float* phi,
                                              const float* h, int n_pad) {
  const int lane = threadIdx.x;
  float acc = 0.f;
  for (int j = lane; j < n_pad; j += 32)
    acc += (float)m[j] * (phi[j] + __ldg(h + j));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return -0.5f * acc;
}

// phi[j] += the sums of x[k - x0] * w_kj over the sources k of j in step s,
// for every target j of the step, one row block's sources at a time: one
// thread owns a target, acc starts at 0 and takes fmaf over the block's
// sources in ascending k, then phi[j] += acc (held in a register until the
// target is done), which is the block-by-block walk's association. Every
// source takes its FMA, flipped or not: skipping the unflipped ones (an
// exact identity on acc) made the round slower. The caller synchronises
// before and after.
template <typename X>
__device__ __forceinline__ void gather_step(const Round& a, const float* w,
                                            int s, const X* x, int x0,
                                            float* phi) {
  const Steps& nb = a.nb;
  const int t1 = __ldg(nb.tgt_ptr + s + 1);
  for (int t = __ldg(nb.tgt_ptr + s) + threadIdx.x; t < t1; t += blockDim.x) {
    const int j = __ldg(nb.tgt + t);
    const int e1 = __ldg(nb.src_ptr + t + 1);
    int e = __ldg(nb.src_ptr + t);
    int k = __ldg(nb.src + e);  // every target has a source
    uint32_t blk = (uint32_t)(((uint64_t)k * a.block_magic) >> 32);
    float p = phi[j];
    float acc = 0.f;
    for (;;) {
      acc = fmaf((float)x[k - x0], __ldg(w + e), acc);
      if (++e == e1) break;
      k = __ldg(nb.src + e);
      const uint32_t b = (uint32_t)(((uint64_t)k * a.block_magic) >> 32);
      if (b != blk) {  // the next row block's sources
        p += acc;
        acc = 0.f;
        blk = b;
      }
    }
    phi[j] = p + acc;
  }
}

// phi = J m + h from scratch: phi = h, then step after step the gather of
// the step's m. Ends with a barrier.
__device__ void rebuild_phi(const Round& a, const float* w, const float* h,
                            const int8_t* m, float* phi) {
  for (int j = threadIdx.x; j < a.n_pad; j += blockDim.x) phi[j] = __ldg(h + j);
  __syncthreads();
  for (int s = 0; s < a.n_steps; ++s) {
    gather_step(a, w, s, m, 0, phi);
    __syncthreads();
  }
}

template <int kWidth>
__global__ void __launch_bounds__(kWidth,
                                  kWidth == kNarrow ? kNarrowCtasPerSm : 1)
    ensemble_round_kernel(Round a) {
  extern __shared__ float smem[];
  const int n_pad = a.n_pad, B = a.B;
  float* phi = smem;                                  // [n_pad]
  float* dm = phi + n_pad;                            // [step_spins]
  int8_t* m = reinterpret_cast<int8_t*>(dm + a.step_spins);  // [n_pad]
  int8_t* mpb = m + n_pad;                            // [n_pad] phase best
  uint8_t* flag = reinterpret_cast<uint8_t*>(mpb + n_pad);  // [n_pad]
  __shared__ int flip_sum, claim[2];

  const int tid = threadIdx.x;
  if (tid == 0) {
    uint32_t smid, nsmid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    asm volatile("mov.u32 %0, %%nsmid;" : "=r"(nsmid));
    const int home = (int)((uint64_t)smid * a.I / nsmid);
    // I * R CTAs claim I * R slots: a CTA that finds its instance full
    // finds a free slot in another
    for (int k = 0; k < a.I; ++k) {
      const int i = (home + k) % a.I;
      const int got = atomicAdd(a.claims + i, 1);
      if (got < a.R) {
        claim[0] = got;
        claim[1] = i;
        break;
      }
    }
    flip_sum = 0;
  }
  __syncthreads();
  const int r = claim[0], inst = claim[1];
  const int lane = tid & 31;
  const int slot = inst * a.R + r;
  const size_t row = (size_t)slot * n_pad;
  const size_t sweep_stride = (size_t)a.I * a.R * n_pad;
  const float* h = a.h + (size_t)inst * n_pad;
  const float* w = a.w + (size_t)inst * a.nnz;
  const uint8_t* cl = a.cl + row;
  const bool dn = a.do_nmc[slot] != 0;
  const float beta = a.beta_row[slot];
  const float beta_heated = beta * a.heat;
  const uint32_t seed0 = a.uniforms == nullptr ? (uint32_t)a.seed[0] : 0u;
  const uint32_t seed1 = a.uniforms == nullptr ? (uint32_t)a.seed[1] : 0u;
  const uint32_t r_key = (uint32_t)(r + a.replica_offset);
  const uint32_t inst_key = (uint32_t)(inst + a.instance_offset);

  for (int k = tid; k < n_pad; k += kWidth) {
    const float mv = a.m0[row + k];
    m[k] = mv > 0.f ? 1 : -1;
    a.m_best[row + k] = mv;
  }
  float e_round = INFINITY;  // kept by warp 0
  int flip_count = 0;        // kept by lane 0 of each warp
  __syncthreads();

  int p = 0;  // phase index
  for (int cycle = 0; cycle < a.num_cycles; ++cycle) {
    const int kinds = cycle % a.full_update_frequency == 0 ? 3 : 2;
    for (int kind = 0; kind < kinds; ++kind, ++p) {  // 0 C, 1 NC, 2 ALL
      for (int k = tid; k < n_pad; k += kWidth) {
        const bool on = a.act[k] != 0;
        const bool c = cl[k] != 0;
        uint8_t f;
        if (kind == 2 || !dn) f = on ? kFree : 0;
        else if (kind == 0) f = (c && on ? kFree : 0) | (c ? kHeated : 0);
        else f = !c && on ? kFree : 0;
        flag[k] = f;
        mpb[k] = m[k];
      }
      __syncthreads();
      rebuild_phi(a, w, h, m, phi);
      float e_phase = INFINITY;  // kept by warp 0

      for (int t = 0; t < a.T; ++t) {
        const uint32_t tg = (uint32_t)(p * a.T + t);
        const float* u_t =
            a.uniforms != nullptr ? a.uniforms + tg * sweep_stride + row
                                  : nullptr;
        for (int s = 0; s < a.n_steps; ++s) {
          const int s0 = __ldg(a.nb.step_ptr + s) * B;
          const int width = __ldg(a.nb.step_ptr + s + 1) * B - s0;
          // every thread runs the same number of passes, so the ballot
          // has the whole warp
          for (int i0 = 0; i0 < width; i0 += kWidth) {
            const int i = i0 + tid;
            float d = 0.f;
            if (i < width) {
              const int col = s0 + i;
              const uint8_t f = flag[col];
              if (f & kFree) {
                float u;
                if (u_t != nullptr) {
                  u = u_t[col];
                } else {
                  const uint32_t bits = nmc::philox4x32_10_word0(
                      (uint32_t)col, r_key, tg, inst_key, seed0, seed1);
                  u = (float)(bits >> 8) * 5.9604644775390625e-08f;  // 2^-24
                }
                const float betab = (f & kHeated) ? beta_heated : beta;
                const float p_up = 0.5f * (1.0f + tanhf(betab * phi[col]));
                const int8_t old = m[col];
                const int8_t nw = u < p_up ? 1 : -1;
                m[col] = nw;
                d = (float)(nw - old);
              }
              dm[i] = d;
            }
            const unsigned flipped = __ballot_sync(0xffffffffu, d != 0.f);
            if (lane == 0) flip_count += __popc(flipped);
          }
          __syncthreads();
          gather_step(a, w, s, dm, s0, phi);
          __syncthreads();
        }
        if (tid < 32) {
          const float e = warp0_energy(m, phi, h, n_pad);
          if (e < e_phase) {  // warp-uniform
            e_phase = e;
            for (int j = tid; j < n_pad; j += 32) mpb[j] = m[j];
          }
        }
        __syncthreads();
      }

      // NMC slots carry their phase best; the round best takes it if lower
      if (dn)
        for (int k = tid; k < n_pad; k += kWidth) m[k] = mpb[k];
      if (tid < 32 && e_phase < e_round) {
        e_round = e_phase;
        for (int j = tid; j < n_pad; j += 32) a.m_best[row + j] = (float)mpb[j];
      }
      __syncthreads();
    }
  }

  if (lane == 0) atomicAdd(&flip_sum, flip_count);
  rebuild_phi(a, w, h, m, phi);  // its barriers also publish flip_sum
  if (tid < 32) {
    const float e = warp0_energy(m, phi, h, n_pad);
    if (tid == 0) {
      a.e_carried[slot] = e;
      a.e_best[slot] = e_round;
      if (a.flips_out != nullptr) a.flips_out[slot] = flip_sum;
    }
  }
  for (int k = tid; k < n_pad; k += kWidth) a.m_out[row + k] = (float)m[k];
}

// f(kernel, width) for a built CTA width (256 or 1024); another width gives
// cudaErrorInvalidValue.
template <typename F>
int with_width(int threads, F f) {
  switch (threads) {
    case kNarrow: return f(ensemble_round_kernel<kNarrow>, kNarrow);
    case kWide: return f(ensemble_round_kernel<kWide>, kWide);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launches the round on `stream` with `threads` per CTA; returns the
// cudaError_t of the launch.
int launch_round(const int32_t* step_ptr, const int32_t* tgt_ptr,
                 const int16_t* tgt, const int32_t* src_ptr,
                 const int16_t* src, const float* w, const float* h,
                 const uint8_t* act, const float* m0, const uint8_t* cl,
                 const uint8_t* do_nmc, const float* beta_row,
                 const float* uniforms, const int32_t* seed, float* m_out,
                 float* m_best, float* e_best, float* e_carried,
                 int32_t* flips_out, int32_t* claims, int I, int R,
                 int n_pad, int block_size, int num_steps, int step_spins,
                 int nnz, int num_cycles, int sweeps_per_phase,
                 int full_update_frequency, float heat, int replica_offset,
                 int instance_offset, int threads, void* stream) {
  const Round a{{step_ptr, tgt_ptr, tgt, src_ptr, src}, w, h, act, m0, cl,
                do_nmc, beta_row, uniforms, seed, m_out, m_best, e_best,
                e_carried, flips_out, claims, I, R, n_pad, block_size,
                num_steps, step_spins, nnz, num_cycles, sweeps_per_phase,
                full_update_frequency, heat, replica_offset, instance_offset,
                ((1ull << 32) + block_size - 1) / block_size};
  const size_t smem = shared_bytes(n_pad, step_spins);
  return with_width(threads, [&](auto kernel, int width) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (I == 0 || R == 0) return (int)cudaSuccess;
    kernel<<<I * R, width, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// K4, over the layout built from dense J. Launches on `stream` with
// `threads` (256 or 1024) per CTA; returns the cudaError_t of the launch.
// uniforms and flips_out may be null; claims ([I] int32) must be zero.
// replica_offset and instance_offset (0 for a whole ensemble) key the
// draws of a slice by its global rows.
int ensemble_round_f32(const int32_t* step_ptr, const int32_t* tgt_ptr,
                       const int16_t* tgt, const int32_t* src_ptr,
                       const int16_t* src, const float* w, const float* h,
                       const uint8_t* act, const float* m0,
                       const uint8_t* cl, const uint8_t* do_nmc,
                       const float* beta_row, const float* uniforms,
                       const int32_t* seed, float* m_out, float* m_best,
                       float* e_best, float* e_carried, int32_t* flips_out,
                       int32_t* claims, int I, int R, int n_pad,
                       int block_size, int num_steps, int step_spins,
                       int nnz, int num_cycles, int sweeps_per_phase,
                       int full_update_frequency, float heat,
                       int replica_offset, int instance_offset, int threads,
                       void* stream) {
  return launch_round(step_ptr, tgt_ptr, tgt, src_ptr, src, w, h, act, m0,
                      cl, do_nmc, beta_row, uniforms, seed, m_out, m_best,
                      e_best, e_carried, flips_out, claims, I, R, n_pad,
                      block_size, num_steps, step_spins, nnz, num_cycles,
                      sweeps_per_phase, full_update_frequency, heat,
                      replica_offset, instance_offset, threads, stream);
}

// K5, over the layout built from the union tiles [I, nB, K, B, B].
int ensemble_round_sparse_f32(
    const int32_t* step_ptr, const int32_t* tgt_ptr, const int16_t* tgt,
    const int32_t* src_ptr, const int16_t* src, const float* w,
    const float* h, const uint8_t* act, const float* m0, const uint8_t* cl,
    const uint8_t* do_nmc, const float* beta_row, const float* uniforms,
    const int32_t* seed, float* m_out, float* m_best, float* e_best,
    float* e_carried, int32_t* flips_out, int32_t* claims, int I, int R,
    int n_pad, int block_size, int num_steps, int step_spins, int nnz,
    int num_cycles, int sweeps_per_phase, int full_update_frequency,
    float heat, int replica_offset, int instance_offset, int threads,
    void* stream) {
  return launch_round(step_ptr, tgt_ptr, tgt, src_ptr, src, w, h, act, m0,
                      cl, do_nmc, beta_row, uniforms, seed, m_out, m_best,
                      e_best, e_carried, flips_out, claims, I, R, n_pad,
                      block_size, num_steps, step_spins, nnz, num_cycles,
                      sweeps_per_phase, full_update_frequency, heat,
                      replica_offset, instance_offset, threads, stream);
}

// The kernel's registers per thread at `threads` per CTA and the CTAs of
// it that fit on one SM with `smem_bytes` of dynamic shared memory (the
// CUDA runtime's figures).
int ensemble_round_occupancy(int threads, int smem_bytes, int* registers,
                             int* ctas_per_sm) {
  return with_width(threads, [&](auto kernel, int width) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    *registers = attr.numRegs;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, kernel, width, (size_t)smem_bytes);
  });
}

}  // extern "C"
