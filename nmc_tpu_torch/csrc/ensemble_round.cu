// One whole ensemble NMC / PT swap round per launch, for every instance.
//
// Two entry points, one kernel body templated on the phi update:
//   ensemble_round_f32         replaces nmc_tpu/ops/round_pallas.py::
//                              pallas_ensemble_round (K4, `_round_kernel`:
//                              dense J [I, n_pad, n_pad], VMEM-resident on
//                              the TPU; the engine's route up to n_pad 1536);
//   ensemble_round_sparse_f32  replaces ::pallas_ensemble_round_streamed
//                              (K5, `_streamed_round_kernel`: the family's
//                              union block-sparse tiles [I, nB, K, B, B]
//                              with col_idx [nB, K]; above 1536).
// Both compute, per (instance, replica slot), the static phase list of
// `_phase_list` (per cycle C, NC and, every full_update_frequency cycles,
// ALL). Per phase: the update mask and the heated beta are rebuilt from
// `act`, the backbone `cl` and the slot's NMC flag `dn` (C: dn ? cl & act :
// act, with beta_row * heat on dn & cl; NC: dn ? ~cl & act : act; ALL: act;
// heat = 1 + f32(temp_x_inv - 1) as the Pallas kernel computes it); phi =
// J m + h is rebuilt from scratch; sweeps_per_phase colored block-Jacobi
// heat-bath sweeps run with a strict-< phase best that starts at +inf and
// m; at the phase end NMC slots jump to their phase best and the round
// best takes it where strictly lower. After the last phase phi is rebuilt
// once more and e_carried = -1/2 m.(phi + h) is written.
//
// Design: one CTA per (replica slot, instance) for the whole round, grid
// (R, I) with the replica index fastest, so that the CTAs of one instance
// run together and share its J through L2. phi (f32), m, the phase-best m
// and the per-spin phase flags (int8 each) stay in shared memory: 7 bytes
// per spin, 14 KB at n_pad 2048. The round-best state goes to device memory
// only at a phase end where it improved. Within a sweep the draw, the
// ballot flip list and the phi update over the flipped spins are those of
// the sweep kernels (sweep_common.cuh): K4 walks the flips' dense J rows
// as K1/K2 do; K5 sums each (tile, column) slot over the flips and adds the
// K partial sums into phi in tile order per column, as K3 does, so a
// padding tile aliasing column block 0 never races the real one. Each CTA
// also counts its flips (for the flips-per-attempt figure).
//
// Bound on the H100: per attempt one Philox-4x32-10 and one tanhf (about
// 110 operations); per flip one FMA per nonzero coupling of the row (6 on
// chimera), although K4 streams the whole dense row (n_pad floats) and K5
// the row's K*B tile floats from L2; per phase one phi rebuild, n_pad^2
// FMAs in K4 and n_pad*K*B in K5 for each slot. At I = 20, R = 32 the 640
// CTAs fit on the 132 SMs at once; J (33 MB dense at chimera 8x8, 105 MB of
// tiles at chimera 16x16) is read from L2 or HBM by every slot of an
// instance, so slots of one instance are scheduled side by side.
//
// Random numbers: Philox-4x32-10 with key = seed and counter = (column,
// replica, phase * sweeps_per_phase + sweep, instance); the uniform is
// (bits >> 8) * 2^-24. Injected uniforms [P, T, I, R, n_pad] replace it.

#include "sweep_common.cuh"

namespace {

using nmc::kThreads;

constexpr uint8_t kFree = 1;    // the spin is updated in this phase
constexpr uint8_t kHeated = 2;  // its beta is beta_row * heat

struct Round {
  const float* J;          // K4: [I, n_pad, n_pad]; K5: [I, nB, K, B, B]
  const int32_t* col_idx;  // K5: [nB, K]
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
  int I, R, n_pad, B, K, num_cycles, T, full_update_frequency;
  float heat;
};

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

// phi = J m + h from scratch. Ends with a barrier.
template <bool kSparse>
__device__ void rebuild_phi(const Round& a, const float* Ji, const float* h,
                            const int8_t* m, float* phi, float* part,
                            int* cols) {
  const int n_pad = a.n_pad, tid = threadIdx.x;
  if (!kSparse) {
    for (int j = tid; j < n_pad; j += blockDim.x) {
      float acc = __ldg(h + j);
      for (int k = 0; k < n_pad; ++k)
        acc = fmaf((float)m[k], __ldg(Ji + (size_t)k * n_pad + j), acc);
      phi[j] = acc;
    }
    __syncthreads();
    return;
  }
  const int B = a.B, K = a.K, slots = a.K * a.B;
  for (int j = tid; j < n_pad; j += blockDim.x) phi[j] = __ldg(h + j);
  for (int b = 0; b < n_pad / B; ++b) {
    const int s = b * B;
    for (int k = tid; k < K; k += blockDim.x)
      cols[k] = a.col_idx[(size_t)b * K + k] * B;
    const float* tiles = Ji + (size_t)b * slots * B;
    for (int slot = tid; slot < slots; slot += blockDim.x) {
      const int k = slot / B;
      const int jj = slot - k * B;
      const float* col = tiles + (size_t)k * B * B + jj;
      float acc = 0.f;
      for (int i = 0; i < B; ++i)
        acc = fmaf((float)m[s + i], __ldg(col + (size_t)i * B), acc);
      part[slot] = acc;
    }
    __syncthreads();
    for (int jj = tid; jj < B; jj += blockDim.x)
      for (int k = 0; k < K; ++k) phi[cols[k] + jj] += part[k * B + jj];
    __syncthreads();
  }
}

template <bool kSparse>
__global__ void __launch_bounds__(kThreads) ensemble_round_kernel(Round a) {
  extern __shared__ float smem[];
  const int n_pad = a.n_pad, B = a.B, K = a.K;
  float* phi = smem;                                  // [n_pad]
  float* part = phi + n_pad;                          // [K * B] (K5)
  float* dm = part + (size_t)K * B;                   // [B]
  int* flips = reinterpret_cast<int*>(dm + B);        // [B]
  int* cols = flips + B;                              // [K] (K5)
  int8_t* m = reinterpret_cast<int8_t*>(cols + K);    // [n_pad]
  int8_t* mpb = m + n_pad;                            // [n_pad] phase best
  uint8_t* flag = reinterpret_cast<uint8_t*>(mpb + n_pad);  // [n_pad]
  __shared__ int num_flips;

  const int r = blockIdx.x, inst = blockIdx.y, tid = threadIdx.x;
  const int slot = inst * a.R + r;
  const size_t row = (size_t)slot * n_pad;
  const size_t sweep_stride = (size_t)a.I * a.R * n_pad;
  const float* h = a.h + (size_t)inst * n_pad;
  const float* Ji = kSparse ? a.J + (size_t)inst * (n_pad / B) * K * B * B
                            : a.J + (size_t)inst * n_pad * n_pad;
  const uint8_t* cl = a.cl + row;
  const bool dn = a.do_nmc[slot] != 0;
  const float beta = a.beta_row[slot];
  const float beta_heated = beta * a.heat;
  const uint32_t seed0 = a.uniforms == nullptr ? (uint32_t)a.seed[0] : 0u;
  const uint32_t seed1 = a.uniforms == nullptr ? (uint32_t)a.seed[1] : 0u;

  for (int k = tid; k < n_pad; k += blockDim.x) {
    const float mv = a.m0[row + k];
    m[k] = mv > 0.f ? 1 : -1;
    a.m_best[row + k] = mv;
  }
  float e_round = INFINITY;  // kept by warp 0
  int flip_total = 0;        // kept by thread 0
  __syncthreads();

  int p = 0;  // phase index
  for (int cycle = 0; cycle < a.num_cycles; ++cycle) {
    const int kinds = cycle % a.full_update_frequency == 0 ? 3 : 2;
    for (int kind = 0; kind < kinds; ++kind, ++p) {  // 0 C, 1 NC, 2 ALL
      for (int k = tid; k < n_pad; k += blockDim.x) {
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
      rebuild_phi<kSparse>(a, Ji, h, m, phi, part, cols);
      float e_phase = INFINITY;  // kept by warp 0

      for (int t = 0; t < a.T; ++t) {
        const uint32_t tg = (uint32_t)(p * a.T + t);
        const float* u_t =
            a.uniforms != nullptr ? a.uniforms + tg * sweep_stride + row
                                  : nullptr;
        for (int s = 0; s < n_pad; s += B) {
          for (int i = tid; i < B; i += blockDim.x) {
            const int col = s + i;
            const uint8_t f = flag[col];
            float d = 0.f;
            if (f & kFree) {
              float u;
              if (u_t != nullptr) {
                u = u_t[col];
              } else {
                const uint32_t bits = nmc::philox4x32_10_word0(
                    (uint32_t)col, (uint32_t)r, tg, (uint32_t)inst, seed0,
                    seed1);
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
          if (kSparse)
            for (int k = tid; k < K; k += blockDim.x)
              cols[k] = a.col_idx[(size_t)(s / B) * K + k] * B;
          __syncthreads();
          nmc::list_flips(dm, flips, &num_flips, B);
          __syncthreads();
          const int nf = num_flips;
          if (tid == 0) flip_total += nf;
          if (!kSparse) {
            // phi[:] += sum_f dm[i_f] * J[s + i_f, :]
            for (int j = tid; j < n_pad; j += blockDim.x) {
              float acc = phi[j];
#pragma unroll 4
              for (int f = 0; f < nf; ++f) {
                const int i = flips[f];
                acc = fmaf(dm[i], __ldg(Ji + (size_t)(s + i) * n_pad + j), acc);
              }
              phi[j] = acc;
            }
          } else if (nf > 0) {
            const int slots = K * B;
            const float* tiles = Ji + (size_t)(s / B) * slots * B;
            for (int sl = tid; sl < slots; sl += blockDim.x) {
              const int k = sl / B;
              const int jj = sl - k * B;
              const float* col = tiles + (size_t)k * B * B + jj;
              float acc = 0.f;
#pragma unroll 4
              for (int f = 0; f < nf; ++f) {
                const int i = flips[f];
                acc = fmaf(dm[i], __ldg(col + (size_t)i * B), acc);
              }
              part[sl] = acc;
            }
            __syncthreads();
            for (int jj = tid; jj < B; jj += blockDim.x)
              for (int k = 0; k < K; ++k) phi[cols[k] + jj] += part[k * B + jj];
          }
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
        for (int k = tid; k < n_pad; k += blockDim.x) m[k] = mpb[k];
      if (tid < 32 && e_phase < e_round) {
        e_round = e_phase;
        for (int j = tid; j < n_pad; j += 32) a.m_best[row + j] = (float)mpb[j];
      }
      __syncthreads();
    }
  }

  rebuild_phi<kSparse>(a, Ji, h, m, phi, part, cols);
  if (tid < 32) {
    const float e = warp0_energy(m, phi, h, n_pad);
    if (tid == 0) {
      a.e_carried[slot] = e;
      a.e_best[slot] = e_round;
      if (a.flips_out != nullptr) a.flips_out[slot] = flip_total;
    }
  }
  for (int k = tid; k < n_pad; k += blockDim.x) a.m_out[row + k] = (float)m[k];
}

template <bool kSparse>
int launch(const Round& a, void* stream) {
  const size_t smem = (size_t)a.n_pad * sizeof(float)           // phi
                      + (size_t)a.K * a.B * sizeof(float)       // part
                      + (size_t)a.B * (sizeof(float) + sizeof(int))  // dm, flips
                      + (size_t)a.K * sizeof(int)               // cols
                      + (size_t)a.n_pad * 3;                    // m, mpb, flag
  cudaError_t err = cudaFuncSetAttribute(
      ensemble_round_kernel<kSparse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (a.I == 0 || a.R == 0) return (int)cudaSuccess;
  const dim3 grid(a.R, a.I);
  ensemble_round_kernel<kSparse>
      <<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4. Launches on `stream`; returns the cudaError_t of the launch.
// flips_out may be null.
int ensemble_round_f32(const float* J, const float* h, const uint8_t* act,
                       const float* m0, const uint8_t* cl,
                       const uint8_t* do_nmc, const float* beta_row,
                       const float* uniforms, const int32_t* seed,
                       float* m_out, float* m_best, float* e_best,
                       float* e_carried, int32_t* flips_out, int I, int R,
                       int n_pad, int block_size, int num_cycles,
                       int sweeps_per_phase, int full_update_frequency,
                       float heat, void* stream) {
  const Round a{J, nullptr, h, act, m0, cl, do_nmc, beta_row, uniforms, seed,
                m_out, m_best, e_best, e_carried, flips_out, I, R, n_pad,
                block_size, 0, num_cycles, sweeps_per_phase,
                full_update_frequency, heat};
  return launch<false>(a, stream);
}

// K5. J_tiles is [I, nB, K, B, B] over the union col_idx [nB, K].
int ensemble_round_sparse_f32(const int32_t* col_idx, const float* J_tiles,
                              const float* h, const uint8_t* act,
                              const float* m0, const uint8_t* cl,
                              const uint8_t* do_nmc, const float* beta_row,
                              const float* uniforms, const int32_t* seed,
                              float* m_out, float* m_best, float* e_best,
                              float* e_carried, int32_t* flips_out, int I,
                              int R, int n_pad, int block_size, int num_tiles,
                              int num_cycles, int sweeps_per_phase,
                              int full_update_frequency, float heat,
                              void* stream) {
  const Round a{J_tiles, col_idx, h, act, m0, cl, do_nmc, beta_row, uniforms,
                seed, m_out, m_best, e_best, e_carried, flips_out, I, R,
                n_pad, block_size, num_tiles, num_cycles, sweeps_per_phase,
                full_update_frequency, heat};
  return launch<true>(a, stream);
}

}  // extern "C"
