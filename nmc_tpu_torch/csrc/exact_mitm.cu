// Fused meet-in-the-middle table kernels of the exact solver, on the tensor
// cores.
//
// Replaces nmc_tpu/ops/exact_pallas.py::mitm_min_pallas (K6, the Pallas body
// `_kernel` at exact_pallas.py:59; entry point `mitm_min_f32`) and
// ::mitm_min_pallas_i8 (K7, `_kernel_i8` at exact_pallas.py:136; entry point
// `mitm_min_i8`). Both reduce the implicit energy table of exact.py's
// meet-in-the-middle split
//
//     T[ia, ib] = EA[ia] + EB[ib] - SA[ia, :] . C[:, ib]
//
// to one (min over ib, lowest ib attaining it) per A row, without writing T
// anywhere. A table entry is one element of a rank-a matrix product, so each
// kernel is a GEMM whose epilogue is a running min/argmin.
//
// Operands (packed by ops/exact_cuda.py, `f32_operands` / `i8_operands`):
//   * K6: C (f32) is split into three bf16 parts hi + mid + lo, each the
//     remainder's f32 bits with the low 16 cleared, so the parts sum exactly
//     to C, share its sign and |hi| + |mid| + |lo| = |C|. A = -[SA, SA, SA]
//     [TA, kd] bf16 and B = [hi; mid; lo]^T [TB, kd] bf16 along the depth,
//     zero padded to kd = 32 * ceil(3a / 32) (64 at a = 20). One bf16
//     m16n8k16 product of depth kd, accumulated in f32 from EB as the
//     accumulator's start, gives Y = EB + A . B = EB - SA . C. Products of
//     +-1 and a bf16 part are exact; on integer couplings with the caller's
//     bound below 2^24 every partial sum is an integer below 2^24, so Y is
//     exact in any order of summation.
//   * K7: A = -SA [TA, 32] s8 (zero padded), B = the digit planes [TB, K, 32]
//     s8. Per plane one m16n8k32 s8 product into s32 (plane 0 starting from
//     EB), recombined as Y = sum_k 2^(8k) acc_k in uint32 (wrapping, as the
//     Pallas kernel's int32 arithmetic; one partial of the top plane can
//     pass 2^31).
//   EB is padded to a multiple of the column tile with +inf (K6) / INT32_MAX
//   (K7), which no entry's strict < ever prefers.
// EA is a per-row constant and is added after the row min: rounding is
// monotone, so in f32 min_b fl(EA + Y_b) = fl(EA + min_b Y_b), and in int32
// the sum does not wrap under the caller's 2^29 guard (|EA|, |Y| < 2^30).
// A row with EA = +-inf (K6's padding) gives (EA + min, 0), the plain
// version's (+inf, 0).
//
// Design (mma.sync, not wgmma): a CTA of 4 warps keeps 256 A rows resident
// for the whole launch, 64 per warp (4 m16 blocks) as mma.sync A fragments
// in registers, and streams B in increasing column order through a 4-stage
// cp.async ring in shared memory (64 columns a stage for K6, 128 for K7;
// rows padded by 16 bytes so ldmatrix reads without bank conflicts); 3
// CTAs share an SM, so a warp that is late at one stage's barrier holds up
// only its own CTA. The depth is one or a few MMA k-steps, so there is no
// k-loop to pipeline. Epilogue, on the accumulator fragments: each thread
// keeps per fragment row a running min (one min per entry, on the CUDA
// cores) and, at the end of each stage, compares it with the min at the
// stage's start. Only when some row of a warp improved (rare after the
// first stages: a new record in a row) does the warp recompute that
// m-block's products for the stage and take the first column attaining
// the new min; the products are deterministic, so the recomputed values
// are the same bits. Each thread meets its own columns in increasing
// order, so strict < keeps the lowest; the quad (the 4 lanes of a row)
// merges by (value, column), and each row is written once: no atomics, no
// second pass. mma.sync's fragment layout is fixed and documented, which
// keeps that epilogue simple; wgmma would reach the card's full tensor rate
// but its accumulator layout and asynchronous issue make the fused min a
// larger step.
//
// Bounds at N = 40 (a = 20, TA = 2^19, TB = 2^20, 2^39 entries), counting
// the depth the function needs, not the padded one: K6 runs 2 * 3a = 120
// bf16 operations per entry on the tensor cores (6.6e13, 67 ms at 989
// TFLOP/s; it issues 2 * 64, the padded depth) and one min per entry on the
// CUDA cores (8 ms at the f32 rate); K7 2 * a = 40 int8 operations per plane
// and entry (4.4e13 at K = 2, 22 ms at 1979 TOP/s; it issues 2 * 32 per
// plane) and K integer operations per entry on the CUDA cores (the min and
// one shift-and-add per plane past the first; 16 ms at the f32 rate for
// K = 2). So both are bound by the tensor cores. B moves 128 MB (K6) / 64
// MB (K7 at K = 2) per pass over B, 2048 passes at 256 rows a CTA: ~260 /
// 130 GB from L2, where the CTAs that run together walk the same columns at
// about the same pace; HBM sees B about once per wave of CTAs. On an H100
// SXM (700 W) K6 takes ~169 ms and K7 ~120 ms, with the B stream from L2
// and the epilogue's per-entry min beside the MMAs in each warp's issue.
// The shape (warps and rows per CTA, CTAs per SM, stages, columns per
// stage) sits on a plateau (`chip_smoke.py --exact-ablation`).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMB = 4;                              // m16 blocks per warp
constexpr int kRowsPerWarp = 16 * kMB;              // 64 A rows
constexpr int kRowsPerCta = kWarps * kRowsPerWarp;  // 256 A rows
constexpr int kSlots = 2 * kMB;                     // rows a thread holds
constexpr int kStages = 4;                          // cp.async ring depth
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3,
                                        const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

// K6: bf16 operands of depth 16 * KS (KS even), f32 accumulator.
template <int KS>
struct F32Op {
  using V = float;
  static constexpr int kTileB = 64;            // B columns per stage
  static constexpr int kRowBytes = 32 * KS;    // one packed B column
  struct BFrag {
    uint32_t r[KS][2];
  };
  uint32_t a[kMB][KS][4];

  __device__ static V vmax() { return INFINITY; }
  __device__ static V vmin(V x, V y) { return fminf(x, y); }

  __device__ void load_a(const void* A, int TA, int row0, int lane) {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 16 * mb + g + 8 * h;
        const uint32_t* p =
            static_cast<const uint32_t*>(A) + (size_t)row * (8 * KS);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          a[mb][ks][h] = row < TA ? p[8 * ks + q] : 0u;
          a[mb][ks][2 + h] = row < TA ? p[8 * ks + 4 + q] : 0u;
        }
      }
    }
  }

  // B fragments of n-block nb: 16-byte chunk c of a column holds depth
  // 8c..8c+7; one ldmatrix.x4 gives two k-steps.
  __device__ static void load_b(const char* cols, int pitch, int nb, int lane,
                                BFrag& b) {
    const char* row = cols + (8 * nb + (lane & 7)) * pitch + 16 * (lane >> 3);
#pragma unroll
    for (int p = 0; p < KS / 2; ++p)
      ldsm_x4(b.r[2 * p][0], b.r[2 * p][1], b.r[2 * p + 1][0],
              b.r[2 * p + 1][1], row + 64 * p);
  }

  // y = EB + A . B on m-block mb: rows (g, g, g+8, g+8), columns (c, c+1,
  // c, c+1).
  __device__ void tile(const BFrag& b, V eb0, V eb1, int mb, V (&y)[4]) const {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
        : "=f"(y[0]), "=f"(y[1]), "=f"(y[2]), "=f"(y[3])
        : "r"(a[mb][0][0]), "r"(a[mb][0][1]), "r"(a[mb][0][2]),
          "r"(a[mb][0][3]), "r"(b.r[0][0]), "r"(b.r[0][1]), "f"(eb0),
          "f"(eb1), "f"(eb0), "f"(eb1));
#pragma unroll
    for (int ks = 1; ks < KS; ++ks)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(y[0]), "+f"(y[1]), "+f"(y[2]), "+f"(y[3])
          : "r"(a[mb][ks][0]), "r"(a[mb][ks][1]), "r"(a[mb][ks][2]),
            "r"(a[mb][ks][3]), "r"(b.r[ks][0]), "r"(b.r[ks][1]));
  }

  __device__ static void finish(V ea, V m, int arg, V* out_e, int32_t* out_b) {
    *out_e = ea + m;
    *out_b = isinf(ea) ? 0 : arg;
  }
};

// K7: K s8 digit planes of depth 32, s32 accumulators.
template <int K>
struct I8Op {
  using V = int32_t;
  static constexpr int kTileB = 128;
  static constexpr int kRowBytes = 32 * K;
  struct BFrag {
    uint32_t r[K][2];
  };
  uint32_t a[kMB][4];

  __device__ static V vmax() { return INT32_MAX; }
  __device__ static V vmin(V x, V y) { return min(x, y); }

  __device__ void load_a(const void* A, int TA, int row0, int lane) {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 16 * mb + g + 8 * h;
        const uint32_t* p =
            static_cast<const uint32_t*>(A) + (size_t)row * 8;
        a[mb][h] = row < TA ? p[q] : 0u;
        a[mb][2 + h] = row < TA ? p[4 + q] : 0u;
      }
    }
  }

  // plane k's depth is chunks 2k, 2k + 1 of a column; one ldmatrix.x4 gives
  // two planes, an .x2 the last of an odd count.
  __device__ static void load_b(const char* cols, int pitch, int nb, int lane,
                                BFrag& b) {
    const char* row = cols + (8 * nb + (lane & 7)) * pitch;
#pragma unroll
    for (int p = 0; p < K / 2; ++p)
      ldsm_x4(b.r[2 * p][0], b.r[2 * p][1], b.r[2 * p + 1][0],
              b.r[2 * p + 1][1], row + 64 * p + 16 * (lane >> 3));
    if (K % 2)
      ldsm_x2(b.r[K - 1][0], b.r[K - 1][1],
              row + 32 * (K - 1) + 16 * ((lane >> 3) & 1));
  }

  __device__ void tile(const BFrag& b, V eb0, V eb1, int mb, V (&y)[4]) const {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
        : "=r"(y[0]), "=r"(y[1]), "=r"(y[2]), "=r"(y[3])
        : "r"(a[mb][0]), "r"(a[mb][1]), "r"(a[mb][2]), "r"(a[mb][3]),
          "r"(b.r[0][0]), "r"(b.r[0][1]), "r"(eb0), "r"(eb1), "r"(eb0),
          "r"(eb1));
#pragma unroll
    for (int k = 1; k < K; ++k) {
      int32_t d[4];
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
          : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
          : "r"(a[mb][0]), "r"(a[mb][1]), "r"(a[mb][2]), "r"(a[mb][3]),
            "r"(b.r[k][0]), "r"(b.r[k][1]), "r"(0), "r"(0), "r"(0), "r"(0));
#pragma unroll
      for (int i = 0; i < 4; ++i)
        y[i] = (int32_t)((uint32_t)y[i] + ((uint32_t)d[i] << (8 * k)));
    }
  }

  __device__ static void finish(V ea, V m, int arg, V* out_e, int32_t* out_b) {
    *out_e = (int32_t)((uint32_t)ea + (uint32_t)m);
    *out_b = arg;
  }
};

template <class Op>
__global__ void __launch_bounds__(kThreads, 3)
    mitm_kernel(const void* __restrict__ A, const char* __restrict__ B,
                const typename Op::V* __restrict__ EA,
                const typename Op::V* __restrict__ EB,
                typename Op::V* __restrict__ min_e,
                int32_t* __restrict__ arg_b, int TA, int TB) {
  using V = typename Op::V;
  constexpr int kTileB = Op::kTileB;
  constexpr int kPitch = Op::kRowBytes + 16;
  constexpr int kColsBytes = kTileB * kPitch;
  constexpr int kStageBytes = kColsBytes + kTileB * (int)sizeof(V);
  constexpr int kChunksPerCol = Op::kRowBytes / 16;
  extern __shared__ __align__(16) char smem[];

  const int tid = threadIdx.x, lane = tid & 31, q = lane & 3;
  const int row0 = blockIdx.x * kRowsPerCta + (tid >> 5) * kRowsPerWarp;
  Op op;
  op.load_a(A, TA, row0, lane);

  const int n_tiles = TB / kTileB;
  auto load_stage = [&](int t) {
    char* st = smem + (t % kStages) * kStageBytes;
    const char* src = B + (size_t)t * kTileB * Op::kRowBytes;
    for (int i = tid; i < kTileB * kChunksPerCol; i += kThreads)
      cp_async16(st + (i / kChunksPerCol) * kPitch + 16 * (i % kChunksPerCol),
                 src + 16 * (size_t)i);
    const char* eb = reinterpret_cast<const char*>(EB + (size_t)t * kTileB);
    for (int i = tid; i < kTileB * (int)sizeof(V) / 16; i += kThreads)
      cp_async16(st + kColsBytes + 16 * i, eb + 16 * i);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_stage(s);
    cp_async_commit();
  }

  // cmin: the running row min; best: the min at the current stage's start
  V cmin[kSlots], best[kSlots];
  int arg[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    cmin[s] = best[s] = Op::vmax();
    arg[s] = 0;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage t landed; every warp is done with t - 1's
    if (t + kStages - 1 < n_tiles) load_stage(t + kStages - 1);
    cp_async_commit();
    const char* st = smem + (t % kStages) * kStageBytes;
    const V* eb = reinterpret_cast<const V*>(st + kColsBytes);
#pragma unroll
    for (int nb = 0; nb < kTileB / 8; ++nb) {
      typename Op::BFrag b;
      Op::load_b(st, kPitch, nb, lane, b);
      const V eb0 = eb[8 * nb + 2 * q], eb1 = eb[8 * nb + 2 * q + 1];
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) {
        V y[4];
        op.tile(b, eb0, eb1, mb, y);
        cmin[2 * mb] = Op::vmin(cmin[2 * mb], Op::vmin(y[0], y[1]));
        cmin[2 * mb + 1] = Op::vmin(cmin[2 * mb + 1], Op::vmin(y[2], y[3]));
      }
    }
    bool improved = false;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) improved |= cmin[s] < best[s];
    if (__any_sync(kFull, improved)) {
      // some row of this warp has a new min in this stage: recompute the
      // m-blocks concerned and take the first column that attains it
      const int c0 = t * kTileB + 2 * q;
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) {
        bool w0 = cmin[2 * mb] < best[2 * mb];
        bool w1 = cmin[2 * mb + 1] < best[2 * mb + 1];
        if (!__any_sync(kFull, w0 || w1)) continue;
#pragma unroll
        for (int nb = 0; nb < kTileB / 8; ++nb) {
          typename Op::BFrag b;
          Op::load_b(st, kPitch, nb, lane, b);
          V y[4];
          op.tile(b, eb[8 * nb + 2 * q], eb[8 * nb + 2 * q + 1], mb, y);
          const int c = c0 + 8 * nb;
          if (w0 && y[0] == cmin[2 * mb]) {
            arg[2 * mb] = c;
            w0 = false;
          } else if (w0 && y[1] == cmin[2 * mb]) {
            arg[2 * mb] = c + 1;
            w0 = false;
          }
          if (w1 && y[2] == cmin[2 * mb + 1]) {
            arg[2 * mb + 1] = c;
            w1 = false;
          } else if (w1 && y[3] == cmin[2 * mb + 1]) {
            arg[2 * mb + 1] = c + 1;
            w1 = false;
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kSlots; ++s) best[s] = cmin[s];
    }
  }

  // merge the quad by (value, column) and write each row once
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    V v = best[s];
    int ix = arg[s];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const V ov = __shfl_xor_sync(kFull, v, off);
      const int oi = __shfl_xor_sync(kFull, ix, off);
      if (ov < v || (ov == v && oi < ix)) {
        v = ov;
        ix = oi;
      }
    }
    const int row = row0 + 16 * (s / 2) + (lane >> 2) + 8 * (s % 2);
    if (q == 0 && row < TA)
      Op::finish(EA[row], v, ix, min_e + row, arg_b + row);
  }
}

template <class Op>
constexpr int smem_bytes() {
  return kStages * (Op::kTileB * (Op::kRowBytes + 16) +
                    Op::kTileB * (int)sizeof(typename Op::V));
}

template <class Op>
cudaError_t occupancy(int* regs, int* smem, int* ctas) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, mitm_kernel<Op>);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *smem = smem_bytes<Op>();
  err = cudaFuncSetAttribute(mitm_kernel<Op>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, mitm_kernel<Op>,
                                                       kThreads, *smem);
}

template <class Op>
cudaError_t launch(const void* A, const void* B, const typename Op::V* EA,
                   const typename Op::V* EB, typename Op::V* min_e,
                   int32_t* arg_b, int TA, int TB, cudaStream_t stream) {
  if (TB % Op::kTileB) return cudaErrorInvalidValue;
  const int smem = smem_bytes<Op>();
  cudaError_t err = cudaFuncSetAttribute(
      mitm_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = (TA + kRowsPerCta - 1) / kRowsPerCta;
  mitm_kernel<Op><<<grid, kThreads, smem, stream>>>(
      A, static_cast<const char*>(B), EA, EB, min_e, arg_b, TA, TB);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K6 on packed operands: A [TA, kd] bf16, B [TB, kd] bf16 (TB a multiple of
// 64), EA [TA] f32, EB [TB] f32; kd = 32, 64 or 96. Launches on `stream`;
// returns the cudaError_t of the launch (cudaErrorInvalidValue for another
// kd or TB).
int mitm_min_f32(const void* A, const void* B, const float* EA,
                 const float* EB, float* min_e, int32_t* arg_b, int TA, int TB,
                 int kd, void* stream) {
  if (TA == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (kd) {
    case 32:
      return (int)launch<F32Op<2>>(A, B, EA, EB, min_e, arg_b, TA, TB, s);
    case 64:
      return (int)launch<F32Op<4>>(A, B, EA, EB, min_e, arg_b, TA, TB, s);
    case 96:
      return (int)launch<F32Op<6>>(A, B, EA, EB, min_e, arg_b, TA, TB, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K7 on packed operands: A [TA, 32] s8 (-SA), B [TB, K, 32] s8 (TB a
// multiple of 128), EA [TA] i32, EB [TB] i32; K = 1..4 digit planes.
// Launches on `stream`; returns the cudaError_t of the launch
// (cudaErrorInvalidValue for K outside 1..4 or another TB).
int mitm_min_i8(const void* A, const void* B, const int32_t* EA,
                const int32_t* EB, int32_t* min_e, int32_t* arg_b, int TA,
                int TB, int K, void* stream) {
  if (TA == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
    case 1:
      return (int)launch<I8Op<1>>(A, B, EA, EB, min_e, arg_b, TA, TB, s);
    case 2:
      return (int)launch<I8Op<2>>(A, B, EA, EB, min_e, arg_b, TA, TB, s);
    case 3:
      return (int)launch<I8Op<3>>(A, B, EA, EB, min_e, arg_b, TA, TB, s);
    case 4:
      return (int)launch<I8Op<4>>(A, B, EA, EB, min_e, arg_b, TA, TB, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Registers per thread, dynamic shared memory per CTA and resident CTAs
// per SM of K6 (i8 = 0, arg = kd) or K7 (i8 = 1, arg = K), from the CUDA
// runtime.
int mitm_occupancy(int i8, int arg, int* regs, int* smem, int* ctas) {
  if (!i8 && arg == 32) return (int)occupancy<F32Op<2>>(regs, smem, ctas);
  if (!i8 && arg == 64) return (int)occupancy<F32Op<4>>(regs, smem, ctas);
  if (!i8 && arg == 96) return (int)occupancy<F32Op<6>>(regs, smem, ctas);
  if (i8 && arg == 1) return (int)occupancy<I8Op<1>>(regs, smem, ctas);
  if (i8 && arg == 2) return (int)occupancy<I8Op<2>>(regs, smem, ctas);
  if (i8 && arg == 3) return (int)occupancy<I8Op<3>>(regs, smem, ctas);
  if (i8 && arg == 4) return (int)occupancy<I8Op<4>>(regs, smem, ctas);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
