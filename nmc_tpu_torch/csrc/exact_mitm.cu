// Fused meet-in-the-middle table kernels of the exact solver.
//
// Replaces nmc_tpu/ops/exact_pallas.py::mitm_min_pallas (K6, the Pallas
// kernel `_kernel`; entry point `mitm_min_f32`) and ::mitm_min_pallas_i8 (K7,
// `_kernel_i8`; entry point `mitm_min_i8`). Both reduce the implicit energy
// table of exact.py's meet-in-the-middle split
//
//     T[ia, ib] = EA[ia] + EB[ib] - SA[ia, :] . C[:, ib]
//
// to one (min over ib, lowest ib attaining it) per A row, without writing T
// anywhere: only the +-1 A table, the B-side cross-term table and the two
// energy vectors are read, and two [TA] vectors are written.
//   * K6: SA [TA, a] f32 +-1, C = CBT [a, TB] f32, EA [TA] f32 (+inf rows
//     are padding), EB [TB] f32; T = (EA + EB) - dot in f32, the dot a chain
//     of FMAs in k order. Products of +-1 are exact, so for integer values
//     below 2^24 every order of summation gives the same bits; for float
//     couplings the result differs from a matmul's in the last bits.
//   * K7: SA [TA, a] int8 +-1, C as K signed base-256 digit planes
//     planes [K, a, TB] int8 (C = sum_k 256^k planes[k]), EA, EB int32 (pad
//     rows carry 2^30). Per plane one __dp4a chain over SA packed 4 per word;
//     cross = sum_k 2^(8k) dot_k and T = EA + EB - cross are taken in
//     uint32 and read back as int32, which is the wrapping int32 arithmetic
//     of the Pallas kernel (a single partial of the top plane can pass 2^31;
//     the true T stays below 2^31 under the caller's 2^29 guard).
//
// Design: one thread owns one A row for the whole launch (grid = TA / 256).
// Its SA row (a <= 32 values, padded with zeros to a multiple of 4: a
// template parameter) and EA sit in registers; it walks all of B in
// increasing ib and keeps its running (min, argmin) in registers, updated
// with strict <, so the first ib attaining the row minimum wins -- the
// lowest index, as the Pallas kernel's masked-iota min gives it. The result
// is written once: no atomics, no second pass, and nothing revisited across
// blocks (the TPU's sequential B axis becomes the loop inside the thread).
// B is staged through shared memory in tiles of 256 columns, k-major
// ([k][column], for K7 [plane][word][column] with 4 plane bytes packed per
// word while staging), so a thread reads 4 neighbouring columns of one k
// with one 16-byte load. All threads of a block read the same address, a
// broadcast without bank conflicts, and each load feeds 4 independent
// FMA / dp4a chains. Pad rows give (+inf, 0) in K6 and (2^30 + ..., lowest
// index) in K7, as in JAX.
//
// Bound: operations. At N = 40 (a = 20, TA = 2^19, TB = 2^20) the table has
// 2^39 entries; K6 spends 20 FMAs and ~5 epilogue operations on each, on the
// f32 pipes (exact f32 keeps it off the TF32 tensor cores); K7 spends 2 x 5
// dp4a and ~5 integer operations on each, on the integer pipes, which are
// half as wide as the f32 pipes. Every byte of B is read once per block of
// 256 rows (~160 GB at N = 40, from L2 or HBM), far below what the
// arithmetic takes. A faster design (s8 tensor cores through mma.sync, 3xTF32
// splitting for K6, a persistent TMA-fed kernel) is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // A rows per block, one per thread
constexpr int kTileB = 256;    // B columns staged in shared memory per step

// K6 on one staged tile: columns [b0, b0 + count) of B, count == kTileB
// unless kGuard (the last, partial tile).
template <int G, bool kGuard>
__device__ __forceinline__ void f32_tile(const float* __restrict__ cbt_s,
                                         const float* __restrict__ eb_s,
                                         const float (&sa)[4 * G], float ea,
                                         int b0, int count, float& best,
                                         int& arg) {
  for (int j = 0; j < count; j += 4) {
    float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll
    for (int k = 0; k < 4 * G; ++k) {
      const float4 c = *reinterpret_cast<const float4*>(cbt_s + k * kTileB + j);
      d0 = fmaf(sa[k], c.x, d0);
      d1 = fmaf(sa[k], c.y, d1);
      d2 = fmaf(sa[k], c.z, d2);
      d3 = fmaf(sa[k], c.w, d3);
    }
    const float4 e = *reinterpret_cast<const float4*>(eb_s + j);
    const float t[4] = {(ea + e.x) - d0, (ea + e.y) - d1, (ea + e.z) - d2,
                        (ea + e.w) - d3};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (t[c] < best && (!kGuard || j + c < count)) {
        best = t[c];
        arg = b0 + j + c;
      }
    }
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads) mitm_f32_kernel(
    const float* __restrict__ SA,   // [TA, a]
    const float* __restrict__ CBT,  // [a, TB]
    const float* __restrict__ EA,   // [TA]
    const float* __restrict__ EB,   // [TB]
    float* __restrict__ min_e,      // [TA]
    int32_t* __restrict__ arg_b,    // [TA]
    int TA, int a, int TB) {
  constexpr int KA = 4 * G;
  __shared__ __align__(16) float cbt_s[KA * kTileB];
  __shared__ __align__(16) float eb_s[kTileB];
  const int tid = threadIdx.x;
  const int row = blockIdx.x * kThreads + tid;
  const bool live = row < TA;

  float sa[KA];
#pragma unroll
  for (int k = 0; k < KA; ++k)
    sa[k] = (live && k < a) ? SA[(size_t)row * a + k] : 0.f;
  const float ea = live ? EA[row] : 0.f;
  float best = INFINITY;
  int arg = 0;

  for (int b0 = 0; b0 < TB; b0 += kTileB) {
    const int count = min(kTileB, TB - b0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = tid; i < KA * kTileB; i += kThreads) {
      const int k = i / kTileB, j = i % kTileB;
      cbt_s[i] = (k < a && j < count) ? CBT[(size_t)k * TB + b0 + j] : 0.f;
    }
    for (int j = tid; j < kTileB; j += kThreads)
      eb_s[j] = j < count ? EB[b0 + j] : 0.f;
    __syncthreads();
    if (count == kTileB)
      f32_tile<G, false>(cbt_s, eb_s, sa, ea, b0, kTileB, best, arg);
    else
      f32_tile<G, true>(cbt_s, eb_s, sa, ea, b0, count, best, arg);
  }
  if (live) {
    min_e[row] = best;
    arg_b[row] = arg;
  }
}

// K7 on one staged tile: planes_s [K][G][kTileB] words of 4 plane bytes.
template <int G, bool kGuard>
__device__ __forceinline__ void i8_tile(const int32_t* __restrict__ planes_s,
                                        const int32_t* __restrict__ eb_s,
                                        const int (&sa)[G], int32_t ea,
                                        int K, int b0, int count,
                                        int32_t& best, int& arg) {
  for (int j = 0; j < count; j += 4) {
    uint32_t x0 = 0, x1 = 0, x2 = 0, x3 = 0;  // cross terms, mod 2^32
    for (int k = 0; k < K; ++k) {
      int d0 = 0, d1 = 0, d2 = 0, d3 = 0;
#pragma unroll
      for (int w = 0; w < G; ++w) {
        const int4 p =
            *reinterpret_cast<const int4*>(planes_s + (k * G + w) * kTileB + j);
        d0 = __dp4a(sa[w], p.x, d0);
        d1 = __dp4a(sa[w], p.y, d1);
        d2 = __dp4a(sa[w], p.z, d2);
        d3 = __dp4a(sa[w], p.w, d3);
      }
      const int shift = 8 * k;
      x0 += (uint32_t)d0 << shift;
      x1 += (uint32_t)d1 << shift;
      x2 += (uint32_t)d2 << shift;
      x3 += (uint32_t)d3 << shift;
    }
    const int4 e = *reinterpret_cast<const int4*>(eb_s + j);
    const uint32_t u = (uint32_t)ea;
    const int32_t t[4] = {(int32_t)(u + (uint32_t)e.x - x0),
                          (int32_t)(u + (uint32_t)e.y - x1),
                          (int32_t)(u + (uint32_t)e.z - x2),
                          (int32_t)(u + (uint32_t)e.w - x3)};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (t[c] < best && (!kGuard || j + c < count)) {
        best = t[c];
        arg = b0 + j + c;
      }
    }
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads) mitm_i8_kernel(
    const int8_t* __restrict__ SA,      // [TA, a]
    const int8_t* __restrict__ planes,  // [K, a, TB]
    const int32_t* __restrict__ EA,     // [TA]
    const int32_t* __restrict__ EB,     // [TB]
    int32_t* __restrict__ min_e,        // [TA]
    int32_t* __restrict__ arg_b,        // [TA]
    int TA, int a, int TB, int K) {
  extern __shared__ __align__(16) int32_t smem_i8[];
  int32_t* planes_s = smem_i8;                  // [K][G][kTileB]
  int32_t* eb_s = smem_i8 + K * G * kTileB;     // [kTileB]
  const int tid = threadIdx.x;
  const int row = blockIdx.x * kThreads + tid;
  const bool live = row < TA;

  int sa[G];  // the row's +-1 values, 4 bytes per word, zero padded
#pragma unroll
  for (int w = 0; w < G; ++w) {
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = 4 * w + q;
      const uint8_t v = (live && k < a) ? (uint8_t)SA[(size_t)row * a + k] : 0;
      word |= (uint32_t)v << (8 * q);
    }
    sa[w] = (int)word;
  }
  const int32_t ea = live ? EA[row] : 0;
  int32_t best = INT32_MAX;
  int arg = 0;

  for (int b0 = 0; b0 < TB; b0 += kTileB) {
    const int count = min(kTileB, TB - b0);
    __syncthreads();
    for (int i = tid; i < K * G * kTileB; i += kThreads) {
      const int kw = i / kTileB, j = i % kTileB;
      const int k = kw / G, w = kw % G;
      uint32_t word = 0;
      if (j < count) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = 4 * w + q;
          if (r < a)
            word |= (uint32_t)(uint8_t)planes[((size_t)k * a + r) * TB + b0 + j]
                    << (8 * q);
        }
      }
      planes_s[i] = (int32_t)word;
    }
    for (int j = tid; j < kTileB; j += kThreads)
      eb_s[j] = j < count ? EB[b0 + j] : 0;
    __syncthreads();
    if (count == kTileB)
      i8_tile<G, false>(planes_s, eb_s, sa, ea, K, b0, kTileB, best, arg);
    else
      i8_tile<G, true>(planes_s, eb_s, sa, ea, K, b0, count, best, arg);
  }
  if (live) {
    min_e[row] = best;
    arg_b[row] = arg;
  }
}

// Word groups (4 spins each) of SA's row; a = 0 still takes one group.
inline int groups_of(int a) { return a <= 4 ? 1 : (a + 3) / 4; }

template <int G>
cudaError_t launch_f32(const float* SA, const float* CBT, const float* EA,
                       const float* EB, float* min_e, int32_t* arg_b, int TA,
                       int a, int TB, cudaStream_t stream) {
  const int grid = (TA + kThreads - 1) / kThreads;
  mitm_f32_kernel<G><<<grid, kThreads, 0, stream>>>(SA, CBT, EA, EB, min_e,
                                                    arg_b, TA, a, TB);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_i8(const int8_t* SA, const int8_t* planes,
                      const int32_t* EA, const int32_t* EB, int32_t* min_e,
                      int32_t* arg_b, int TA, int a, int TB, int K,
                      cudaStream_t stream) {
  const int grid = (TA + kThreads - 1) / kThreads;
  const size_t smem = (size_t)(K * G + 1) * kTileB * sizeof(int32_t);
  mitm_i8_kernel<G><<<grid, kThreads, smem, stream>>>(SA, planes, EA, EB,
                                                      min_e, arg_b, TA, a,
                                                      TB, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K6. Launches on `stream`; returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a > 32).
int mitm_min_f32(const float* SA, const float* CBT, const float* EA,
                 const float* EB, float* min_e, int32_t* arg_b, int TA, int a,
                 int TB, void* stream) {
  if (TA == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (groups_of(a)) {
    case 1: return (int)launch_f32<1>(SA, CBT, EA, EB, min_e, arg_b, TA, a, TB, s);
    case 2: return (int)launch_f32<2>(SA, CBT, EA, EB, min_e, arg_b, TA, a, TB, s);
    case 3: return (int)launch_f32<3>(SA, CBT, EA, EB, min_e, arg_b, TA, a, TB, s);
    case 4: return (int)launch_f32<4>(SA, CBT, EA, EB, min_e, arg_b, TA, a, TB, s);
    case 5: return (int)launch_f32<5>(SA, CBT, EA, EB, min_e, arg_b, TA, a, TB, s);
    case 6: return (int)launch_f32<6>(SA, CBT, EA, EB, min_e, arg_b, TA, a, TB, s);
    case 7: return (int)launch_f32<7>(SA, CBT, EA, EB, min_e, arg_b, TA, a, TB, s);
    case 8: return (int)launch_f32<8>(SA, CBT, EA, EB, min_e, arg_b, TA, a, TB, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K7. Launches on `stream`; returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a > 32 or K outside 1..4).
int mitm_min_i8(const int8_t* SA, const int8_t* planes, const int32_t* EA,
                const int32_t* EB, int32_t* min_e, int32_t* arg_b, int TA,
                int a, int TB, int K, void* stream) {
  if (K < 1 || K > 4) return (int)cudaErrorInvalidValue;
  if (TA == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (groups_of(a)) {
    case 1: return (int)launch_i8<1>(SA, planes, EA, EB, min_e, arg_b, TA, a, TB, K, s);
    case 2: return (int)launch_i8<2>(SA, planes, EA, EB, min_e, arg_b, TA, a, TB, K, s);
    case 3: return (int)launch_i8<3>(SA, planes, EA, EB, min_e, arg_b, TA, a, TB, K, s);
    case 4: return (int)launch_i8<4>(SA, planes, EA, EB, min_e, arg_b, TA, a, TB, K, s);
    case 5: return (int)launch_i8<5>(SA, planes, EA, EB, min_e, arg_b, TA, a, TB, K, s);
    case 6: return (int)launch_i8<6>(SA, planes, EA, EB, min_e, arg_b, TA, a, TB, K, s);
    case 7: return (int)launch_i8<7>(SA, planes, EA, EB, min_e, arg_b, TA, a, TB, K, s);
    case 8: return (int)launch_i8<8>(SA, planes, EA, EB, min_e, arg_b, TA, a, TB, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
