// Sequential fixed-order heat-bath sweeps, JAX's blocked algorithm, for one
// or many instances in one launch.
//
// Replaces the XLA function nmc_tpu/ops/sweeps.py::run_sweeps with
// within_block="sequential" and block_order="fixed" (not a Pallas kernel),
// and, with an instance axis, its jax.vmap over an ensemble's instances
// (nmc_tpu/parallel/ensemble.py, EnsemblePT's `one_instance`). One entry
// point, sequential_sweeps_f32; ops/sweeps_cuda.py's `sequential_sweeps`
// (one instance) and `sequential_sweeps_batched` (I instances) launch it.
//
// What it computes, per (instance i, replica r): T sweeps over the row
// blocks of B spins in index order at beta = (beta_t * beta_row[i, r]) *
// beta_spin[i, r, col] (the last factor optional), a [1 | I * R, n_pad]
// update mask, per-sweep energies E = -1/2 m.(phi + h) and a running best
// (strict <, e_best from +inf, m_best from m0), and optionally the state
// after every sweep (M [I, T, R, n_pad]). Within a block the spins update
// in order, spin c from x_c = phi_c + corr_c, where corr gathers the
// block's earlier flips through the [B, B] diagonal tile J_diag[i, b]:
// corr = fmaf(d, J_diag[b][k, :], corr) per flip d = new - old of spin k,
// in flip order. After the block, per target j of the block's couplings:
// acc = 0, acc = fmaf(dm_k, w_kj, acc) over its sources k in the block in
// ascending k, phi[j] += acc. That is JAX's association (corr in flip
// order, then phi + the block's product dm @ J_rows[b]) with the product
// summed in ascending k; ops/sweeps_cuda.py's `sequential_sweeps_reference`
// computes exactly this in plain torch (bit for bit in f32; on +-1
// couplings every sum is exact, so it also equals run_sweeps bit for bit).
//
// Random numbers: Philox-4x32-10 (sweep_common.cuh) keyed by the
// instance's two seed words, counter (column, replica + replica_offset,
// sweep, 0), uniform (bits >> 8) * 2^-24; or injected uniforms [T, I, R,
// n_pad]. A spin's draw depends only on its key and counter, so a launch
// over a slice of replicas (with its offset) or of instances (with their
// seed words) draws what the whole launch draws for those rows, and one
// instance of a batched launch draws what its own launch draws.
//
// Design. One warp carries one replica through a block (the in-block
// chain), with the block's phi, corr, m, beta and uniforms in registers:
// lane l holds spins k = kS l .. kS l + kS - 1, kS = ceil(B / 32). The
// chain is a first-flip search: every lane evaluates its spins after the
// last processed one from the current corr, one ballot finds the first
// lane with a flip and a shuffle its first flipping spin, that spin's
// tile row goes into corr and the search restarts after it. No spin
// before the first flip saw a change, so this is the spin-by-spin result
// draw for draw, in one round per flip instead of one step per spin
// (kLookahead bounds how far a round looks; at 1 it is the spin-by-spin
// chain). A round with several flips also keeps the later ones, in spin
// order, up to the first spin coupled to a kept flip (each spin's next
// coupled spin in the block, SequentialNeighbors.next_coupled): none of
// them saw a change either, so on a sparse block a round takes a run of
// flips (kRuns); a dense block, where every spin's next coupled spin is
// the next spin, keeps one flip a round. A round compares each spin's field with two bounds precomputed
// from its uniform and calls tanhf only near them (kBounds), so a
// round's latency is a few adds, a ballot, a shuffle and a shared-memory
// row. No barrier inside a block: a CTA's kP replicas (warps 0 .. kP - 1)
// run their chains independently. The
// tile sits in shared memory, loaded by cp.async while the previous block
// runs (two buffers where shared memory allows, else one, loaded during
// the previous block's phi update), and is read by all kP replicas.
// After the chains (barrier A), the whole CTA updates phi over the block's
// couplings (ops/sweeps_cuda.py, SequentialNeighbors: per row block its
// targets, and their sources in the block in ascending order stored rank
// by rank, [D_b, n_tgt_b] with zero-weight padding, so that the threads of
// a warp, one target each, read consecutive entries; per-instance
// weights): one thread owns a target for all kP replicas, loads each
// (source, weight) entry once and runs one FMA per replica on dm (f32, 0
// or +-2, [B, kP] in shared memory), skipping sources no replica flipped
// (a per-spin replica bit mask, built with shared atomics,
// double-buffered by block parity; a dense block's warps walk only the
// flipped sources, from a ballot over that mask, four weight loads at a
// time); then barrier B.
// Two barriers per block: 8 a sweep at SK-1000. The grid is
// (ceil(R / kP), I), each CTA kMaxThreads wide.
//
// Bound on the H100: at the main path's shapes the launch is a chain, not
// work. Its operation bound (Philox and tanhf per attempt, an FMA per
// coupling per flip) is microseconds; the chain of dependent rounds (one
// per flip, or per run of flips on a sparse block, plus one per block)
// and, on dense couplings, the phi update's
// weight traffic (each CTA reads its instance's whole layout once a
// sweep) set the time: the chains take most of a single-instance launch
// on SK-1000, the phi update most of EnsemblePT's batched one
// (chip_smoke.py --sequential-ablation; PERF.md). chip_smoke.py reports
// the launch beside its operation bound and its chain floor.
//
// Shared memory: n_buf [B, B] f32 tiles, phi (f32) and m (int8) per
// replica, dm [B, kP] f32 and two [B] u32 masks: 64 KB a tile at B = 128
// plus 5 kP bytes per spin; the wrapper picks kP and n_buf to fit 227 KB
// (ops/sweeps_cuda.py, sequential_launch) and raises when even one replica
// with one tile does not fit.

#include <type_traits>

#include "sweep_common.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr unsigned kFull = 0xffffffffu;
// Spins a round of the in-block search evaluates past the last processed
// one: every remaining spin of the block (first-flip search).
constexpr int kLookahead = 128;
// A round keeps the run of flips before the first spin coupled to a kept
// flip (false: the first flip only).
constexpr bool kRuns = true;
// The draw of a spin is new = +1 iff u < g(z) = 0.5f * (1.0f + tanhf(z)),
// z = beta * (phi + corr). g is within 1e-7 of p(z) = (1 + tanh z) / 2
// (tanhf is within 2 ulp; the add rounds once), so where p(z) < u - kBand
// the draw is -1 and where p(z) > u + kBand it is +1. Those two z bounds,
// atanhf(2 (u -+ kBand) - 1) (3 ulp), move p by under 1e-7 more; with
// kBounds the chain compares z with them and calls tanhf only inside the
// band (a 2e-5 share of the draws): the same draws, without tanhf's
// latency on the chain.
constexpr bool kBounds = true;
constexpr float kBand = 1e-5f;

// The couplings by row block b (SequentialNeighbors): targets
// [tgt_ptr[b], tgt_ptr[b+1]) and entries [ell_ptr[b], ell_ptr[b+1]), which
// hold D_b = entries / targets ranks of n_tgt_b entries: entry d * n_tgt_b
// + i is the d-th source (offset k - b * B, ascending) of the block's i-th
// target, or padding (source 0, weight 0) past its last. In a dense block
// (dense[b]) rank d is source offset d for every target (weight 0 where
// there is no coupling), so its entries need no source lookup. For the
// chain: byte s of next[b, l] is the first spin of block b after spin
// kS l + s coupled to it (kS = ceil(B / 32), the union pattern), or B.
struct Layout {
  const int32_t* tgt_ptr;  // [nB + 1]
  const int16_t* tgt;      // [n_tgt] target spin j
  const int32_t* ell_ptr;  // [nB + 1]
  const int16_t* src;      // [n_ell] source offset within the block
  const uint8_t* dense;    // [nB]
  const uint32_t* next;    // [nB, 32]
};

struct Seq {
  Layout nb;                // the union layout over blocks of B
  const float* w;           // [I, n_ell]
  const float* J_diag;      // [I, nB, B, B]
  const float* h;           // [I, n_pad]
  const float* m0;          // [I, R, n_pad]
  const float* phi0;        // [I, R, n_pad]
  const float* beta_spin;   // [I * R, n_pad] or null (= 1)
  const uint8_t* mask;      // [mask_rows, n_pad] (bool storage)
  const float* beta_sweep;  // [T]
  const float* beta_row;    // [I * R]
  const float* uniforms;    // [T, I, R, n_pad] or null
  const int32_t* seed;      // [I, 2], read when uniforms is null
  float* m_out;             // [I, R, n_pad]
  float* phi_out;           // [I, R, n_pad]
  float* m_best;            // [I, R, n_pad]
  float* e_best;            // [I, R]
  float* energies;          // [I, T, R]
  float* M;                 // [I, T, R, n_pad] or null
  int I, R, n_pad, B, T, n_ell, mask_rows;
  int replica_offset;       // added to the Philox replica word
  int n_buf;                // tile buffers in shared memory (1 or 2)
  int vec16;                // tiles copy in 16-byte pieces (aligned, B even)
};

__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          int count, bool vec16) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if (vec16) {
    for (int q = threadIdx.x; q < count / 4; q += blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(d + 16u * q), "l"(src + 4 * q));
  } else {
    for (int q = threadIdx.x; q < count; q += blockDim.x)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   :: "r"(d + 4u * q), "l"(src + q));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_tiles() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// What one replica's chain reads, fixed for the launch.
struct Chain {
  const uint8_t* mask;      // the replica's mask row (or the shared row)
  const float* beta_spin;   // its beta_spin row, or null
  const float* uniforms;    // its row of sweep 0, or null
  size_t u_sweep;           // I * R * n_pad
  float beta_row;
  uint32_t r, seed0, seed1;  // Philox replica word and key
};

// Warp `p` (its replica's phi and m rows in shared memory) runs the
// in-block chain of block b at sweep t; writes the block's new m, its dm
// column p into dm [B, kP] and bit p of `flipped` [B] for each flip. Lane
// l holds the block's spins k = kS l .. kS l + kS - 1, so the spins come
// lane after lane: one ballot finds the first lane with a flip, and one
// shuffle brings its first flipping slot and that spin's old sign; the
// next lanes with a flip follow, their flips kept in order while they lie
// before the first spin coupled to a kept flip (`stop`).
template <int kS, int kP>
__device__ __forceinline__ void chain_block(const Chain& c, const Layout& nb,
                                            int B, int b, int t,
                                            float beta_t, const float* tile,
                                            float* phi, int8_t* m, float* dm,
                                            uint32_t* flipped, int p) {
  const int lane = threadIdx.x & 31;
  const int s0 = b * B;
  const int k0 = kS * lane;  // the lane's first spin of the block
  float x[kS], corr[kS], m_in[kS], bt[kS], u[kS], zlo[kS], zhi[kS];
  bool cand[kS];
  unsigned up = 0;  // the lane's slots with m = +1
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int k = k0 + s;
    const bool valid = k < B;
    const int col = s0 + k;
    cand[s] = valid && c.mask[valid ? col : 0] != 0;
    x[s] = valid ? phi[col] : 0.f;
    m_in[s] = valid ? (float)m[col] : 1.f;
    if (m_in[s] > 0.f) up |= 1u << s;
    corr[s] = 0.f;
    float bb = beta_t * c.beta_row;
    if (c.beta_spin != nullptr && valid) bb = bb * c.beta_spin[col];
    bt[s] = bb;
    u[s] = 1.f;
    if (cand[s]) {
      if (c.uniforms != nullptr) {
        u[s] = c.uniforms[(size_t)t * c.u_sweep + col];
      } else {
        const uint32_t bits = nmc::philox4x32_10_word0(
            (uint32_t)col, c.r, (uint32_t)t, 0u, c.seed0, c.seed1);
        u[s] = (float)(bits >> 8) * 5.9604644775390625e-08f;  // 2^-24
      }
    }
    zlo[s] = kBounds && u[s] - kBand > 0.f
                 ? atanhf(2.f * (u[s] - kBand) - 1.f) : -INFINITY;
    zhi[s] = kBounds && u[s] + kBand < 1.f
                 ? atanhf(2.f * (u[s] + kBand) - 1.f) : INFINITY;
  }
  // a full block (B = 32 kS) reads its lane's kS tile entries in one load
  const bool full = B == 32 * kS;
  // corr += d * the tile row of spin kf
  auto apply = [&](int kf, float d) {
    const float* row = tile + (size_t)kf * B;
    if constexpr (kS == 4) {
      if (full) {
        const float4 r = reinterpret_cast<const float4*>(row)[lane];
        corr[0] = fmaf(d, r.x, corr[0]);
        corr[1] = fmaf(d, r.y, corr[1]);
        corr[2] = fmaf(d, r.z, corr[2]);
        corr[3] = fmaf(d, r.w, corr[3]);
      }
    } else if constexpr (kS == 2) {
      if (full) {
        const float2 r = reinterpret_cast<const float2*>(row)[lane];
        corr[0] = fmaf(d, r.x, corr[0]);
        corr[1] = fmaf(d, r.y, corr[1]);
      }
    }
    if (kS == 1 || !full) {
#pragma unroll
      for (int s = 0; s < kS; ++s)
        if (k0 + s < B) corr[s] = fmaf(d, row[k0 + s], corr[s]);
    }
  };
  // byte s: the first spin after the lane's spin k0 + s coupled to it. A
  // block where that is the next spin (or none) for every spin is dense:
  // its rounds keep one flip and need no run
  const uint32_t next = __ldg(nb.next + b * 32 + lane);
  bool chain = true;
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int k = k0 + s, nk = (next >> (8 * s)) & 0xffu;
    if (k < B && nk != k + 1 && nk != B) chain = false;
  }
  const bool runs = kRuns && !__all_sync(kFull, chain);
  // pos: the last processed spin; spins pos + 1 .. pos + kLookahead are
  // evaluated from the current corr, and the flips among them before the
  // first spin coupled to a kept flip are applied (or, when none flips,
  // they are all final).
  int pos = -1;
  while (pos + 1 < B) {
    const int hi = pos + kLookahead;
    unsigned fl = 0;    // the lane's slots that flip
    unsigned band = 0;  // its slots whose z lies between the bounds
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const int k = k0 + s;
      if (cand[s] && k > pos && k <= hi) {
        const float z = bt[s] * (x[s] + corr[s]);
        if (z < zlo[s] || z > zhi[s]) {
          if ((z > zhi[s]) != (((up >> s) & 1u) != 0u)) fl |= 1u << s;
        } else {
          band |= 1u << s;
        }
      }
    }
    // the exact draw for the slots inside the band, behind a warp-uniform
    // branch so that the common round computes no tanhf
    if (__any_sync(kFull, band != 0u)) {
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        if ((band >> s) & 1u) {
          const float z = bt[s] * (x[s] + corr[s]);
          const bool nw = u[s] < 0.5f * (1.0f + tanhf(z));
          if (nw != (((up >> s) & 1u) != 0u)) fl |= 1u << s;
        }
      }
    }
    const unsigned bal = __ballot_sync(kFull, fl != 0u);
    if (bal == 0u) {
      pos = hi;
      continue;
    }
    // the first flip: the first lane with a flip, its first flipping slot
    // and that spin's old sign
    int owner = __ffs(bal) - 1;
    unsigned packed = __shfl_sync(kFull, fl | (up << 8), owner);
    int slot = __ffs(packed & 0xffu) - 1;
    int kf = kS * owner + slot;
    if (lane == owner) up ^= 1u << slot;
    apply(kf, (packed >> (8 + slot)) & 1u ? -2.f : 2.f);
    // stop: the first spin coupled to a kept flip. When the round has more
    // flips, the later ones before stop are kept too, lane after lane and
    // slot after slot (a run); a round's only flip needs no stop past it
    // (the next round starts there and finds the same flips)
    int stop = kf + 1;
    if (runs && ((bal & (bal - 1u)) != 0u ||
                 (packed & 0xffu & (0xfeu << slot)) != 0u)) {
      unsigned nx = __shfl_sync(kFull, next, owner);
      stop = min(hi + 1, (int)((nx >> (8 * slot)) & 0xffu));
      if (stop > kf + 1) {
        // the first lane's later flipping slots, then the next lanes'
        unsigned f = packed & 0xffu & (0xfeu << slot);
        unsigned lanes = bal & (bal - 1u);
        while (true) {
          if (f == 0u) {
            if (lanes == 0u) break;
            owner = __ffs(lanes) - 1;
            lanes &= lanes - 1u;
            if (kS * owner >= stop) break;
            packed = __shfl_sync(kFull, fl | (up << 8), owner);
            nx = __shfl_sync(kFull, next, owner);
            f = packed & 0xffu;
          }
          slot = __ffs(f) - 1;
          f &= f - 1u;
          kf = kS * owner + slot;
          if (kf >= stop) break;
          if (lane == owner) up ^= 1u << slot;
          apply(kf, (packed >> (8 + slot)) & 1u ? -2.f : 2.f);
          stop = min(stop, (int)((nx >> (8 * slot)) & 0xffu));
        }
      }
    }
    pos = stop - 1;
  }
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int k = k0 + s;
    if (k < B) {
      const float mo = (up >> s) & 1u ? 1.f : -1.f;
      const float delta = mo - m_in[s];
      m[s0 + k] = (int8_t)mo;
      dm[k * kP + p] = delta;
      if (delta != 0.f) atomicOr(flipped + k, 1u << p);
    }
  }
}

// acc[p] = fmaf(dm[k, p], wt, acc[p]) for the kP replicas.
template <int kP>
__device__ __forceinline__ void fma_replicas(float* acc, const float* dm,
                                             int k, float wt) {
  const float* d = dm + k * kP;
  if constexpr (kP % 4 == 0) {
#pragma unroll
    for (int q = 0; q < kP / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(d)[q];
      acc[4 * q] = fmaf(v.x, wt, acc[4 * q]);
      acc[4 * q + 1] = fmaf(v.y, wt, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(v.z, wt, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(v.w, wt, acc[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int p = 0; p < kP; ++p) acc[p] = fmaf(d[p], wt, acc[p]);
  }
}

// phi[p, j] += the FMA chain over the flipped sources of j in block b (from
// 0, ascending k), for each of the kP replicas, one thread per target; a
// source no replica flipped is skipped (its FMAs would add zeros, as a
// padding entry's do). In a dense block the warps take the flipped
// sources from a ballot over `flipped` and load their weights four at a
// time; else each thread walks its target's ranks. All threads call it;
// the caller synchronises before and after.
template <int kS, int kP>
__device__ __forceinline__ void update_phi(const Layout& nb, const float* w,
                                           int b, const float* dm,
                                           const uint32_t* flipped,
                                           float* phi, int n_pad) {
  const int t0 = __ldg(nb.tgt_ptr + b);
  const int nt = __ldg(nb.tgt_ptr + b + 1) - t0;
  if (nt == 0) return;
  const int e0 = __ldg(nb.ell_ptr + b);
  const int ranks = (__ldg(nb.ell_ptr + b + 1) - e0) / nt;
  const float* wb = w + e0;
  if (__ldg(nb.dense + b)) {
    const int lane = threadIdx.x & 31;
    uint32_t mask[kS];  // flipped sources k = 32 s + bit (warp-uniform)
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const int k = 32 * s + lane;
      mask[s] = __ballot_sync(kFull, k < ranks && flipped[k] != 0u);
    }
    for (int i = threadIdx.x; i < nt; i += blockDim.x) {
      float acc[kP];
#pragma unroll
      for (int p = 0; p < kP; ++p) acc[p] = 0.f;
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        uint32_t mk = mask[s];
        while (mk != 0u) {
          int kk[4];
          float wt[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            kk[q] = -1;
            wt[q] = 0.f;
            if (mk != 0u) {
              kk[q] = 32 * s + __ffs(mk) - 1;
              mk &= mk - 1;
              wt[q] = __ldg(wb + (size_t)kk[q] * nt + i);
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (kk[q] >= 0) fma_replicas<kP>(acc, dm, kk[q], wt[q]);
        }
      }
      const int j = __ldg(nb.tgt + t0 + i);
#pragma unroll
      for (int p = 0; p < kP; ++p) phi[p * n_pad + j] += acc[p];
    }
    return;
  }
  for (int i = threadIdx.x; i < nt; i += blockDim.x) {
    float acc[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) acc[p] = 0.f;
#pragma unroll 4
    for (int r = 0; r < ranks; ++r) {
      const int e = r * nt + i;
      const int k = __ldg(nb.src + e0 + e);
      if (flipped[k] == 0u) continue;
      fma_replicas<kP>(acc, dm, k, __ldg(wb + e));
    }
    const int j = __ldg(nb.tgt + t0 + i);
#pragma unroll
    for (int p = 0; p < kP; ++p) phi[p * n_pad + j] += acc[p];
  }
}

size_t shared_bytes(int n_pad, int B, int P, int n_buf) {
  return sizeof(float) * ((size_t)n_buf * B * B + (size_t)P * n_pad
                          + (size_t)B * P + 2 * (size_t)B)
         + (size_t)P * n_pad;
}

template <int kS, int kP, bool kRecord>
__global__ void __launch_bounds__(kMaxThreads, 1)
    sequential_sweeps_kernel(Seq a) {
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, n_pad = a.n_pad, nB = n_pad / B, BB = B * B;
  float* tiles = smem;                                   // [n_buf, B, B]
  float* phi = tiles + a.n_buf * BB;                     // [kP, n_pad]
  float* dm = phi + kP * n_pad;                          // [B, kP]
  uint32_t* flipped = reinterpret_cast<uint32_t*>(dm + B * kP);  // [2, B]
  int8_t* m = reinterpret_cast<int8_t*>(flipped + 2 * B);  // [kP, n_pad]

  const int inst = blockIdx.y;
  const int r0 = blockIdx.x * kP;
  const int live = min(kP, a.R - r0);  // replicas of this CTA that exist
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row0 = (size_t)inst * a.R + r0;  // its first (i, r) row
  const size_t base = row0 * n_pad;
  const float* Jd = a.J_diag + (size_t)inst * nB * BB;
  const float* w = a.w + (size_t)inst * a.n_ell;
  const float* h = a.h + (size_t)inst * n_pad;
  const bool vec16 = a.vec16 != 0;

  for (int q = tid; q < kP * n_pad; q += blockDim.x) {
    if (q < live * n_pad) {
      const float mv = a.m0[base + q];
      m[q] = mv > 0.f ? 1 : -1;
      phi[q] = a.phi0[base + q];
      a.m_best[base + q] = mv;
    } else {  // a missing replica: never drawn, so its dm stays 0
      m[q] = 1;
      phi[q] = 0.f;
    }
  }
  for (int q = tid; q < B * kP; q += blockDim.x) dm[q] = 0.f;
  for (int q = tid; q < 2 * B; q += blockDim.x) flipped[q] = 0u;
  copy_tile(tiles, Jd, BB, vec16);
  wait_tiles();
  __syncthreads();

  const bool chains = warp < live;
  const size_t row = row0 + (chains ? warp : 0);
  Chain c;
  c.mask = a.mask + (a.mask_rows == 1 ? 0 : row * n_pad);
  c.beta_spin = a.beta_spin != nullptr ? a.beta_spin + row * n_pad : nullptr;
  c.uniforms = a.uniforms != nullptr ? a.uniforms + row * n_pad : nullptr;
  c.u_sweep = (size_t)a.I * a.R * n_pad;
  c.beta_row = a.beta_row[row];
  c.r = (uint32_t)(r0 + warp + a.replica_offset);
  c.seed0 = a.uniforms == nullptr ? (uint32_t)a.seed[2 * inst] : 0u;
  c.seed1 = a.uniforms == nullptr ? (uint32_t)a.seed[2 * inst + 1] : 0u;
  float* phi_w = phi + warp * n_pad;
  int8_t* m_w = m + warp * n_pad;
  float e_best = INFINITY;

  int blk = 0;  // blocks run so far; its parity picks the buffers
  for (int t = 0; t < a.T; ++t) {
    const float beta_t = a.beta_sweep[t];
    for (int b = 0; b < nB; ++b, ++blk) {
      const int q = blk & 1;
      const bool more = b + 1 < nB || t + 1 < a.T;
      const float* next = Jd + (size_t)(b + 1 < nB ? b + 1 : 0) * BB;
      // the tile buffer this block reads; with two, the next block's tile
      // loads into the other while this block runs (that buffer was last
      // read by the previous block's chains, before its barrier A)
      float* tile = tiles + (a.n_buf == 2 ? q : 0) * BB;
      if (a.n_buf == 2 && more) copy_tile(tiles + (q ^ 1) * BB, next, BB,
                                          vec16);
      if (chains)
        chain_block<kS, kP>(c, a.nb, B, b, t, beta_t, tile, phi_w, m_w, dm,
                            flipped + q * B, warp);
      __syncthreads();  // A: the block's dm and flip masks are complete
      if (a.n_buf == 1 && more) copy_tile(tiles, next, BB, vec16);
      for (int k = tid; k < B; k += blockDim.x) flipped[(q ^ 1) * B + k] = 0u;
      update_phi<kS, kP>(a.nb, w, b, dm, flipped + q * B, phi, n_pad);
      wait_tiles();
      __syncthreads();  // B: phi updated, the next tile arrived
    }
    if (chains) {
      if constexpr (kRecord) {
        float* Mt = a.M + (((size_t)inst * a.T + t) * a.R + r0 + warp)
                              * n_pad;
        for (int j = lane; j < n_pad; j += 32) Mt[j] = (float)m_w[j];
      }
      // E = -1/2 m.(phi + h): lane l sums j = l, l + 32, ... from 0, then
      // an xor butterfly leaves the same sum in every lane
      float acc = 0.f;
      for (int j = lane; j < n_pad; j += 32)
        acc += (float)m_w[j] * (phi_w[j] + h[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(kFull, acc, off);
      const float e = -0.5f * acc;
      if (lane == 0)
        a.energies[((size_t)inst * a.T + t) * a.R + r0 + warp] = e;
      if (e < e_best) {
        float* best = a.m_best + row * n_pad;
        for (int j = lane; j < n_pad; j += 32) best[j] = (float)m_w[j];
        e_best = e;
      }
    }
  }

  for (int q = tid; q < live * n_pad; q += blockDim.x) {
    a.m_out[base + q] = (float)m[q];
    a.phi_out[base + q] = phi[q];
  }
  if (lane == 0 && chains) a.e_best[row] = e_best;
}

// f(spins per lane, replicas per CTA) for a built shape, as
// std::integral_constants; anything else gives cudaErrorInvalidValue.
template <int kS, typename F>
int with_p(int P, F f) {
  switch (P) {
    case 1: return f(std::integral_constant<int, kS>(),
                     std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, kS>(),
                     std::integral_constant<int, 2>());
    case 4: return f(std::integral_constant<int, kS>(),
                     std::integral_constant<int, 4>());
    case 8: return f(std::integral_constant<int, kS>(),
                     std::integral_constant<int, 8>());
    case 16: return f(std::integral_constant<int, kS>(),
                      std::integral_constant<int, 16>());
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename F>
int with_shape(int B, int P, F f) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  if (B <= 32) return with_p<1>(P, f);
  if (B <= 64) return with_p<2>(P, f);
  if (B <= 128) return with_p<4>(P, f);
  return (int)cudaErrorInvalidValue;
}

template <bool kRecord>
int launch(const Seq& a, int P, void* stream) {
  if (a.n_pad % a.B != 0 || (a.n_buf != 1 && a.n_buf != 2))
    return (int)cudaErrorInvalidValue;
  return with_shape(a.B, P, [&](auto s, auto p) {
    constexpr int kS = decltype(s)::value, kP = decltype(p)::value;
    const size_t smem = shared_bytes(a.n_pad, a.B, kP, a.n_buf);
    cudaError_t err = cudaFuncSetAttribute(
        sequential_sweeps_kernel<kS, kP, kRecord>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (a.R == 0 || a.I == 0) return (int)cudaSuccess;
    const dim3 grid((a.R + kP - 1) / kP, a.I);
    sequential_sweeps_kernel<kS, kP, kRecord>
        <<<grid, kMaxThreads, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// T sequential sweeps of I instances x R replicas over the union layout
// (tgt_ptr .. next, per-instance weights w [I, n_ell]) and the diagonal
// tiles J_diag [I, nB, B, B] (B <= 128), with `replicas_per_cta` (1, 2,
// 4, 8 or 16) replicas per CTA of 512 threads and `n_buf` (1 or 2) tile
// buffers. beta_spin, uniforms and M may be null; mask has mask_rows (1
// or I * R) rows. Launches on `stream`; returns the cudaError_t of the
// launch.
int sequential_sweeps_f32(
    const int32_t* tgt_ptr, const int16_t* tgt, const int32_t* ell_ptr,
    const int16_t* src, const uint8_t* dense, const uint32_t* next,
    const float* w,
    const float* J_diag, const float* h,
    const float* m0, const float* phi0, const float* beta_spin,
    const uint8_t* mask, const float* beta_sweep, const float* beta_row,
    const float* uniforms, const int32_t* seed, float* m_out, float* phi_out,
    float* m_best, float* e_best, float* energies, float* M, int I, int R,
    int n_pad, int block_size, int num_sweeps, int n_ell, int mask_rows,
    int replicas_per_cta, int n_buf, int replica_offset, void* stream) {
  Seq a{{tgt_ptr, tgt, ell_ptr, src, dense, next}, w, J_diag, h,
        m0, phi0, beta_spin, mask, beta_sweep, beta_row, uniforms, seed,
        m_out, phi_out, m_best, e_best, energies, M, I, R, n_pad, block_size,
        num_sweeps, n_ell, mask_rows, replica_offset, n_buf, 0};
  a.vec16 = ((uintptr_t)J_diag % 16 == 0) && (block_size % 2 == 0);
  return M != nullptr ? launch<true>(a, replicas_per_cta, stream)
                      : launch<false>(a, replicas_per_cta, stream);
}

// The kernel's registers per thread at `replicas_per_cta` for blocks of
// `block_size`, and the CTAs of it that fit on one SM with `smem_bytes` of
// dynamic shared memory (the CUDA runtime's figures).
int sequential_sweeps_occupancy(int block_size, int replicas_per_cta,
                                int smem_bytes, int* registers,
                                int* ctas_per_sm) {
  return with_shape(block_size, replicas_per_cta, [&](auto s, auto p) {
    constexpr int kS = decltype(s)::value, kP = decltype(p)::value;
    auto kernel = sequential_sweeps_kernel<kS, kP, false>;
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    *registers = attr.numRegs;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, kernel, kMaxThreads, (size_t)smem_bytes);
  });
}

}  // extern "C"
