// The label-swap stage of parallel tempering, every ladder in one launch.
//
// Replaces no Pallas kernel: the JAX package runs this stage
// (nmc_tpu/parallel/swaps.py: select_pairs_device, metropolis_label_swap)
// as XLA ops. Run as torch operations on the card, it was ~30 launches of
// a few microseconds each per swap pair, behind a constant copied from
// host memory that made the host wait for the sweep kernel, so the card
// idled while the host enqueued them. This kernel is the whole stage in
// one launch with no host read: the host enqueues the next round while the
// sweep kernel of this one runs.
//
// What it computes, per ladder i (parallel/swaps.py: label_swap_reference,
// its plain twin, bit for bit):
//   selection, for k < num_pairs: the argmax over the pairs b < R - 1 of
//     gumbels[i, k, b] where b is still available and -inf where not, in
//     torch.argmax's order (NaN above every number, the first index among
//     equals); pairs[i, k] = that b, or -1 where no pair was available;
//     then pairs b - 1, b and b + 1 are no longer available;
//   Metropolis, over k in order: bc = clamp(pairs[i, k], 0, R - 2), lo / hi
//     the slots of labels bc / bc + 1, dB = beta[bc + 1] - beta[bc], dE =
//     E[hi] - E[lo], accept = (pairs[i, k] >= 0) & (u[i, k] <
//     clamp(exp(dB * dE), max=1)), where the clamp keeps NaN (never
//     accepted) and takes inf to 1; accepted labels exchange their slots;
//   slot_to_beta, the inverse permutation of the final beta_to_slot.
// The float operations are torch's: round-to-nearest subtract and multiply
// (as intrinsics, so that nothing contracts into an FMA) and expf, the CUDA
// math library's, which torch's exp calls on float.
//
// Design: one warp a ladder, a CTA of one warp (the engines' I of 1 to 200
// ladders fit one wave of the card's SMs). Lane l holds the pairs b = l
// (mod 32), so any R fits; the argmax is a scan over the lane's pairs and a
// butterfly of shuffles, whose order is total, so every lane ends with
// torch's pick. The availability flags, the betas, the ladder's labels,
// energies, uniforms and picks sit in shared memory. Lane 0 runs the
// Metropolis steps in order on the shared labels (a pick overlaps an
// earlier one only where every available score is -inf, so the steps stay
// sequential, as in the twin).
//
// Bound: I x (num_pairs x (R - 1) Gumbel draws + R energies and labels)
// read and 2 x I x R labels written, tens of KB at the engines' shapes, so
// well under a microsecond of memory time. The stage is bound by its
// serial chain instead: num_pairs dependent argmax reductions (one load of
// the draws and five shuffles each), then num_pairs dependent Metropolis
// steps on shared memory, and the launch itself. The design keeps that
// chain in one warp's registers and shared memory, with no barrier but
// the warp's own.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// torch.argmax's order on CUDA (GreaterOrNan): NaN above every number, the
// lower index first among equals and among NaNs.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  if (isnan(a)) return isnan(b) ? ia < ib : true;
  return a == b ? ia < ib : a > b;
}

// Shared bytes of one ladder: betas, energies and labels [R], uniforms and
// picks [num_pairs], availability flags [R - 1] (padded to 4 bytes).
inline size_t ladder_bytes(int R, int num_pairs) {
  return 12 * (size_t)R + 8 * (size_t)num_pairs + ((R - 1 + 3) & ~3);
}

template <typename Label>
__global__ void label_swaps_kernel(
    const Label* __restrict__ b2s_in, const float* __restrict__ beta,
    const float* __restrict__ energies, const float* __restrict__ gumbels,
    const float* __restrict__ uniforms, Label* __restrict__ b2s_out,
    Label* __restrict__ s2b_out, uint8_t* __restrict__ accepted,
    int64_t* __restrict__ pairs, int R, int num_pairs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x, i = blockIdx.x;
  const int P = R - 1;
  float* s_beta = reinterpret_cast<float*>(smem);
  float* s_e = reinterpret_cast<float*>(smem + 4 * R);
  int* s_lab = reinterpret_cast<int*>(smem + 8 * R);
  float* s_u = reinterpret_cast<float*>(smem + 12 * R);
  int* s_pick = reinterpret_cast<int*>(smem + 12 * R + 4 * num_pairs);
  uint8_t* s_av = smem + 12 * R + 8 * num_pairs;

  const size_t row = (size_t)i * R, prow = (size_t)i * num_pairs;
  for (int t = lane; t < R; t += 32) {
    s_beta[t] = beta[t];
    s_e[t] = energies[row + t];
    s_lab[t] = (int)b2s_in[row + t];
  }
  for (int k = lane; k < num_pairs; k += 32) s_u[k] = uniforms[prow + k];
  for (int b = lane; b < P; b += 32) s_av[b] = 1;

  // Selection: each lane reads and clears only its own pairs' flags.
  const float* g = gumbels + prow * P;
  for (int k = 0; k < num_pairs; ++k, g += P) {
    float best = -INFINITY;
    int arg = INT_MAX;
    bool any = false;
    for (int b = lane; b < P; b += 32) {
      const bool av = s_av[b];
      const float s = av ? g[b] : -INFINITY;
      any |= av;
      if (before(s, b, best, arg)) { best = s; arg = b; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, off);
      const int oi = __shfl_xor_sync(kFull, arg, off);
      if (before(ob, oi, best, arg)) { best = ob; arg = oi; }
    }
    if (__any_sync(kFull, any)) {
      for (int b = lane; b < P; b += 32)
        if (b >= arg - 1 && b <= arg + 1) s_av[b] = 0;
    } else {
      arg = -1;
    }
    if (lane == 0) {
      s_pick[k] = arg;
      pairs[prow + k] = arg;
    }
  }
  __syncwarp();

  if (lane == 0) {
    for (int k = 0; k < num_pairs; ++k) {
      const int b = s_pick[k];
      const int bc = min(max(b, 0), R - 2);
      const int lo = s_lab[bc], hi = s_lab[bc + 1];
      const float dB = __fsub_rn(s_beta[bc + 1], s_beta[bc]);
      const float dE = __fsub_rn(s_e[hi], s_e[lo]);
      const float w = expf(__fmul_rn(dB, dE));
      const bool acc = b >= 0 && s_u[k] < (isnan(w) ? w : fminf(w, 1.0f));
      s_lab[bc] = acc ? hi : lo;
      s_lab[bc + 1] = acc ? lo : hi;
      accepted[prow + k] = acc;
    }
  }
  __syncwarp();
  for (int t = lane; t < R; t += 32) {
    const int s = s_lab[t];
    b2s_out[row + t] = (Label)s;
    s2b_out[row + s] = (Label)t;
  }
}

template <typename Label>
int launch(const void* b2s_in, const float* beta, const float* energies,
           const float* gumbels, const float* uniforms, void* b2s_out,
           void* s2b_out, uint8_t* accepted, int64_t* pairs, int I, int R,
           int num_pairs, void* stream) {
  label_swaps_kernel<Label>
      <<<I, 32, ladder_bytes(R, num_pairs), (cudaStream_t)stream>>>(
          static_cast<const Label*>(b2s_in), beta, energies, gumbels,
          uniforms, static_cast<Label*>(b2s_out),
          static_cast<Label*>(s2b_out), accepted, pairs, R, num_pairs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One swap round of I ladders of R labels (int32 or int64, `label_bytes`
// 4 or 8): beta_to_slot in, betas [R], slot energies [I, R], Gumbel draws
// [I, num_pairs, R - 1] and uniforms [I, num_pairs] (float32, contiguous);
// beta_to_slot and slot_to_beta out ([I, R], the labels' type), accepted
// ([I, num_pairs] bool) and pairs ([I, num_pairs] int64). Launches one
// warp a ladder on `stream`; returns the cudaError_t of the launch.
int label_swaps(const void* b2s_in, const float* beta, const float* energies,
                const float* gumbels, const float* uniforms, void* b2s_out,
                void* s2b_out, uint8_t* accepted, int64_t* pairs, int I,
                int R, int num_pairs, int label_bytes, void* stream) {
  if (label_bytes == 8)
    return launch<int64_t>(b2s_in, beta, energies, gumbels, uniforms,
                           b2s_out, s2b_out, accepted, pairs, I, R,
                           num_pairs, stream);
  if (label_bytes == 4)
    return launch<int32_t>(b2s_in, beta, energies, gumbels, uniforms,
                           b2s_out, s2b_out, accepted, pairs, I, R,
                           num_pairs, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
