// Device code shared by the colored sweep kernels (colored_sweeps_nbr.cu:
// K1, K2 and K3), the sequential sweeps (sequential_sweeps.cu) and the
// whole-round kernels (ensemble_round.cu): the Philox-4x32-10 generator all
// draw from. Each kernel runs its own draws and phi updates.
//
// Random numbers: Philox-4x32-10 with key = seed and counter = (spin column,
// replica, sweep, 0) in the sweep kernels; the uniform is (bits >> 8) *
// 2^-24 as on the TPU. The two seed words are read from device memory, so
// the caller draws them on the card without a host sync. A non-null
// `uniforms` pointer ([T, R, n_pad] f32) replaces Philox so a kernel can be
// held against its plain torch version draw for draw.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace nmc {

__device__ __forceinline__ uint32_t philox4x32_10_word0(
    uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3,
    uint32_t k0, uint32_t k1) {
  // Salmon et al., "Parallel random numbers: as easy as 1, 2, 3" (SC'11).
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

}  // namespace nmc
