"""Philox-4x32-10 in torch integer arithmetic, and the kernels' uniforms.

Salmon et al., "Parallel random numbers: as easy as 1, 2, 3" (SC'11): ten
rounds of two 32 x 32 -> 64-bit multiplies with the key bumped by the Weyl
constants after each. The program's kernels take the first output word of
counter (c0, c1, c2, c3) under key (k0, k1), where the key is the launch's
two seed words, and turn it into a uniform as (bits >> 8) * 2^-24.

Words are held in int64 tensors in [0, 2^32). Each 32 x 32 product is cut
into 16-bit halves so no intermediate passes 2^48.
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def _mulhilo(m: int, c: torch.Tensor):
    a = m * (c & 0xFFFF)
    b = m * (c >> 16)
    t = a + ((b & 0xFFFF) << 16)
    return (b >> 16) + (t >> 32), t & _MASK


def word0(c0, c1, c2, c3, k0, k1) -> torch.Tensor:
    """The first output word of Philox-4x32-10; arguments are int64 tensors
    (or ints) in [0, 2^32) that broadcast together."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK
        k1 = (k1 + _W1) & _MASK
    return c0


def uniforms(bits: torch.Tensor) -> torch.Tensor:
    """(bits >> 8) * 2^-24 in float32: 24 random bits, exact."""
    return (bits >> 8).to(torch.float32) * 5.9604644775390625e-08


def seed_words(seed: torch.Tensor):
    """int32 seed words [..., 2] as two int64 keys in [0, 2^32)."""
    s = seed.to(torch.int64) & _MASK
    return s[..., 0], s[..., 1]
