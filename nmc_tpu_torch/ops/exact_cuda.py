"""Fused meet-in-the-middle table kernels K6 and K7: the CUDA wrappers and
their plain twins.

The counterparts of ``nmc_tpu/ops/exact_pallas.py``. The exact solver's hot
loop (`exact.solve_exact_fused`) is

    T[ia, ib] = EA[ia] + EB[ib] - SA[ia, :] . C[:, ib]

reduced per A row to (min over ib, the lowest ib attaining it), without T
ever reaching device memory:

  * `mitm_min` (K6, ``mitm_min_pallas``): f32, C = CBT [a, TB]; exact for
    integer values below 2^24 (csrc/exact_mitm.cu, `mitm_min_f32`);
  * `mitm_min_i8` (K7, ``mitm_min_pallas_i8``): integers, C as signed
    base-256 int8 digit planes [K, a, TB] (`int8_planes`), the table and
    its min in int32 with wrapping arithmetic, as XLA's int32 wraps; exact
    below 2^29 (`mitm_min_i8`).

The public arguments keep the JAX layout and the JAX ValueErrors: after
clamping block_a to TA and block_b to TB, TA % block_a and TB % block_b must
be 0. On the card the blocks enter only that check (one CUDA thread owns one
A row and walks all of B); the plain twins tile the table by (block_a,
block_b) as the Pallas grid does. On a CPU tensor a wrapper runs its
`*_reference` and launches nothing; on a CUDA tensor it launches the kernel
or raises. Launches are counted in `<wrapper>.launches`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ._build import bind, load_library
from .sweeps_cuda import _check, _raise_on, _require_cuda

__all__ = ["mitm_min", "mitm_min_reference", "mitm_min_i8",
           "mitm_min_i8_reference", "int8_planes", "I32_PAD"]

_LIB = "exact_mitm"
# argument kinds of each C entry point, in order ('p' pointer, 'i' int); the
# CUDA stream follows as one more pointer
_SIGNATURES = {"mitm_min_f32": "p" * 6 + "i" * 3,
               "mitm_min_i8": "p" * 6 + "i" * 4}
# the kernels keep an A row (a values) in registers
MAX_A = 32

# Padding sentinel for invalid A rows on the int32 path. Any true table
# entry is bounded by the caller's < 2^29 guard, so padded rows satisfy
# T_pad >= 2^30 - 2^29 > T_true and T_pad <= 2^30 + 2^29 < 2^31 (no
# wraparound).
I32_PAD = np.int32(1 << 30)


def int8_planes(C) -> np.ndarray:
    """Signed base-256 digit split: C == sum_k 256^k * planes[k], each
    plane int8 in [-128, 127]. C must be integer-valued (any float or int
    dtype); |C| < 2^29 needs at most 4 planes. Host-side prep for the
    int8 meet-in-the-middle kernel."""
    c = np.asarray(C)
    if not np.all(c == np.round(c)):
        raise ValueError("int8_planes requires integer-valued input")
    c = c.astype(np.int64)
    planes = []
    while True:
        d = ((c + 128) % 256) - 128
        planes.append(d.astype(np.int8))
        c = (c - d) >> 8
        if not np.any(c):
            break
    return np.stack(planes)


def _blocks(TA, TB, block_a, block_b) -> Tuple[int, int]:
    block_a = min(block_a, TA)
    block_b = min(block_b, TB)
    if TA % block_a or TB % block_b:
        raise ValueError(f"table sizes ({TA}, {TB}) must be multiples of "
                         f"blocks ({block_a}, {block_b})")
    return block_a, block_b


def _reduce_tiles(tile, TA, TB, block_a, block_b, dtype, device):
    """Per-row (min, lowest argmin) over the tiles `tile(i0, j0)`, each
    [block_a, block_b]: within a tile the iota masked to the row minimum
    (not `torch.min`'s index, whose tie-break is unspecified), across tiles
    strict <, as the Pallas kernels accumulate."""
    min_e = torch.empty(TA, dtype=dtype, device=device)
    arg_b = torch.empty(TA, dtype=torch.int32, device=device)
    none = torch.iinfo(torch.int32).max
    for i0 in range(0, TA, block_a):
        rows = slice(i0, i0 + block_a)
        for j0 in range(0, TB, block_b):
            T = tile(i0, j0)
            m = T.min(dim=1).values
            iota = torch.arange(j0, j0 + block_b, dtype=torch.int32,
                                device=device)
            amin = torch.where(T == m[:, None], iota, none).min(dim=1).values
            if j0 == 0:
                min_e[rows], arg_b[rows] = m, amin
            else:
                better = m < min_e[rows]
                min_e[rows] = torch.where(better, m, min_e[rows])
                arg_b[rows] = torch.where(better, amin, arg_b[rows])
    return min_e, arg_b


def mitm_min_reference(SA, CBT, EA, EB, *, block_a: int = 512,
                       block_b: int = 4096):
    """Plain-torch K6: per tile EA[:, None] + EB[None, :] - SA @ CBT at full
    f32, then the row min and its lowest index."""
    TA, a = SA.shape
    TB = EB.shape[0]
    block_a, block_b = _blocks(TA, TB, block_a, block_b)

    def tile(i0, j0):
        return (EA[i0:i0 + block_a, None] + EB[None, j0:j0 + block_b]
                - torch.matmul(SA[i0:i0 + block_a], CBT[:, j0:j0 + block_b]))

    return _reduce_tiles(tile, TA, TB, block_a, block_b, EA.dtype, EA.device)


def _wrap_i32(x):
    """int64 -> int32 modulo 2^32 (two's complement), as int32 arithmetic
    wraps."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def mitm_min_i8_reference(SA, planes, EA, EB, *, block_a: int = 512,
                          block_b: int = 4096):
    """Plain-torch K7. Each plane's product runs in float64 (exact: every
    partial is an integer of magnitude <= a * 128 * 127; CUDA has no integer
    matmul), the recombination sum_k 2^(8k) dot_k and the table in int64,
    wrapped to int32 before the min."""
    TA, a = SA.shape
    K, a2, TB = planes.shape
    if a2 != a:
        raise ValueError(f"planes contraction dim {a2} != SA cols {a}")
    block_a, block_b = _blocks(TA, TB, block_a, block_b)
    sa = SA.to(torch.float64)
    ea, eb = EA.to(torch.int64), EB.to(torch.int64)

    def tile(i0, j0):
        rows, cols = slice(i0, i0 + block_a), slice(j0, j0 + block_b)
        cross = 0
        for k in range(K):
            dot = torch.matmul(sa[rows], planes[k, :, cols].to(torch.float64))
            cross = cross + dot.to(torch.int64) * (1 << (8 * k))
        return _wrap_i32(ea[rows, None] + eb[None, cols] - cross)

    return _reduce_tiles(tile, TA, TB, block_a, block_b, torch.int32,
                         EA.device)


def _bind(lib, fn: str):
    return bind(lib, fn, _SIGNATURES[fn])


def _check_width(a, TB):
    if a > MAX_A:
        raise ValueError(f"the kernels hold an A row of at most {MAX_A} "
                         f"spins in registers, got a = {a}")
    if TB >= 1 << 31:
        raise ValueError(f"B table of {TB} rows exceeds int32 indices")


def mitm_min(SA, CBT, EA, EB, *, block_a: int = 512, block_b: int = 4096):
    """Per-A-row (min_b energy, argmin_b) over the implicit table
    EA[:, None] + EB[None, :] - SA @ CBT (K6).

    SA [TA, a] +-1 f32; CBT [a, TB] f32; EA [TA] f32 (+inf rows are
    padding); EB [TB] f32. Returns (min_e [TA] f32, arg_b [TA] i32); the
    CUDA kernel on CUDA tensors, the plain torch version on CPU tensors.
    `block_a` / `block_b` tile the table in the plain version only; the
    kernel gives one thread an A row and walks all of B, and on CUDA
    tensors the blocks enter only the JAX function's divisibility check.
    """
    TA, a = SA.shape
    TB = EB.shape[0]
    if SA.device.type == "cpu":
        return mitm_min_reference(SA, CBT, EA, EB, block_a=block_a,
                                  block_b=block_b)
    _blocks(TA, TB, block_a, block_b)
    _require_cuda(SA, "mitm_min")
    device, f32 = SA.device, torch.float32
    _check("SA", SA, (TA, a), f32, device)
    _check("CBT", CBT, (a, TB), f32, device)
    _check("EA", EA, (TA,), f32, device)
    _check("EB", EB, (TB,), f32, device)
    _check_width(a, TB)
    min_e = torch.empty(TA, dtype=f32, device=device)
    arg_b = torch.empty(TA, dtype=torch.int32, device=device)
    lib = _bind(load_library(_LIB), "mitm_min_f32")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.mitm_min_f32(SA.data_ptr(), CBT.data_ptr(), EA.data_ptr(),
                           EB.data_ptr(), min_e.data_ptr(), arg_b.data_ptr(),
                           TA, a, TB, stream)
    _raise_on(err, "mitm_min")
    mitm_min.launches += 1
    return min_e, arg_b


def mitm_min_i8(SA, planes, EA, EB, *, block_a: int = 512,
                block_b: int = 4096):
    """Integer-exact K6 (K7): the cross-term matrix arrives as signed
    base-256 int8 digit planes (see `int8_planes`) and the table is reduced
    entirely in int32.

    SA [TA, a] +-1 int8; planes [K, a, TB] int8 (K <= 4); EA [TA] int32
    (pad rows = I32_PAD); EB [TB] int32. Returns (min_e [TA] i32, arg_b
    [TA] i32); the CUDA kernel on CUDA tensors, the plain torch version on
    CPU tensors. The blocks act as in `mitm_min`: the plain version's
    tiles, and on CUDA tensors only the divisibility check.
    """
    TA, a = SA.shape
    K, a2, TB = planes.shape
    if SA.device.type == "cpu":
        return mitm_min_i8_reference(SA, planes, EA, EB, block_a=block_a,
                                     block_b=block_b)
    if a2 != a:
        raise ValueError(f"planes contraction dim {a2} != SA cols {a}")
    _blocks(TA, TB, block_a, block_b)
    _require_cuda(SA, "mitm_min_i8")
    device, i32 = SA.device, torch.int32
    _check("SA", SA, (TA, a), torch.int8, device)
    _check("planes", planes, (K, a, TB), torch.int8, device)
    _check("EA", EA, (TA,), i32, device)
    _check("EB", EB, (TB,), i32, device)
    _check_width(a, TB)
    if not 1 <= K <= 4:
        raise ValueError(f"1 to 4 digit planes (|C| < 2^29), got {K}")
    min_e = torch.empty(TA, dtype=i32, device=device)
    arg_b = torch.empty(TA, dtype=i32, device=device)
    lib = _bind(load_library(_LIB), "mitm_min_i8")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.mitm_min_i8(SA.data_ptr(), planes.data_ptr(), EA.data_ptr(),
                          EB.data_ptr(), min_e.data_ptr(), arg_b.data_ptr(),
                          TA, a, TB, K, stream)
    _raise_on(err, "mitm_min_i8")
    mitm_min_i8.launches += 1
    return min_e, arg_b


mitm_min.launches = 0
mitm_min_i8.launches = 0
