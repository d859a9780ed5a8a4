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
be 0. On the card the blocks enter only that check (a CTA keeps 256 A rows
and walks all of B); the plain twins tile the table by (block_a, block_b) as
the Pallas grid does. On a CPU tensor a wrapper runs its `*_reference` and
launches nothing; on a CUDA tensor it launches the kernel or raises.
Launches are counted in `<wrapper>.launches`.

The kernels run on the tensor cores and read their operands packed for them
(`f32_operands`, `i8_operands`): K6 as a bf16 product of depth 3a over the
exact three-way bf16 split of CBT (`split_bf16`), K7 as one s8 product per
digit plane; both take -SA as A and start the accumulator from EB. A wrapper
checks its inputs and packs them (`_pack_f32` / `_pack_i8`), then launches
on the packed operands (`_launch_f32` / `_launch_i8`); the fused solver
calls the two steps apart, so that the packing falls in its upload time.
`mitm_min_operands_reference` and
`mitm_min_i8_operands_reference` reduce the packed operands in the kernels'
association: the table's finite part Y = EB - SA . C, its row min and lowest
column, then EA added to the min.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ._build import bind, load_library
from .sweeps_cuda import _check, _raise_on, _require_cuda

__all__ = ["mitm_min", "mitm_min_reference", "mitm_min_i8",
           "mitm_min_i8_reference", "int8_planes", "I32_PAD", "split_bf16",
           "f32_operands", "i8_operands", "mitm_min_operands_reference",
           "mitm_min_i8_operands_reference"]

_LIB = "exact_mitm"
# argument kinds of each C entry point, in order ('p' pointer, 'i' int); the
# CUDA stream follows as one more pointer
_SIGNATURES = {"mitm_min_f32": "p" * 6 + "i" * 3,
               "mitm_min_i8": "p" * 6 + "i" * 3}
# the kernels keep an A row (a values) in registers: K7's depth is one
# 32-deep s8 k-step, K6's 3a at most 96
MAX_A = 32
# B columns per shared-memory stage of each kernel (csrc/exact_mitm.cu
# kTileB); the packed B and EB are padded to a multiple of it
TILE_B_F32 = 64
TILE_B_I8 = 128
_I32_MAX = torch.iinfo(torch.int32).max

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


def _row_min(Y, col0=0):
    """Per row of Y (min, lowest column attaining it, numbered from col0):
    the iota masked to the row minimum (not `torch.min`'s index, whose
    tie-break is unspecified)."""
    m = Y.min(dim=1).values
    iota = torch.arange(col0, col0 + Y.shape[1], dtype=torch.int32,
                        device=Y.device)
    none = torch.iinfo(torch.int32).max
    return m, torch.where(Y == m[:, None], iota, none).min(dim=1).values


def _reduce_tiles(tile, TA, TB, block_a, block_b, dtype, device):
    """Per-row (min, lowest argmin) over the tiles `tile(i0, j0)`, each
    [block_a, block_b]: `_row_min` within a tile, across tiles strict <, as
    the Pallas kernels accumulate."""
    min_e = torch.empty(TA, dtype=dtype, device=device)
    arg_b = torch.empty(TA, dtype=torch.int32, device=device)
    for i0 in range(0, TA, block_a):
        rows = slice(i0, i0 + block_a)
        for j0 in range(0, TB, block_b):
            m, amin = _row_min(tile(i0, j0), j0)
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


def _round_up(x, m):
    return -(-x // m) * m


def _f32_depth(a):
    """K6's packed depth: 3a rounded up to whole pairs of bf16 k-steps."""
    return 32 * max(1, -(-3 * a // 32))


def split_bf16(x):
    """Three bf16 parts of f32 `x` that sum to it exactly (finite x): each
    part is the remainder's f32 bits with the low 16 cleared (bf16 by
    truncation), so the first keeps 8 of x's 24 significant bits, the second
    8 of the rest and the third what remains. Every part has x's sign and
    |hi| + |mid| + |lo| = |x|, so no partial sum of parts exceeds the sum of
    the magnitudes."""
    r = x.to(torch.float32).contiguous()
    parts = []
    for _ in range(3):
        p = (r.view(torch.int32) & -65536).view(torch.float32)
        parts.append(p.to(torch.bfloat16))
        r = r - p
    return tuple(parts)


def f32_operands(SA, CBT, EB):
    """K6's packed operands (A, B, EB_pad): A = -[SA, SA, SA] [TA, kd] bf16
    and B = the `split_bf16` parts of CBT stacked along the depth,
    transposed to [TB_pad, kd] bf16, both zero padded to kd = 32 *
    ceil(3a / 32); EB_pad [TB_pad] f32 is EB padded with +inf to a multiple
    of TILE_B_F32 columns. A . B^T = -SA . CBT exactly."""
    TA, a = SA.shape
    TB = EB.shape[0]
    kd, TBp = _f32_depth(a), _round_up(TB, TILE_B_F32)
    device = SA.device
    A = torch.zeros((TA, kd), dtype=torch.bfloat16, device=device)
    A[:, :3 * a] = (-SA).repeat(1, 3).to(torch.bfloat16)
    B = torch.zeros((TBp, kd), dtype=torch.bfloat16, device=device)
    B[:TB, :3 * a] = torch.cat(split_bf16(CBT), 0).T
    EBp = torch.full((TBp,), float("inf"), dtype=torch.float32,
                     device=device)
    EBp[:TB] = EB
    return A, B, EBp


def i8_operands(SA, planes, EB):
    """K7's packed operands (A, B, EB_pad): A = -SA [TA, 32] int8 and B =
    the digit planes as [TB_pad, K, 32] int8 (each column's planes
    contiguous), zero padded along the depth; EB_pad [TB_pad] int32 is EB
    padded with INT32_MAX to a multiple of TILE_B_I8 columns."""
    TA, a = SA.shape
    K, _, TB = planes.shape
    TBp = _round_up(TB, TILE_B_I8)
    device = SA.device
    A = torch.zeros((TA, 32), dtype=torch.int8, device=device)
    A[:, :a] = -SA
    B = torch.zeros((TBp, K, 32), dtype=torch.int8, device=device)
    B[:TB, :, :a] = planes.permute(2, 0, 1)
    EBp = torch.full((TBp,), _I32_MAX, dtype=torch.int32, device=device)
    EBp[:TB] = EB
    return A, B, EBp


def mitm_min_operands_reference(A, B, EA, EB_pad):
    """K6 over its packed operands (`f32_operands`) in the kernel's
    association: Y = EB + A . B^T (summed in f64, which is exact on integer
    data, and rounded once to f32), the row min of Y and its lowest column,
    then EA + min in f32; a row with infinite EA takes column 0 (+inf pad
    rows give (+inf, 0), as `mitm_min_reference`)."""
    Y = (EB_pad.double()[None, :] + A.double() @ B.double().T).float()
    m, arg = _row_min(Y)
    return EA + m, torch.where(torch.isinf(EA), 0, arg).to(torch.int32)


def mitm_min_i8_operands_reference(A, B, EA, EB_pad):
    """K7 over its packed operands (`i8_operands`) in the kernel's
    association: Y = EB + sum_k 2^(8k) A . B_k^T wrapped to int32 (each
    plane's product exact in f64), the row min of Y and its lowest column,
    then EA + min wrapped to int32."""
    Y = EB_pad.to(torch.int64)[None, :]
    for k in range(B.shape[1]):
        dot = torch.matmul(A.double(), B[:, k].double().T).to(torch.int64)
        Y = Y + dot * (1 << (8 * k))
    m, arg = _row_min(_wrap_i32(Y))
    return _wrap_i32(EA.to(torch.int64) + m.to(torch.int64)), arg


def _bind(lib, fn: str):
    return bind(lib, fn, _SIGNATURES[fn])


def _check_width(a, TB):
    if a > MAX_A:
        raise ValueError(f"the kernels hold an A row of at most {MAX_A} "
                         f"spins in registers, got a = {a}")
    if TB >= 1 << 31:
        raise ValueError(f"B table of {TB} rows exceeds int32 indices")


def _pack_f32(SA, CBT, EA, EB, *, block_a: int = 512, block_b: int = 4096):
    """`mitm_min`'s checks of CUDA inputs, then K6's packed operands:
    (A, B, EA, EB_pad) for `_launch_f32`."""
    TA, a = SA.shape
    TB = EB.shape[0]
    _blocks(TA, TB, block_a, block_b)
    _require_cuda(SA, "mitm_min")
    device, f32 = SA.device, torch.float32
    _check("SA", SA, (TA, a), f32, device)
    _check("CBT", CBT, (a, TB), f32, device)
    _check("EA", EA, (TA,), f32, device)
    _check("EB", EB, (TB,), f32, device)
    _check_width(a, TB)
    A, B, EBp = f32_operands(SA, CBT, EB)
    return A, B, EA, EBp


def _launch_f32(A, B, EA, EBp):
    """K6 on `_pack_f32`'s operands; counts the launch."""
    (TA, kd), TBp = A.shape, B.shape[0]
    min_e = torch.empty(TA, dtype=torch.float32, device=A.device)
    arg_b = torch.empty(TA, dtype=torch.int32, device=A.device)
    lib = _bind(load_library(_LIB), "mitm_min_f32")
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = lib.mitm_min_f32(A.data_ptr(), B.data_ptr(), EA.data_ptr(),
                           EBp.data_ptr(), min_e.data_ptr(), arg_b.data_ptr(),
                           TA, TBp, kd, stream)
    _raise_on(err, "mitm_min")
    mitm_min.launches += 1
    return min_e, arg_b


def mitm_min(SA, CBT, EA, EB, *, block_a: int = 512, block_b: int = 4096):
    """Per-A-row (min_b energy, argmin_b) over the implicit table
    EA[:, None] + EB[None, :] - SA @ CBT (K6).

    SA [TA, a] +-1 f32; CBT [a, TB] f32; EA [TA] f32 (+inf rows are
    padding); EB [TB] f32. Returns (min_e [TA] f32, arg_b [TA] i32); the
    CUDA kernel on CUDA tensors, the plain torch version on CPU tensors.
    `block_a` / `block_b` tile the table in the plain version only; the
    kernel keeps 256 A rows a CTA and walks all of B, and on CUDA tensors
    the blocks enter only the JAX function's divisibility check.
    """
    if SA.device.type == "cpu":
        return mitm_min_reference(SA, CBT, EA, EB, block_a=block_a,
                                  block_b=block_b)
    return _launch_f32(*_pack_f32(SA, CBT, EA, EB, block_a=block_a,
                                  block_b=block_b))


def _pack_i8(SA, planes, EA, EB, *, block_a: int = 512, block_b: int = 4096):
    """`mitm_min_i8`'s checks of CUDA inputs, then K7's packed operands:
    (A, B, EA, EB_pad) for `_launch_i8`."""
    TA, a = SA.shape
    K, a2, TB = planes.shape
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
    A, B, EBp = i8_operands(SA, planes, EB)
    return A, B, EA, EBp


def _launch_i8(A, B, EA, EBp):
    """K7 on `_pack_i8`'s operands; counts the launch."""
    TA, (TBp, K, _) = A.shape[0], B.shape
    min_e = torch.empty(TA, dtype=torch.int32, device=A.device)
    arg_b = torch.empty(TA, dtype=torch.int32, device=A.device)
    lib = _bind(load_library(_LIB), "mitm_min_i8")
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = lib.mitm_min_i8(A.data_ptr(), B.data_ptr(), EA.data_ptr(),
                          EBp.data_ptr(), min_e.data_ptr(), arg_b.data_ptr(),
                          TA, TBp, K, stream)
    _raise_on(err, "mitm_min_i8")
    mitm_min_i8.launches += 1
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
    tiles, and on CUDA tensors only the divisibility check. The kernel adds
    EA after the row min, which equals the int32 table's min wherever EA +
    (EB - cross) stays inside int32, as it does under the caller's 2^29
    guard.
    """
    if SA.device.type == "cpu":
        return mitm_min_i8_reference(SA, planes, EA, EB, block_a=block_a,
                                     block_b=block_b)
    return _launch_i8(*_pack_i8(SA, planes, EA, EB, block_a=block_a,
                                block_b=block_b))


def kernel_occupancy(i8: bool, arg: int):
    """(registers per thread, dynamic shared memory per CTA, CTAs per SM)
    of K6 (i8 False, arg = the packed depth kd) or K7 (i8 True, arg = the
    digit planes K), from the CUDA runtime (builds the library)."""
    f = load_library(_LIB).mitm_occupancy
    f.argtypes = ([ctypes.c_int, ctypes.c_int]
                  + [ctypes.POINTER(ctypes.c_int)] * 3)
    f.restype = ctypes.c_int
    regs, smem, ctas = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _raise_on(f(int(i8), arg, ctypes.byref(regs), ctypes.byref(smem),
                ctypes.byref(ctas)), "mitm_occupancy")
    return regs.value, smem.value, ctas.value


mitm_min.launches = 0
mitm_min_i8.launches = 0
