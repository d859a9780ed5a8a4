"""Exact chimera ground states by tropical (min-plus) transfer DP.

A numpy copy of ``nmc_tpu/exact_chimera.py`` (held equal to it by
tests/test_torch_exact.py): an exact boundary DP over the chimera graph,
the contraction a tensor-network tool performs approximately (with bond
truncation), done EXACTLY in min-plus arithmetic, with state backtracking.
Complexity O(cells * 2^(4*W+4) * 16): ~0.5e9 scalar min/adds for C4
(128 spins) — seconds on the host. C8 (512 spins, boundary 36 bits) is out
of exact reach. The `exact` command's `auto` route takes it above N = 40 for
chimera layouts.

Chimera layout (the reference's instances): cells of 8 consecutive spins in
row-major (rows x cols) order; within a cell, spins k=0..3 ("V side")
couple K4,4 to k=4..7 ("H side"); vertical inter-cell couplings join equal
k in {0..3} of cells (r,c) and (r+1,c); horizontal join equal k in {4..7}
of (r,c) and (r,c+1).

Energy convention matches `IsingProblem.energy`:
E(s) = -1/2 s.J.s - h.s  (per distinct edge: -J_ij s_i s_j).

DP state: one 4-bit group per column holding that column's most
recently processed cell's V side, plus one 4-bit group for the H side
of the previously processed cell in the current row — 4(W+1) bits.
Processing cell (r,c) retires the (r-1,c) V group and the (r,c-1) H
group (min over both), and installs the cell's own V and H.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["chimera_layout", "solve_exact_chimera"]

# [16, 4] +-1 rows: group state g encodes spins (bit k set -> -1),
# matching exact.signs_table
_S16 = 1.0 - 2.0 * ((np.arange(16)[:, None] >> np.arange(4)[None, :]) & 1)


def chimera_layout(J: np.ndarray, rows: Optional[int] = None,
                   cols: Optional[int] = None) -> Tuple[int, int]:
    """Validate the chimera cell structure of J and return (rows, cols).

    Raises ValueError when J is not a chimera in the shipped layout
    (callers can then fall back to the generic exact tiers / MCMC).
    """
    n = J.shape[0]
    if n % 8:
        raise ValueError(f"n={n} is not a multiple of 8")
    cells = n // 8
    if rows is None or cols is None:
        side = int(round(cells ** 0.5))
        if side * side != cells:
            raise ValueError(f"{cells} cells is not square; pass "
                             "rows/cols explicitly")
        rows = cols = side
    if rows * cols != cells:
        raise ValueError(f"rows*cols = {rows * cols} != {cells} cells")
    ii, jj = np.nonzero(np.triu(J, 1))
    ci, cj = ii // 8, jj // 8
    ki, kj = ii % 8, jj % 8
    intra = ci == cj
    if not np.all((ki[intra] < 4) != (kj[intra] < 4)):
        raise ValueError("intra-cell couplings are not K4,4 bipartite")
    inter = ~intra
    if not np.all(ki[inter] == kj[inter]):
        raise ValueError("inter-cell couplings do not join equal k")
    d = cj[inter] - ci[inter]
    same_row = (ci[inter] // cols) == (cj[inter] // cols)
    horiz = (d == 1) & same_row      # same-row neighbor (no wrap-around)
    vert = d == cols
    if not np.all(horiz | vert):
        raise ValueError("inter-cell couplings join non-neighbor cells")
    if not (np.all(ki[inter][horiz] >= 4) and np.all(ki[inter][vert] < 4)):
        raise ValueError("H/V side convention violated")
    return rows, cols


def solve_exact_chimera(prob, rows: Optional[int] = None,
                        cols: Optional[int] = None,
                        verify: bool = True) -> Tuple[float, np.ndarray]:
    """Exact ground state (energy, state) of a chimera-graph instance.

    Exhaustive over the 2^n states via boundary DP — no sampling, no
    truncation; practical while 4*cols <= ~22 (C4: 20-bit states).
    """
    J = np.asarray(prob.J, np.float64)
    h = np.asarray(prob.h, np.float64)
    rows, cols = chimera_layout(J, rows, cols)
    W = cols
    nstates = 16 ** (W + 1)

    def base(r, c):
        return (r * W + c) * 8

    # dp axes: [V(col 0), ..., V(col W-1), H(prev cell)], each size 16
    dp = np.zeros((16,) * (W + 1), np.float64)
    # per-cell argmin of the retired (V_up, H_left) groups, packed
    # V_up*16 + H_left into one uint8 per new state
    choices = np.empty((rows, W, nstates), np.uint8)

    for r in range(rows):
        for c in range(W):
            b = base(r, c)
            # f[V, H]: intra-cell K4,4 + fields on all 8 spins
            Jvh = J[b:b + 4, b + 4:b + 8]                   # [4, 4]
            f = -(_S16 @ Jvh @ _S16.T)                      # [V, H]
            f -= (_S16 @ h[b:b + 4])[:, None]
            f -= (_S16 @ h[b + 4:b + 8])[None, :]
            # u[V_up, V]: vertical couplings from the cell above
            if r > 0:
                ju = np.diag(J[base(r - 1, c):base(r - 1, c) + 4,
                               b:b + 4]).copy()
                u = -(_S16 * ju) @ _S16.T                   # [V_up, V]
            else:
                u = np.zeros((16, 16))
            # g[H_left, H]: horizontal couplings from the cell left
            if c > 0:
                jg = np.diag(J[base(r, c - 1) + 4:base(r, c - 1) + 8,
                               b + 4:b + 8]).copy()
                g = -(_S16 * jg) @ _S16.T                   # [H_left, H]
            else:
                g = np.zeros((16, 16))

            # dp axes here: (V0..V_{W-1}, H_left). Reductions are kept
            # on the LAST (contiguous) axis — argmin over a strided
            # middle axis is several times slower in numpy.
            # stage 1: retire H_left, introduce this cell's H
            a = dp[..., None, :] + g.T                      # (..., H, HL)
            arg_h = np.argmin(a, axis=-1).astype(np.uint8)  # (..., H)
            a = np.take_along_axis(a, arg_h[..., None],
                                   axis=-1)[..., 0]         # min, (..., H)
            # stage 2: retire V_up (axis c), introduce this cell's V
            a = np.moveaxis(a, c, -1)                       # (..., H, Vup)
            arg_h = np.moveaxis(arg_h, c, -1)               # (..., H, Vup)
            a = a[..., None, :] + u.T                       # (..., H, V, Vup)
            arg_v = np.argmin(a, axis=-1).astype(np.uint8)  # (..., H, V)
            a = np.take_along_axis(a, arg_v[..., None],
                                   axis=-1)[..., 0] + f.T   # (..., H, V)
            # the H_left choice evaluated at the chosen V_up
            hl_pick = np.take_along_axis(arg_h, arg_v, axis=-1)
            packed = (arg_v << np.uint8(4)) | hl_pick       # (..., H, V)
            # restore axis order: V back to axis c, H last
            dp = np.moveaxis(a, -1, c)
            choices[r, c] = np.moveaxis(packed, -1, c).reshape(-1)

    best_flat = int(np.argmin(dp))
    e = float(dp.reshape(-1)[best_flat])

    # backtrack: walk cells in reverse, recovering each cell's (V, H)
    idx = list(np.unravel_index(best_flat, (16,) * (W + 1)))
    s = np.empty(J.shape[0], np.float64)
    for r in range(rows - 1, -1, -1):
        for c in range(W - 1, -1, -1):
            v_g, h_g = idx[c], idx[W]
            b = base(r, c)
            s[b:b + 4] = _S16[v_g]
            s[b + 4:b + 8] = _S16[h_g]
            packed = int(choices[r, c][int(
                np.ravel_multi_index(tuple(idx), (16,) * (W + 1)))])
            idx[c] = packed >> 4          # V_up of (r-1, c)
            idx[W] = packed & 0xF         # H_left of (r, c-1)
    e_chk = float(prob.energy(s))
    if verify:
        assert abs(e_chk - e) <= 1e-6 * max(1.0, abs(e)), \
            f"DP/backtrack mismatch: {e} vs {e_chk}"
    return e_chk, s
