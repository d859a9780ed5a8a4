"""Beam-search tropical boundary contraction for large chimera graphs.

Host numpy copies of ``nmc_tpu/beam_chimera.py`` (held equal to it by
tests/test_torch_beam.py). `exact_chimera.solve_exact_chimera` finds exact
ground states by a dense min-plus boundary DP (16^(W+1) states), out of
reach beyond W = 5. This module is its sparse generalization: keep only the
best `beam` boundary states (by partial energy), with exact dominance dedup
(two states with identical boundary bits have identical futures, so only
the lower-energy one is kept). When the kept set never overflows the beam
the result is provably exact (`info["exact"]`); otherwise it is a
deterministic heuristic in the spirit of the tnac4o boundary contraction
that produced the reference's chimera ground truths.

Scales to C8 (512), C12 (1152) and C16 (2048) (boundary 36/52/68 bits) at
beams of 1e5..1e6 on the host in minutes per instance, with parent-pointer
backtracking for the full spin state. DCL instances share the chimera
topology (`pad_to_chimera_grid` completes their partial last row).

Raster order is a myopic horizon; `solve_beam_chimera_multi` runs the four
symmetry orientations (transpose x reverse) and returns the best.
`refine_strips` re-solves column strips exactly (or by the beam, or by a
`sub_solver` such as the device beam of `beam_chimera_cuda`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .exact_chimera import chimera_layout, _S16

__all__ = ["solve_beam_chimera", "solve_beam_chimera_multi",
           "pad_to_chimera_grid", "refine_strips", "solve_chimera_pipeline"]


def pad_to_chimera_grid(prob):
    """(padded_prob, rows, cols, n_orig) for partial-raster chimeras.

    The DCL instances are chimera rasters with an incomplete last row
    (e.g. 119 cells on a 16-wide grid); appending zero-coupled cells
    completes the rectangle without changing any state's energy. Returns
    the problem unchanged when it already validates. Raises ValueError
    when the coupling pattern is not a chimera raster at all.
    """
    from .core.problem import IsingProblem

    J = np.asarray(prob.J, np.float64)
    h = np.asarray(prob.h, np.float64)
    n = J.shape[0]
    if n % 8 == 0:
        try:
            rows, cols = chimera_layout(J)
            return prob, rows, cols, n
        except ValueError:
            pass
    ii, jj = np.nonzero(np.triu(J, 1))
    ci, cj, ki = ii // 8, jj // 8, ii % 8
    inter = ci != cj
    d = cj[inter] - ci[inter]
    vert = np.unique(d[ki[inter] < 4])
    if vert.size != 1:
        raise ValueError("cannot infer chimera grid width")
    cols = int(vert[0])
    cells = -(-n // 8)
    rows = -(-cells // cols)
    n_pad = rows * cols * 8
    J2 = np.zeros((n_pad, n_pad))
    J2[:n, :n] = J
    h2 = np.zeros(n_pad)
    h2[:n] = h
    chimera_layout(J2, rows, cols)     # validates; raises if non-chimera
    return IsingProblem(J2, h2), rows, cols, n


def _cell_tables(J, h, rows, W, r, c):
    """(f[V,H], u[Vup,V], g[Hl,H]) energy tables for cell (r, c)."""
    def base(rr, cc):
        return (rr * W + cc) * 8

    b = base(r, c)
    Jvh = J[b:b + 4, b + 4:b + 8]
    f = -(_S16 @ Jvh @ _S16.T)
    f -= (_S16 @ h[b:b + 4])[:, None]
    f -= (_S16 @ h[b + 4:b + 8])[None, :]
    if r > 0:
        ju = np.diag(J[base(r - 1, c):base(r - 1, c) + 4, b:b + 4]).copy()
        u = -(_S16 * ju) @ _S16.T
    else:
        u = np.zeros((16, 16))
    if c > 0:
        jg = np.diag(J[base(r, c - 1) + 4:base(r, c - 1) + 8,
                       b + 4:b + 8]).copy()
        g = -(_S16 * jg) @ _S16.T
    else:
        g = np.zeros((16, 16))
    return f, u, g


def _pack_keys(groups):
    """[M, G] uint8 nibbles -> (k0, k1) uint64 key words (G <= 32)."""
    m, g_cnt = groups.shape
    k0 = np.zeros(m, np.uint64)
    for j in range(min(g_cnt, 16)):
        k0 |= groups[:, j].astype(np.uint64) << np.uint64(4 * j)
    k1 = np.zeros(m, np.uint64)
    for j in range(16, g_cnt):
        k1 |= groups[:, j].astype(np.uint64) << np.uint64(4 * (j - 16))
    return k0, k1


def solve_beam_chimera(prob, rows: Optional[int] = None,
                       cols: Optional[int] = None,
                       beam: int = 1 << 18,
                       expand_top: Optional[int] = None,
                       verify: bool = True):
    """Deterministic beam boundary DP. Returns (energy, state, info).

    info: {"exact": bool, "beam": int, "max_kept": int} — exact=True
    means no state was ever pruned, i.e. the answer is the true optimum.
    """
    J = np.asarray(prob.J, np.float64)
    h = np.asarray(prob.h, np.float64)
    rows, cols = chimera_layout(J, rows, cols)
    W = cols
    G = W + 1                      # V groups per column + transient H
    if expand_top is None:
        expand_top = 8 * beam

    groups = np.zeros((1, G), np.uint8)
    E = np.zeros(1, np.float64)
    parents_hist = []
    combos_hist = []
    exact = True
    max_kept = 1

    for r in range(rows):
        for c in range(W):
            f, u, g = _cell_tables(J, h, rows, W, r, c)
            # trans[vup*16+hl, V*16+H]
            trans = (u[:, None, :, None] + g[None, :, None, :]
                     + f[None, None, :, :]).reshape(256, 256)
            ridx = (groups[:, c].astype(np.int32) * 16
                    + groups[:, W].astype(np.int32))
            # selection pass in f32 (2x the argpartition throughput);
            # survivors get their energies re-accumulated in f64 below,
            # so f32 only fuzzes the beam boundary, never the energies
            E_off = float(E.min())
            E_exp = ((E - E_off).astype(np.float32)[:, None]
                     + trans.astype(np.float32)[ridx]).ravel()
            if E_exp.size > expand_top:
                keep = np.argpartition(E_exp, expand_top)[:expand_top]
                exact = False
            else:
                keep = np.arange(E_exp.size)
            parents = (keep // 256).astype(np.int64)
            combos = (keep % 256).astype(np.int64)
            E_new = E[parents] + trans[ridx[parents], combos]
            g_new = groups[parents].copy()
            g_new[:, c] = (combos >> 4).astype(np.uint8)
            # retire dead groups from the key so dedup collapses them:
            # H is never read again after the last cell of a row, and a
            # bottom-row V is never read again at all.
            g_new[:, W] = (combos & 15).astype(np.uint8) \
                if c != W - 1 else 0
            if r == rows - 1:
                g_new[:, c] = 0
            # dominance dedup: identical boundary -> keep min energy
            k0, k1 = _pack_keys(g_new)
            order = np.lexsort((E_new, k1, k0))
            k0o, k1o = k0[order], k1[order]
            first = np.empty(order.size, bool)
            first[0] = True
            np.logical_or(k0o[1:] != k0o[:-1], k1o[1:] != k1o[:-1],
                          out=first[1:])
            kept = order[first]
            if kept.size > beam:
                kept = kept[np.argpartition(E_new[kept], beam)[:beam]]
                exact = False
            groups = g_new[kept]
            E = E_new[kept]
            parents_hist.append(parents[kept].astype(np.int32))
            combos_hist.append(combos[kept].astype(np.uint8))
            max_kept = max(max_kept, int(E.size))

    # backtrack the best final state through the parent pointers
    idx = int(np.argmin(E))
    e_dp = float(E[idx])
    s = np.empty(J.shape[0], np.float64)
    for cell in range(rows * W - 1, -1, -1):
        r, c = divmod(cell, W)
        combo = int(combos_hist[cell][idx])
        b = (r * W + c) * 8
        s[b:b + 4] = _S16[combo >> 4]
        s[b + 4:b + 8] = _S16[combo & 15]
        idx = int(parents_hist[cell][idx])
    e = float(prob.energy(s))
    if verify:
        assert abs(e - e_dp) <= 1e-6 * max(1.0, abs(e)), \
            f"beam DP/backtrack mismatch: {e_dp} vs {e}"
    return e, s, {"exact": exact, "beam": beam, "max_kept": max_kept}


def refine_strips(prob, s, rows: Optional[int] = None,
                  cols: Optional[int] = None, window: int = 4,
                  stride: Optional[int] = None, max_passes: int = 20,
                  refine_beam: int = 1 << 16,
                  sub_solver=None, stop_at: Optional[float] = None):
    """Large-neighborhood descent on column strips (both grid
    orientations): freeze every spin outside a `window`-column strip,
    solve the conditioned rows x window sub-chimera by the tropical
    boundary DP — EXACTLY (dense 16^(w+1)-state DP) for window <= 4,
    by the beam DP (`refine_beam` states) for wider windows — install
    the optimum if it improves, and sweep strips until a full pass over
    both orientations improves nothing.

    This is the Hamze-de Freitas-Selby induced-subgraph move with the
    tropical DP as the subgraph solver — a window-8 move jointly
    re-solves a C8-scale sub-problem (rows*64 spins), the size the beam
    solves reliably outright, so droplets narrower than the window
    cannot survive in either orientation. Moves are accepted only when
    they lower the energy, so the descent is monotone even with the
    heuristic beam sub-solver. Returns (energy, state, n_moves).
    Deterministic.

    `sub_solver(sub_prob, rows, cols) -> (e, s)` overrides the strip
    solver (e.g. the device beam of `beam_chimera_cuda`).
    """
    from .core.problem import IsingProblem
    from .exact_chimera import solve_exact_chimera

    J = np.asarray(prob.J, np.float64)
    h = np.asarray(prob.h, np.float64)
    rows, cols = chimera_layout(J, rows, cols)
    s = np.asarray(s, np.float64).copy()
    e = float(prob.energy(s))
    n_moves = 0
    if stride is None:
        stride = max(1, window // 2)

    for _ in range(max_passes):
        improved = False
        for transpose in (False, True):
            if transpose:
                Jo, ho, perm, R, C = _orient(J, h, rows, cols, True, False)
                so = s[perm]
            else:
                Jo, ho, perm, R, C = (J, h, np.arange(J.shape[0]),
                                      rows, cols)
                so = s.copy()
            w = min(window, C)
            starts = list(range(0, C - w + 1, max(1, stride)))
            if starts[-1] != C - w:
                starts.append(C - w)
            for c0 in starts:
                cols_sel = np.concatenate(
                    [np.arange((r * C + c0) * 8, (r * C + c0 + w) * 8)
                     for r in range(R)])
                frozen = np.ones(Jo.shape[0], bool)
                frozen[cols_sel] = False
                h_eff = (ho[cols_sel]
                         + Jo[np.ix_(cols_sel, np.nonzero(frozen)[0])]
                         @ so[frozen])
                sub = IsingProblem(
                    Jo[np.ix_(cols_sel, cols_sel)].copy(), h_eff)
                if sub_solver is not None:
                    e_sub, s_sub = sub_solver(sub, R, w)
                elif w <= 4:
                    e_sub, s_sub = solve_exact_chimera(sub, rows=R, cols=w)
                else:
                    e_sub, s_sub, _ = solve_beam_chimera(
                        sub, rows=R, cols=w, beam=refine_beam)
                cur = float(sub.energy(so[cols_sel]))
                if e_sub < cur - 1e-9:
                    so[cols_sel] = s_sub
                    improved = True
                    n_moves += 1
            s_new = np.empty_like(so)
            s_new[perm] = so
            s = s_new
        e_new = float(prob.energy(s))
        assert e_new <= e + 1e-6, "strip refinement increased energy"
        e = e_new
        if not improved or (stop_at is not None and e <= stop_at):
            break
    return e, s, n_moves


def solve_chimera_pipeline(prob, rows: Optional[int] = None,
                           cols: Optional[int] = None,
                           beam: int = 1 << 16,
                           orientations: int = 1,
                           window: Optional[int] = None):
    """Beam contraction + exact strip refinement. Returns
    (energy, state, info); deterministic, host-only.

    window=None picks exact window-4 strips on grids up to width 8 and
    beam-solved window-8 strips (C8-scale sub-problems, the size the
    beam cracks outright) on wider grids."""
    e0, s, info = solve_beam_chimera_multi(prob, rows=rows, cols=cols,
                                           beam=beam,
                                           orientations=orientations)
    if info.get("exact"):
        return e0, s, dict(info, refined_from=e0, strip_moves=0)
    if window is None:
        window = 4 if np.asarray(prob.J).shape[0] <= 8 * 64 else 8
    e, s, n_moves = refine_strips(prob, s, rows=rows, cols=cols,
                                  window=window, refine_beam=beam)
    return e, s, dict(info, refined_from=e0, strip_moves=n_moves)


def _orient(J, h, rows, cols, transpose, reverse):
    """Relabel spins so a transposed/reversed raster is a plain raster.

    Returns (J2, h2, perm) with perm mapping new index -> old index.
    Transpose swaps the cell grid axes AND the V/H roles inside each
    cell (V couples vertically, H horizontally — the layout validator
    demands that convention). Reverse walks the grid from the far
    corner; V/H roles are preserved (couplings are symmetric).
    """
    n = J.shape[0]
    perm = np.empty(n, np.int64)
    new_rows, new_cols = (cols, rows) if transpose else (rows, cols)
    for nr in range(new_rows):
        for nc in range(new_cols):
            if transpose:
                r, c = nc, nr
            else:
                r, c = nr, nc
            if reverse:
                r, c = rows - 1 - r, cols - 1 - c
            ob = (r * cols + c) * 8
            nb = (nr * new_cols + nc) * 8
            if transpose:     # swap V and H halves
                perm[nb:nb + 4] = np.arange(ob + 4, ob + 8)
                perm[nb + 4:nb + 8] = np.arange(ob, ob + 4)
            else:
                perm[nb:nb + 8] = np.arange(ob, ob + 8)
    J2 = J[np.ix_(perm, perm)]
    h2 = h[perm]
    return J2, h2, perm, new_rows, new_cols


def solve_beam_chimera_multi(prob, rows: Optional[int] = None,
                             cols: Optional[int] = None,
                             beam: int = 1 << 18,
                             orientations: int = 4):
    """Best-of-orientations beam solve. Returns (energy, state, info).

    Runs the raster beam from up to 4 symmetry-equivalent orientations
    (identity, reversed, transposed, transposed+reversed) and keeps the
    lowest-energy result; stops early when an orientation proves
    exactness. `info["per_orientation"]` records each energy.
    """
    from .core.problem import IsingProblem

    J = np.asarray(prob.J, np.float64)
    h = np.asarray(prob.h, np.float64)
    rows, cols = chimera_layout(J, rows, cols)
    best = None
    record = []
    for k in range(max(1, min(4, orientations))):
        transpose, reverse = bool(k & 1), bool(k & 2)
        J2, h2, perm, nr, nc = _orient(J, h, rows, cols,
                                       transpose, reverse)
        p2 = IsingProblem(J2, h2)
        e, s2, info = solve_beam_chimera(p2, rows=nr, cols=nc, beam=beam)
        s = np.empty_like(s2)
        s[perm] = s2
        record.append({"transpose": transpose, "reverse": reverse,
                       "energy": e, "exact": info["exact"]})
        if best is None or e < best[0] - 1e-12:
            best = (e, s, info)
        if info["exact"]:
            break
    e, s, info = best
    info = dict(info, per_orientation=record)
    return e, s, info
