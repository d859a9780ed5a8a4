"""The device beam tier for chimera graphs (exact integer min-plus DP).

The counterpart of ``nmc_tpu/beam_chimera_tpu.py``: a loop over cells on
one torch device; each step expands the kept boundary states by the 256
(V, H) configurations of the next cell, dedups identical boundary keys by a
lexicographic stable sort (exact min-plus dominance), and keeps the best
`beam` states with a second stable sort. Parent pointers and combos are
kept per cell; the spin state is backtracked on the host.

The JAX program is not a Pallas kernel but XLA's `lax.sort`, gathers and
adds, so this port is torch ops too: `torch.sort(stable=True)` stands for
`lax.sort`. `lax.sort(ops, num_keys=k)` orders lexicographically over the
uint32 key words (word 0 most significant), then the int32 energy, and is
stable; a chain of stable sorts from the least significant field to the
most gives the same order, ties included, so the kept states, their
parents and their combos are array-equal to the JAX runner's at every
split. Two 32-bit fields are packed into one int64 key per sort (torch has
no sortable uint32): chimera 16x16's three key words and the energy take
two sorts, a grid of width <= 7 one.

Exactness of arithmetic: `quantize_problem` snaps J, h to integer multiples
of 1/q, so every partial energy is an exact int32 (`_INF = 2^30` marks
empty slots, and lineages that start from it carry `_INF + sum(delta)`,
wrapping as int32 does in XLA). The returned energy is re-evaluated on the
host in f64 from the backtracked state against the original problem.

Complexity per cell: the expansion is beam * 256 elements, sorted two or
three times; everything else is gathers and adds. `split` cuts the 256
combos into chunks so that no sort exceeds 2^24 elements (the JAX rule,
kept so that `info["split"]` and every kept state match JAX's).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from .exact_chimera import _S16, chimera_layout

__all__ = ["auto_split", "quantize_problem", "run_beam",
           "solve_beam_chimera_cuda"]

_INF = 1 << 30
_HALF = 1 << 31            # unsigned 32-bit value -> signed offset


def quantize_problem(prob, q_max: int = 10000):
    """Smallest q <= q_max with J*q, h*q integral (within print rounding).

    Returns (Jq, hq, q) int64 arrays. Raises ValueError when no such q
    exists (the shipped chimera/DCL instances all qualify; q = 75 for the
    droplet families).
    """
    J = np.asarray(prob.J, np.float64)
    h = np.asarray(prob.h, np.float64)
    vals = np.concatenate([J[np.nonzero(J)], h[np.nonzero(h)]])
    if vals.size == 0:
        return J.astype(np.int64), h.astype(np.int64), 1
    for q in range(1, q_max + 1):
        vq = vals * q
        # the files print 6 decimals; |rounding error| * q stays < ~q*5e-7
        if np.all(np.abs(vq - np.round(vq)) < max(1e-4, q * 2e-5)):
            return (np.round(J * q).astype(np.int64),
                    np.round(h * q).astype(np.int64), q)
    raise ValueError(f"couplings are not multiples of 1/q for q <= {q_max}")


def _int_cell_tables(Jq, hq, rows, W):
    """[cells, 256, 256] int32 transition tables: delta energy of cell
    (r, c) at (combo=V*16+H) given (ridx=V_up*16+H_left), in 1/q units."""
    S = _S16.astype(np.int64)
    cells = rows * W
    out = np.empty((cells, 256, 256), np.int64)

    def base(r, c):
        return (r * W + c) * 8

    for r in range(rows):
        for c in range(W):
            b = base(r, c)
            f = -(S @ Jq[b:b + 4, b + 4:b + 8] @ S.T)
            f -= (S @ hq[b:b + 4])[:, None]
            f -= (S @ hq[b + 4:b + 8])[None, :]
            if r > 0:
                ju = np.diag(Jq[base(r - 1, c):base(r - 1, c) + 4,
                                b:b + 4]).copy()
                u = -(S * ju) @ S.T
            else:
                u = np.zeros((16, 16), np.int64)
            if c > 0:
                jg = np.diag(Jq[base(r, c - 1) + 4:base(r, c - 1) + 8,
                                b + 4:b + 8]).copy()
                g = -(S * jg) @ S.T
            else:
                g = np.zeros((16, 16), np.int64)
            out[r * W + c] = (u[:, None, :, None] + g[None, :, None, :]
                              + f[None, None, :, :]).reshape(256, 256)
    assert np.abs(out).max() < 1 << 24, "cell deltas overflow the int32 DP"
    return out.astype(np.int32)


def _pack_words(groups, G):
    """[M, G] nibbles -> list of [M] int64 words (unsigned 32-bit values),
    8 nibbles a word, nibble j of word w at bits 4 * (j - 8w)."""
    shifts = 4 * torch.arange(8, dtype=torch.int64, device=groups.device)
    return [(groups[:, w * 8:min(G, w * 8 + 8)]
             << shifts[:min(G, w * 8 + 8) - w * 8]).sum(1)
            for w in range((G + 7) // 8)]


def _lex_order(fields):
    """The stable lexicographic order of unsigned 32-bit fields held in
    int64 (most significant first): `lax.sort` over them as keys. Two
    fields are packed into one int64 key (the high one offset by 2^31 so
    that signed order is unsigned order); one stable sort per key, from the
    least significant key up."""
    keys = [fields[i] if i + 1 == len(fields)
            else (fields[i] - _HALF) * (1 << 32) + fields[i + 1]
            for i in range(0, len(fields), 2)]
    perm = None
    for key in reversed(keys):
        p = torch.sort(key if perm is None else key[perm],
                       stable=True).indices
        perm = p if perm is None else perm[p]
    return perm


def _dedup_top(kws, E, idx, M):
    """Sort the expansions by (key words, energy), keep the first
    (lowest-energy) entry of every key, and return the best M by energy
    (stable: ties keep key order) as (E, key words, idx)."""
    order = _lex_order(kws + [E.long() + _HALF])
    kws = [kw[order] for kw in kws]
    E_s, idx_s = E[order], idx[order]
    diff = torch.zeros(E_s.numel() - 1, dtype=torch.bool, device=E.device)
    for kw in kws:
        diff |= kw[1:] != kw[:-1]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=E.device),
                       diff])
    E_d = torch.where(first, E_s, torch.full_like(E_s, _INF))
    keep = torch.sort(E_d, stable=True).indices[:M]
    return E_d[keep], [kw[keep] for kw in kws], idx_s[keep]


def _step(groups, E, trans, c, zero_v, zero_h, split):
    """One beam-contraction step (`_build_step` of the JAX module): the
    single-pass variant at `split=1`; at `split=2^k` the 256 combos in
    `split` chunks, each deduped and cut to its best M, then a
    cross-chunk dedup and top-M of the split*M survivors. Returns the new
    (groups, E) and the kept (parents, combos)."""
    M, G = groups.shape
    dev = groups.device
    C = 256 // split
    delta = trans[groups[:, c] * 16 + groups[:, G - 1]]      # [M, 256]
    cleared = groups.clone()
    cleared[:, c] = 0
    cleared[:, G - 1] = 0
    words = _pack_words(cleared, G)
    parent_base = torch.arange(M, dtype=torch.int32,
                               device=dev)[:, None] * 256

    chunks = []
    for off in range(0, 256, C):
        combo = torch.arange(off, off + C, dtype=torch.int64, device=dev)
        E_exp = (E[:, None] + delta[:, off:off + C]).reshape(-1)
        exp_words = []
        for w, kw in enumerate(words):
            add = torch.zeros_like(combo)
            if c // 8 == w and not zero_v:
                add |= (combo >> 4) << (4 * (c % 8))
            if (G - 1) // 8 == w and not zero_h:
                add |= (combo & 15) << (4 * ((G - 1) % 8))
            exp_words.append((kw[:, None] | add[None, :]).reshape(-1))
        # the global expansion index parent*256 + combo: ties break the
        # same way at every split
        idx = (parent_base + combo.to(torch.int32)[None, :]).reshape(-1)
        chunks.append(_dedup_top(exp_words, E_exp, idx, M))
    if split == 1:
        E_new, _, keep = chunks[0]
    else:
        E_new, _, keep = _dedup_top(
            [torch.cat([ch[1][w] for ch in chunks])
             for w in range(len(words))],
            torch.cat([ch[0] for ch in chunks]),
            torch.cat([ch[2] for ch in chunks]), M)
    parents, combos = keep // 256, keep % 256
    g_new = groups[parents.long()]
    g_new[:, c] = 0 if zero_v else (combos >> 4).long()
    g_new[:, G - 1] = 0 if zero_h else (combos & 15).long()
    return g_new, E_new, parents, combos.to(torch.uint8)


def run_beam(trans: torch.Tensor, rows: int, W: int, M: int,
             split: int = 1):
    """The beam DP over the `rows x W` cells of `trans` ([cells, 256, 256]
    int32, on the device it runs on): the JAX runner `_get_runner(M,
    W + 1, W, split)` as a plain loop. Returns (E_fin [M] int32, parents
    [cells, M] int32, combos [cells, M] uint8), array-equal to JAX's."""
    assert 256 % split == 0
    dev = trans.device
    cells = rows * W
    groups = torch.zeros((M, W + 1), dtype=torch.int64, device=dev)
    E = torch.full((M,), _INF, dtype=torch.int32, device=dev)
    E[0] = 0
    parents = torch.empty((cells, M), dtype=torch.int32, device=dev)
    combos = torch.empty((cells, M), dtype=torch.uint8, device=dev)
    for cell in range(cells):
        r, c = divmod(cell, W)
        groups, E, parents[cell], combos[cell] = _step(
            groups, E, trans[cell], c, r == rows - 1, c == W - 1, split)
    return E, parents, combos


def auto_split(M: int) -> int:
    """The JAX rule: chunk the expansion so that no sort exceeds 2^24
    elements."""
    split = 1
    while M * (256 // split) > (1 << 24):
        split *= 2
    return split


def solve_beam_chimera_cuda(prob, rows: Optional[int] = None,
                            cols: Optional[int] = None,
                            beam: int = 1 << 17,
                            q_max: int = 10000,
                            verify: bool = True,
                            split: Optional[int] = None,
                            device=None):
    """Device beam solve (`solve_beam_chimera_tpu`'s counterpart). Returns
    (energy_f64, state, info) with info {"beam", "q", "e_int", "split"}.

    Runs on `device` (default: the CUDA card; raises without one).
    `split=None` (auto) chunks the per-cell expansion so that no sort
    exceeds 2^24 elements (split 2 at beam 2^17).
    """
    dev = resolve_device(device)
    J = np.asarray(prob.J, np.float64)
    h = np.asarray(prob.h, np.float64)
    rows, cols = chimera_layout(J, rows, cols)
    W, M = cols, int(beam)
    Jq, hq, q = quantize_problem(prob, q_max)
    trans = _int_cell_tables(Jq, hq, rows, W)     # [cells, 256, 256]
    cells = rows * W
    if split is None:
        split = auto_split(M)
    E_fin, parents, combos = run_beam(
        torch.from_numpy(trans).to(dev), rows, W, M, split)
    E_fin = E_fin.cpu().numpy()
    parents = parents.cpu().numpy()               # [cells, M]
    combos = combos.cpu().numpy()

    idx = int(np.argmin(E_fin))
    e_q = int(E_fin[idx])
    s = np.empty(J.shape[0], np.float64)
    for cell in range(cells - 1, -1, -1):
        cmb = int(combos[cell, idx])
        b = cell * 8
        s[b:b + 4] = _S16[cmb >> 4]
        s[b + 4:b + 8] = _S16[cmb & 15]
        idx = int(parents[cell, idx])
    e = float(prob.energy(s))
    if verify:
        # the DP optimizes the SNAPPED couplings; |E_file(s) - E_snap(s)|
        # is bounded exactly by the total snap residual (|s_i s_j| = 1)
        snap = (float(np.abs(J - Jq / q).sum()) / 2.0
                + float(np.abs(h - hq / q).sum()))
        assert abs(e - e_q / q) <= snap + 1e-6 * max(1.0, abs(e)), \
            f"device DP/backtrack mismatch: {e_q / q} vs {e}"
    return e, s, {"beam": M, "q": q, "e_int": e_q, "split": split}
