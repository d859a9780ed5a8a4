"""Colouring and blocked layout of an instance family, worked out from J.

The spin order the program sweeps in is part of what a run computes: a
spin's draw is keyed by its blocked index, and a colour class is updated
at once. So the reference derives the same order from the same couplings:
the greedy colouring (largest degree first, smallest free colour) of the
union graph, each colour class padded to whole blocks, or one class of all
spins when the layout is uncoloured.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


def greedy_coloring(J: np.ndarray) -> np.ndarray:
    """Colours [N] of J's graph: vertices by degree, highest first (stable),
    each taking the smallest colour none of its coloured neighbours has."""
    N = J.shape[0]
    adj = [np.flatnonzero(J[i]) for i in range(N)]
    degree = np.array([len(a) for a in adj])
    colors = np.full(N, -1, dtype=np.int32)
    for v in np.argsort(-degree, kind="stable"):
        used = {colors[u] for u in adj[v] if colors[u] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    return colors


def color_groups(J: np.ndarray) -> List[np.ndarray]:
    colors = greedy_coloring(J)
    return [np.flatnonzero(colors == c) for c in range(int(colors.max()) + 1)]


@dataclasses.dataclass
class Layout:
    perm: np.ndarray      # [n_pad] original spin of each slot, -1 on padding
    inv_perm: np.ndarray  # [n] slot of each original spin
    active: np.ndarray    # [n_pad] bool
    n: int
    block_size: int

    @property
    def n_pad(self) -> int:
        return self.perm.shape[0]

    @property
    def num_blocks(self) -> int:
        return self.n_pad // self.block_size


def block_layout(n: int, block_size: int,
                 groups: Optional[List[np.ndarray]] = None) -> Layout:
    """Each group (all spins when None) in order, padded to a multiple of
    the block size (at least one block)."""
    groups = [np.arange(n)] if groups is None else groups
    slots = []
    for g in groups:
        pad = -(-max(len(g), block_size) // block_size) * block_size
        slots += list(g) + [-1] * (pad - len(g))
    perm = np.asarray(slots, dtype=np.int64)
    active = perm >= 0
    inv_perm = np.zeros(n, dtype=np.int64)
    inv_perm[perm[active]] = np.flatnonzero(active)
    return Layout(perm, inv_perm, active, n, block_size)


def family_layout(J: np.ndarray, block_size: int, coloring: bool) -> Layout:
    """The layout of a family J [I, n, n]: coloured on the union of its
    coupling graphs (valid for every member), or uncoloured."""
    n = J.shape[-1]
    groups = color_groups(np.abs(J).sum(0)) if coloring else None
    return block_layout(n, block_size, groups)


def to_blocked(J: np.ndarray, h: np.ndarray, lay: Layout, dtype=np.float32):
    """(J [I, n_pad, n_pad], h [I, n_pad]) in the layout's order, zero on
    padding."""
    I = J.shape[0]
    src = lay.perm[lay.active]
    dst = np.flatnonzero(lay.active)
    Jb = np.zeros((I, lay.n_pad, lay.n_pad), dtype=dtype)
    Jb[:, dst[:, None], dst[None, :]] = J[:, src[:, None], src[None, :]]
    hb = np.zeros((I, lay.n_pad), dtype=dtype)
    hb[:, dst] = h[:, src]
    return Jb, hb
