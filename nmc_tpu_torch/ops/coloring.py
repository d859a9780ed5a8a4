"""Greedy graph coloring for parallel (colored-block) Gibbs sweeps.

A copy of ``nmc_tpu/ops/coloring.py`` (numpy only); tests hold it equal to
the original, since n_pad and the spin permutation depend on the groups.

Spins of one color have no mutual couplings, so updating a whole color
class at once from cached local fields is EXACT heat-bath Gibbs. The
coloring is a one-time host-side preprocessing step; core/problem.block_problem
consumes the classes as `groups`, padding each to a whole block so no block
mixes colors.
"""

from __future__ import annotations

from typing import List

import numpy as np


def greedy_coloring(J: np.ndarray) -> np.ndarray:
    """Color the adjacency graph of J greedily (largest-degree-first).

    Returns colors [N] int32. Bipartite lattices (Chimera cells, 2D/3D EA
    grids) 2-color; dense graphs degrade to ~N colors — use the sequential
    engine there instead.
    """
    N = J.shape[0]
    adj = [np.flatnonzero(J[i]) for i in range(N)]
    degree = np.array([len(a) for a in adj])
    order = np.argsort(-degree, kind="stable")
    colors = np.full(N, -1, dtype=np.int32)
    for v in order:
        used = {colors[u] for u in adj[v] if colors[u] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    return colors


def color_groups(J: np.ndarray) -> List[np.ndarray]:
    """Partition spins into independent sets (inputs to block_problem)."""
    J = np.asarray(J.toarray() if hasattr(J, "toarray") else J)
    colors = greedy_coloring(J)
    return [np.flatnonzero(colors == c) for c in range(int(colors.max()) + 1)]


def num_colors(J: np.ndarray) -> int:
    return int(greedy_coloring(np.asarray(J)).max()) + 1
