"""Exact presolve for tree-decorated Ising instances: iterative leaf
(degree <= 1) elimination with field folding, plus back-substitution.

A copy of ``nmc_tpu/ops/presolve.py`` (host numpy, f64), held array-equal
to it by the tests. Eliminating a leaf i attached to j is exact:

    min_{s_i} [ -J_ij s_i s_j - h_i s_i ]  =  -|J_ij s_j + h_i|
                                           =  a + b s_j,
    a = -(|J_ij + h_i| + |J_ij - h_i|) / 2,
    b =  (|J_ij - h_i| - |J_ij + h_i|) / 2,

so the leaf folds into the neighbour's field (h_j <- h_j - b) and a
constant. Isolated spins contribute -|h_i| with s_i = sign(h_i). A pure
tree (or forest) presolves to nothing, the exact ground state, in O(n)
eliminations; a decorated instance presolves to its 2-core, where the
spectral search and the MCMC engines run on fewer spins.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Presolve:
    """Result of `peel_leaves`.

    core:     indices (into the original problem) of the 2-core spins
    J_core:   [k, k] couplings restricted to the core
    h_core:   [k] fields on the core, with all folded leaf terms
    constant: energy contributed by eliminated spins (added to any core
              energy to give the original-instance energy)
    order:    peel sequence, innermost last: (spin, parent, J_ij, h_i);
              parent = -1 for isolated spins
    n:        original instance size
    """
    core: np.ndarray
    J_core: np.ndarray
    h_core: np.ndarray
    constant: float
    order: List[Tuple[int, int, float, float]]
    n: int

    def back_substitute(self, s_core: np.ndarray) -> np.ndarray:
        """Expand a +-1 core state [k] to the full instance [n], choosing
        each eliminated spin's exact conditional optimum (ties -> +1)."""
        s = np.zeros(self.n, dtype=np.float64)
        s[self.core] = np.asarray(s_core, dtype=np.float64)
        for i, j, Jij, hi in reversed(self.order):
            field = hi if j < 0 else Jij * s[j] + hi
            s[i] = 1.0 if field >= 0 else -1.0
        return s

    def energy(self, s_full: np.ndarray, J: np.ndarray,
               h: Optional[np.ndarray] = None) -> float:
        """Exact f64 energy of a full state on the ORIGINAL instance."""
        s = np.asarray(s_full, dtype=np.float64)
        e = -0.5 * s @ (np.asarray(J, np.float64) @ s)
        if h is not None:
            e -= np.asarray(h, np.float64) @ s
        return float(e)


def peel_leaves(J: np.ndarray, h: Optional[np.ndarray] = None) -> Presolve:
    """Iteratively eliminate degree <= 1 spins from (J, h), exactly.

    Returns a `Presolve` whose core is the 2-core of the coupling graph.
    For forests the core is empty and `back_substitute(np.zeros(0))`
    yields an exact ground state."""
    J = np.asarray(J, dtype=np.float64)
    n = J.shape[0]
    h_work = (np.zeros(n) if h is None
              else np.asarray(h, dtype=np.float64).copy())
    # adjacency as sets for O(deg) updates
    nbrs = [set(np.flatnonzero(J[i]).tolist()) - {i} for i in range(n)]
    alive = np.ones(n, dtype=bool)
    order: List[Tuple[int, int, float, float]] = []
    constant = 0.0
    stack = [i for i in range(n) if len(nbrs[i]) <= 1]
    while stack:
        i = stack.pop()
        if not alive[i] or len(nbrs[i]) > 1:
            continue
        alive[i] = False
        hi = float(h_work[i])
        if not nbrs[i]:                       # isolated
            constant -= abs(hi)
            order.append((i, -1, 0.0, hi))
            continue
        (j,) = nbrs[i]
        Jij = float(J[i, j])
        a = -(abs(Jij + hi) + abs(Jij - hi)) / 2.0
        b = (abs(Jij - hi) - abs(Jij + hi)) / 2.0
        constant += a
        h_work[j] -= b
        order.append((i, j, Jij, hi))
        nbrs[j].discard(i)
        nbrs[i].clear()
        if len(nbrs[j]) <= 1 and alive[j]:
            stack.append(j)
    core = np.flatnonzero(alive)
    return Presolve(core=core, J_core=J[np.ix_(core, core)],
                    h_core=h_work[core], constant=constant,
                    order=order, n=n)
