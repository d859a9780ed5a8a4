"""Benchmark-instance generators (host side, numpy).

Copies of ``random_sk``, ``ea_2d``, ``wishart_planted`` and
``chimera_graph`` from ``nmc_tpu/io/generators.py``: the same seed gives a
bit-equal J, which the tests check.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core.problem import IsingProblem


def random_sk(n: int, seed: int = 0, h_scale: float = 0.0) -> IsingProblem:
    """Sherrington-Kirkpatrick: dense J ~ N(0,1)/sqrt(n), optional fields."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(n, n)) / np.sqrt(n)
    J = 0.5 * (J + J.T)
    np.fill_diagonal(J, 0.0)
    h = h_scale * rng.normal(size=n)
    return IsingProblem(J, h, name=f"sk_{n}_seed{seed}")


def ea_2d(L: int, seed: int = 0, pm: bool = True,
          periodic: bool = True) -> IsingProblem:
    """2D Edwards-Anderson glass on an L x L (torus) lattice.

    pm=True draws J in {-1,+1}; otherwise Gaussian.
    """
    rng = np.random.default_rng(seed)
    n = L * L
    J = np.zeros((n, n))

    def site(i, j):
        return (i % L) * L + (j % L)

    for i in range(L):
        for j in range(L):
            for (di, dj) in [(0, 1), (1, 0)]:
                ii, jj = i + di, j + dj
                if not periodic and (ii >= L or jj >= L):
                    continue
                a, b = site(i, j), site(ii, jj)
                w = float(rng.choice([-1.0, 1.0])) if pm else float(rng.normal())
                J[a, b] = J[b, a] = w
    return IsingProblem(J, np.zeros(n), name=f"ea2d_{L}_seed{seed}")


def wishart_planted(n: int, alpha: float, seed: int = 0,
                    planted: Optional[np.ndarray] = None
                    ) -> Tuple[IsingProblem, np.ndarray, float]:
    """Wishart planted ensemble (Hamze et al.): t is a ground state of
    E(m) = -(m^T J m)/2 by construction.

    Draw W [n, M] Gaussian with columns projected orthogonal to the planted
    state t (M = round(alpha * n)); set J~ = -W W^T / n with zero diagonal.
    Then m^T J~ m = -|W^T m|^2 / n + const, maximized (energy minimized)
    exactly at m = +-t. Returns (problem, t, gs_energy).
    """
    rng = np.random.default_rng(seed)
    if planted is None:
        t = np.ones(n)
    else:
        t = np.asarray(planted, dtype=np.float64).reshape(n)
    M = max(int(round(alpha * n)), 1)
    W = rng.normal(size=(n, M))
    W -= np.outer(t, t @ W) / (t @ t)   # columns orthogonal to t
    Jt = -(W @ W.T) / n
    np.fill_diagonal(Jt, 0.0)
    prob = IsingProblem(Jt, np.zeros(n), name=f"wishart_{n}_a{alpha}_s{seed}")
    return prob, t, float(prob.energy(t))


def chimera_graph(m: int, n: Optional[int] = None, t: int = 4,
                  seed: int = 0, pm: bool = True) -> IsingProblem:
    """Chimera topology C_{m,n,t}: an m x n grid of K_{t,t} bipartite cells
    with horizontal/vertical inter-cell couplings (N = 2*t*m*n). pm=True
    draws +-J couplings, else Gaussian. C_{8,8,4} is the N = 512 family
    the sweep benchmark runs on.
    """
    rng = np.random.default_rng(seed)
    if n is None:
        n = m
    N = 2 * t * m * n

    def left(i, j, k):   # 'left' partition spin k of cell (i, j)
        return ((i * n + j) * 2) * t + k

    def right(i, j, k):
        return ((i * n + j) * 2 + 1) * t + k

    J = np.zeros((N, N))

    def draw():
        return float(rng.choice([-1.0, 1.0])) if pm else float(rng.normal())

    for i in range(m):
        for j in range(n):
            for a in range(t):          # intra-cell bipartite K_{t,t}
                for b in range(t):
                    w = draw()
                    J[left(i, j, a), right(i, j, b)] = w
                    J[right(i, j, b), left(i, j, a)] = w
            if i + 1 < m:               # vertical: left partitions couple
                for k in range(t):
                    w = draw()
                    J[left(i, j, k), left(i + 1, j, k)] = w
                    J[left(i + 1, j, k), left(i, j, k)] = w
            if j + 1 < n:               # horizontal: right partitions couple
                for k in range(t):
                    w = draw()
                    J[right(i, j, k), right(i, j + 1, k)] = w
                    J[right(i, j + 1, k), right(i, j, k)] = w
    return IsingProblem(J, np.zeros(N), name=f"chimera_{m}x{n}x{t}_s{seed}")
