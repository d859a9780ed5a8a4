"""Benchmark-instance generators (host side, numpy).

Copies of ``random_sk``, ``ea_2d``, ``ea_3d``, ``wishart_planted``,
``contrived_wishart_backbone``, ``chimera_graph``,
``contrived_tree_adjacency``, ``contrived_wishart_backbone_reference`` and
``emit_contrived_ensemble`` from ``nmc_tpu/io/generators.py``: the same seed
gives a bit-equal J, which the tests check.
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


def ea_3d(L: int, seed: int = 0, pm: bool = False,
          periodic: bool = True) -> IsingProblem:
    """3D Edwards-Anderson glass on an L^3 (torus) lattice (16^3 config)."""
    rng = np.random.default_rng(seed)
    n = L ** 3
    J = np.zeros((n, n))

    def site(i, j, k):
        return ((i % L) * L + (j % L)) * L + (k % L)

    for i in range(L):
        for j in range(L):
            for k in range(L):
                for (di, dj, dk) in [(0, 0, 1), (0, 1, 0), (1, 0, 0)]:
                    ii, jj, kk = i + di, j + dj, k + dk
                    if not periodic and (ii >= L or jj >= L or kk >= L):
                        continue
                    a, b = site(i, j, k), site(ii, jj, kk)
                    w = float(rng.choice([-1.0, 1.0])) if pm else float(rng.normal())
                    J[a, b] = J[b, a] = w
    return IsingProblem(J, np.zeros(n), name=f"ea3d_{L}_seed{seed}")


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


def contrived_wishart_backbone(
    n_backbone: int, alpha: float = 0.2, seed: int = 0,
    tree_depth: int = 2, cross_links: int = 0, cross_scale: float = 0.1,
) -> Tuple[IsingProblem, np.ndarray, float]:
    """Planted dense Wishart core + binary trees per core spin + cross links.

    The dense core is a planted Wishart instance; ferromagnetic trees hang
    off each core spin; weak random cross links frustrate the periphery.
    Tree spins align with their parents, so the full planted state (and,
    without cross links, its energy) is returned for evaluation. The trees
    are what the leaf-peeling presolve (`ops/presolve.py`) removes.
    """
    rng = np.random.default_rng(seed)
    core, t_core, _ = wishart_planted(n_backbone, alpha, seed=seed + 1)

    per_tree = 2 ** (tree_depth + 1) - 2   # nodes added per backbone spin
    n = n_backbone + n_backbone * per_tree
    J = np.zeros((n, n))
    J[:n_backbone, :n_backbone] = core.J

    t = np.zeros(n)
    t[:n_backbone] = t_core
    next_idx = n_backbone
    for b in range(n_backbone):
        # breadth-first binary tree rooted at backbone spin b
        frontier = [b]
        for _ in range(tree_depth):
            new_frontier = []
            for parent in frontier:
                for _ in range(2):
                    child = next_idx
                    next_idx += 1
                    w = abs(rng.normal()) + 0.5  # ferromagnetic
                    J[parent, child] = J[child, parent] = w
                    t[child] = t[parent]
                    new_frontier.append(child)
            frontier = new_frontier

    tree_spins = np.arange(n_backbone, n)
    for _ in range(cross_links):
        a, b = rng.choice(tree_spins, size=2, replace=False)
        if J[a, b] == 0 and a != b:
            w = cross_scale * rng.normal()
            J[a, b] = J[b, a] = w

    prob = IsingProblem(J, np.zeros(n),
                        name=f"contrived_{n_backbone}_a{alpha}_s{seed}")
    if cross_links == 0:
        gs_energy = float(prob.energy(t))
    else:
        gs_energy = float("nan")  # cross links may shift the ground state
    return prob, t, gs_energy


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


def contrived_tree_adjacency(n_backbone: int, levels: int) -> np.ndarray:
    """0/1 adjacency of the reference's contrived topology: a complete
    n_backbone-node core plus a `levels`-deep binary tree rooted at each
    core node, nodes numbered per core node, level by level."""
    total = n_backbone * (2 ** (levels + 1) - 1)
    A = np.zeros((total, total))
    A[:n_backbone, :n_backbone] = 1.0 - np.eye(n_backbone)
    curr = n_backbone
    for i in range(n_backbone):
        queue = [i]
        for _ in range(levels):
            nxt = []
            for parent in queue:
                A[parent, curr] = A[curr, parent] = 1
                A[parent, curr + 1] = A[curr + 1, parent] = 1
                nxt.extend([curr, curr + 1])
                curr += 2
            queue = nxt
    return A


def contrived_wishart_backbone_reference(
    n_backbone: int = 50,
    levels: int = 2,
    alpha: float = 0.20,
    seed: int = 1346,
    *,
    core: Optional[IsingProblem] = None,
    max_h: float = 0.2,
    max_outside_weight: float = 1.0,
    max_backbone_weight: float = 10.0,
    num_cross_connections: int = 50,
    num_remove_edges: int = 0,
    remove_after_core: bool = False,
) -> IsingProblem:
    """Reference-faithful contrived instance pipeline (the reference's
    contrived_wishart_backbone/contrived_instance_generator.py:240-305):
    complete core + binary
    trees; tree and core->tree edges weighted uniform
    [-max_outside_weight, max_outside_weight]; the whole matrix
    symmetrized with an elementwise MAX (tree-tree edge weights are
    therefore max-of-two-uniforms — a positive-leaning reference quirk,
    assign_random_weights:93); `num_cross_connections` uniform-weight
    links between random NON-core nodes (any tree to any tree,
    add_cross_connections:96-131); optional random core edge removal
    (remove_random_backbone_edges:133-161) — note the reference removes
    BEFORE overwriting the core block with the scaled Wishart instance,
    so removed core edges are reinstated (quirk preserved;
    remove_after_core=True applies the removal last instead); core block
    overwritten with max_backbone_weight * J_core / max|J_core| (main:297);
    h uniform in +-(2 * max_h * max_backbone_weight) on every node
    (main:298).

    `core`: a planted Wishart problem in loader convention (J = true
    couplings); generated via wishart_planted(n_backbone, alpha) when None
    — the reference loads the same construction from its shipped
    wishart_planting_N_*_alpha_* files.
    """
    rng = np.random.default_rng(seed)
    A = contrived_tree_adjacency(n_backbone, levels)
    total = A.shape[0]
    nb = n_backbone

    J = np.zeros_like(A)
    # core block: parity-signed uniform magnitudes (overwritten below, but
    # kept so the edge-removal quirk operates on the same matrix state)
    for i in range(nb):
        for j in range(i + 1, nb):
            w = rng.uniform(-max_backbone_weight, max_backbone_weight)
            w = -abs(w) if (i + j) % 2 == 0 else abs(w)
            J[i, j] = J[j, i] = w
    # core -> tree: symmetric uniform [-max_outside, max_outside]
    rw = rng.uniform(-max_outside_weight, max_outside_weight,
                     (nb, total - nb)) * A[:nb, nb:]
    J[:nb, nb:] = rw
    J[nb:, :nb] = rw.T
    # tree -> tree: independent draws per direction, then elementwise-max
    # symmetrization (the reference's np.maximum(adj, adj.T) quirk)
    J[nb:, nb:] = rng.uniform(-max_outside_weight, max_outside_weight,
                              (total - nb, total - nb)) * A[nb:, nb:]
    J = np.maximum(J, J.T)

    # cross connections between random non-core nodes
    links = set()
    while len(links) < num_cross_connections:
        a = int(rng.integers(nb, total))
        b = int(rng.integers(nb, total))
        if a != b and (a, b) not in links and (b, a) not in links:
            w = rng.uniform(-max_outside_weight, max_outside_weight)
            J[a, b] = J[b, a] = w
            links.add((a, b))

    def _remove(Jm):
        removed = set()
        while len(removed) < num_remove_edges:
            a = int(rng.integers(0, nb))
            b = int(rng.integers(0, nb))
            if a != b and Jm[a, b] != 0 and (a, b) not in removed \
                    and (b, a) not in removed:
                Jm[a, b] = Jm[b, a] = 0.0
                removed.add((a, b))
        return Jm

    if num_remove_edges and not remove_after_core:
        J = _remove(J)

    if core is None:
        core = wishart_planted(nb, alpha, seed=seed + 7)[0]
    Jc = np.asarray(core.J, dtype=float)
    J[:nb, :nb] = max_backbone_weight * Jc / np.max(np.abs(Jc))

    if num_remove_edges and remove_after_core:
        J = _remove(J)

    h = (rng.random(total) - 0.5) * 2 * max_h * max_backbone_weight
    return IsingProblem(
        J, h, name=f"contrived_ref_N{nb}_a{alpha:.2f}_s{seed}")


def emit_contrived_ensemble(
    out_dir: str, instances: int, base_seed: int = 1345, *,
    n_backbone: int = 50, levels: int = 2, alpha: float = 0.20,
    cores_folder: Optional[str] = None, **kwargs,
) -> list:
    """Write an instance ensemble with the reference's directory/file
    naming (contrived_instance_generator.py:255-305):
    <out_dir>/wishart_planting_N_{n}_alpha_{a:.2f}_contrived_tree/
    ..._inst_{i}_contrived_tree.txt. When `cores_folder` points at a
    shipped wishart_planting_N_*_alpha_* folder, instance i's core is
    loaded from its inst_{i} file, exactly like the reference's main().
    Returns the written paths."""
    import os

    from .loaders import load_wishart
    from .writers import save_edgelist

    sub = os.path.join(
        out_dir, f"wishart_planting_N_{n_backbone}_alpha_{alpha:.2f}"
                 f"_contrived_tree")
    os.makedirs(sub, exist_ok=True)
    paths = []
    for inst in range(1, instances + 1):
        core = None
        if cores_folder is not None:
            fname = (f"wishart_planting_N_{n_backbone}_alpha_{alpha:.2f}"
                     f"_inst_{inst}.txt")
            core = load_wishart(os.path.join(cores_folder, fname))
        prob = contrived_wishart_backbone_reference(
            n_backbone, levels, alpha, seed=base_seed + inst, core=core,
            **kwargs)
        path = os.path.join(
            sub, f"wishart_planting_N_{n_backbone}_alpha_{alpha:.2f}"
                 f"_inst_{inst}_contrived_tree.txt")
        save_edgelist(path, prob)
        paths.append(path)
    return paths
