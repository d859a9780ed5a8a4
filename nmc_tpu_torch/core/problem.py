"""Ising problem representation (host side, numpy).

A copy of ``nmc_tpu/core/problem.py``. The JAX package imports ``jax`` at
package import (``nmc_tpu/__init__.py``), so this module cannot be imported
from there on a machine without JAX; tests hold the copy array-equal to the
original.

The model everywhere is the Ising Hamiltonian

    E(m) = -(m^T J m / 2 + m^T h),   m in {-1,+1}^N

with J symmetric and zero-diagonal. `IsingProblem` is the host container;
`BlockedProblem` is the layout the sweep engine consumes: spins permuted by
a graph coloring, padded to whole blocks, J tiled into row blocks so the
cached local fields phi = J@m + h update with one product per spin block.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


@dataclasses.dataclass
class IsingProblem:
    """Host-side Ising instance: dense symmetric zero-diagonal J and fields h."""

    J: np.ndarray  # [N, N] float, symmetric, zero diagonal
    h: np.ndarray  # [N]
    name: str = "ising"

    def __post_init__(self):
        self.J = np.asarray(self.J)
        if hasattr(self.J, "toarray"):  # accept scipy sparse
            self.J = self.J.toarray()
        self.J = np.array(self.J, dtype=np.float64, copy=True)
        self.h = np.asarray(self.h, dtype=np.float64).reshape(-1)
        n = self.J.shape[0]
        if self.J.shape != (n, n):
            raise ValueError(f"J must be square, got {self.J.shape}")
        if self.h.shape[0] != n:
            raise ValueError(f"h has {self.h.shape[0]} entries for {n} spins")

    @property
    def n(self) -> int:
        return self.J.shape[0]

    @property
    def num_edges(self) -> int:
        return int(np.count_nonzero(np.triu(self.J, 1)))

    def symmetrized(self) -> "IsingProblem":
        """Return a copy with J forced symmetric and zero diagonal."""
        J = 0.5 * (self.J + self.J.T)
        np.fill_diagonal(J, 0.0)
        return IsingProblem(J, self.h.copy(), name=self.name)

    def normalized(self) -> tuple["IsingProblem", float]:
        """Scale J and h so max|J| == 1. Returns (problem, norm_factor)."""
        norm = float(np.max(np.abs(self.J)))
        if norm == 0.0:
            norm = 1.0
        return IsingProblem(self.J / norm, self.h / norm, name=self.name), norm

    def energy(self, m: np.ndarray) -> np.ndarray:
        """E(m) for one state [N] or a batch [..., N] (host/numpy)."""
        m = np.asarray(m, dtype=np.float64)
        Jm = m @ self.J  # [..., N]
        return -(0.5 * np.sum(m * Jm, axis=-1) + m @ self.h)

    def min_abs_nonzero_J(self) -> float:
        nz = np.abs(self.J[self.J != 0])
        return float(nz.min()) if nz.size else 0.0


@dataclasses.dataclass
class BlockedProblem:
    """Blocked layout of an Ising instance for the sweep engine.

    Spins (optionally permuted by a graph coloring) are padded to `n_pad`, a
    multiple of `block_size`. Stored per block b:
      - J_rows[b]  = J[b*B:(b+1)*B, :]        (for the phi += dm @ J_rows update)
      - J_diag[b]  = J[b*B:(b+1)*B, b*B:(b+1)*B]  (for exact within-block scans)
    `perm` maps blocked/padded index -> original spin index (or -1 for padding);
    `active` marks real (non-padding) spins. If built from a coloring, every
    block holds spins of a single color, so J_diag[b] == 0 and the all-at-once
    within-block update is exact Gibbs.
    """

    J_rows: np.ndarray    # [nB, B, n_pad] float32/float64
    J_diag: np.ndarray    # [nB, B, B]
    h: np.ndarray         # [n_pad]
    active: np.ndarray    # [n_pad] bool, False on padding
    perm: np.ndarray      # [n_pad] int32, original index or -1
    inv_perm: np.ndarray  # [n] int32, original -> blocked index
    n: int                # true number of spins
    block_size: int
    colored: bool = False  # True if blocks are independent sets

    @property
    def n_pad(self) -> int:
        return self.h.shape[0]

    @property
    def num_blocks(self) -> int:
        return self.J_rows.shape[0]

    def to_blocked(self, x: np.ndarray, fill=0.0) -> np.ndarray:
        """Scatter per-spin data [..., n] into blocked layout [..., n_pad]."""
        x = np.asarray(x)
        out = np.full(x.shape[:-1] + (self.n_pad,), fill, dtype=x.dtype)
        out[..., self.inv_perm] = x
        return out

    def from_blocked(self, x: np.ndarray) -> np.ndarray:
        """Gather blocked data [..., n_pad] back to original order [..., n]."""
        return np.asarray(x)[..., self.inv_perm]


def block_problem(
    problem: IsingProblem,
    block_size: int = 128,
    groups: Optional[Sequence[np.ndarray]] = None,
    dtype=np.float32,
) -> BlockedProblem:
    """Tile an IsingProblem for the sweep engine.

    `groups`: optional partition of spin indices (e.g. color classes from
    ops/coloring.py). Each group is padded independently to a multiple of
    block_size so no block straddles two groups; if every group is an
    independent set the result is flagged `colored` (all J_diag == 0) and
    the all-at-once within-block update is exact Gibbs.
    Without groups: one group of all spins (dense layout, trailing pad).
    """
    n = problem.n
    if groups is None:
        groups = [np.arange(n)]
    groups = [np.asarray(g, dtype=np.int64) for g in groups]
    flat = np.concatenate(groups) if groups else np.array([], np.int64)
    if sorted(flat.tolist()) != list(range(n)):
        raise ValueError("groups must partition range(n)")

    # Build padded layout: each group padded to a multiple of block_size.
    slots = []  # original index or -1 per padded slot
    for g in groups:
        gp = _round_up(max(len(g), block_size), block_size)
        slots.extend(g.tolist())
        slots.extend([-1] * (gp - len(g)))
    perm = np.asarray(slots, dtype=np.int32)
    n_pad = perm.shape[0]
    nb = n_pad // block_size

    active = perm >= 0
    inv_perm = np.zeros(n, dtype=np.int32)
    inv_perm[perm[active]] = np.flatnonzero(active).astype(np.int32)

    Jp = np.zeros((n_pad, n_pad), dtype=dtype)
    src = perm[active]
    dst = np.flatnonzero(active)
    Jp[np.ix_(dst, dst)] = problem.J[np.ix_(src, src)].astype(dtype)
    hp = np.zeros(n_pad, dtype=dtype)
    hp[dst] = problem.h[src].astype(dtype)

    J_rows = Jp.reshape(nb, block_size, n_pad)
    J_diag = np.stack(
        [Jp[b * block_size:(b + 1) * block_size, b * block_size:(b + 1) * block_size] for b in range(nb)]
    )
    colored = not bool(np.any(J_diag != 0))

    return BlockedProblem(
        J_rows=J_rows, J_diag=J_diag, h=hp, active=active, perm=perm,
        inv_perm=inv_perm, n=n, block_size=block_size, colored=colored,
    )


def block_sparse_tiles(blocked: BlockedProblem):
    """Block-sparse view of J: for each spin row-block b, the column tiles
    (width block_size) holding any nonzero coupling. Returns
    (col_idx [nB, K] int32, J_tiles [nB, K, B, B]), padded with zero tiles
    up to the max count K. `SweepEngine` routes by K (K3 when K <= nB/2);
    K3's plain version reads the tiles, and its wrapper builds its
    neighbour layout from them when it is given none.
    """
    nB = blocked.num_blocks
    B = blocked.block_size
    J_rows = blocked.J_rows                      # [nB, B, n_pad]
    per_block = []
    for b in range(nB):
        tiles = J_rows[b].reshape(B, nB, B)      # [B, col_tile, B]
        nz = np.flatnonzero(np.any(tiles != 0, axis=(0, 2)))
        per_block.append(nz)
    K = max((len(nz) for nz in per_block), default=1) or 1
    col_idx = np.zeros((nB, K), dtype=np.int32)
    J_tiles = np.zeros((nB, K, B, B), dtype=J_rows.dtype)
    for b, nz in enumerate(per_block):
        for k, j in enumerate(nz):
            col_idx[b, k] = j
            J_tiles[b, k] = J_rows[b][:, j * B:(j + 1) * B]
    return col_idx, J_tiles
