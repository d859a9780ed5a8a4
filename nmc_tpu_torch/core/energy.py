"""Batched Ising energies and local fields (torch).

E(m) = -(m^T J m / 2 + m^T h). With cached local fields phi = J@m + h the
energy is O(N): m^T J m = m.(phi - h), so

    E = -0.5 * m.(phi + h)

which is what the sweep engine uses to emit per-sweep energies.
"""

from __future__ import annotations

import torch


def local_fields(J: torch.Tensor, h: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """phi = J @ m + h for m of shape [..., N] (J symmetric)."""
    return torch.matmul(m, J) + h


def energy(J: torch.Tensor, h: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """E(m) for m of shape [..., N] -> [...]."""
    Jm = torch.matmul(m, J)
    return -(0.5 * torch.sum(m * Jm, dim=-1) + torch.sum(m * h, dim=-1))


def energy_from_fields(h: torch.Tensor, m: torch.Tensor,
                       phi: torch.Tensor) -> torch.Tensor:
    """E(m) from cached local fields phi = J@m + h. O(N) per state."""
    return -0.5 * torch.sum(m * (phi + h), dim=-1)


def by_rows(fn, *xs: torch.Tensor, sharded: bool):
    """fn(*xs) over tensors that share a leading axis of rows (replicas or
    instances), in one batched call; or, for an engine sharded over a
    process group (`sharded`), on each row by itself (a fresh, aligned
    [1, ...] copy of each operand) with the results concatenated. A
    product's reduction order may follow its batch's shape, so a sharded
    engine computes its rows this way and a row's result never depends on
    how many rows a rank holds. fn returns a tensor or a tuple of them."""
    if not sharded or xs[0].shape[0] == 0:
        return fn(*xs)
    out = [fn(*(x[r:r + 1].clone() for x in xs))
           for r in range(xs[0].shape[0])]
    if isinstance(out[0], tuple):
        return tuple(torch.cat(o) for o in zip(*out))
    return torch.cat(out)
