"""Convexified LBP over a slotted edge layout (torch), batched over chains.

The counterpart of ``nmc_tpu/ops/lbp_planes.py``, the campaign's default
LBP on bounded-degree families (chimera degree 6, DCL). Messages live in
slots u[v, d] = the d-th incoming message of node v (D = max degree; dummy
slots carry w = 0 couplings, so their messages are identically zero), so
the in-edge sum is `u.sum(-1)`. Each iteration then needs, per slot, the
total field S at its source node and the message on its reverse edge.

The JAX package expresses those two static selections as one-hot matmuls
at Precision.HIGHEST, a TPU cure for scatters. Each selection is exact
either way, so here they are index gathers: `nbr` (the source node of each
slot) and `rev_slot` (the slot position of the reverse edge in the source's
list), built once from the same host structure. Only the order of the
per-node sum over D slots can differ from JAX's.

`build_edge_slot_planes` and `w_slot_from_tiles` are numpy host code,
copies of JAX's (tests hold them array-equal); the one-hot `planes` are
kept in float32 here (JAX keeps bf16; both hold exact 0/1 values).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..utils.metrics import host_sync
from .lbp import atanh_saturated
from .lbp_jit import _ladder, _rel_change, iterate_per_chain


class EdgeSlotPlanes(NamedTuple):
    """Host-precomputed static structure of one (union) topology.

    gather  [nB, K, nB]        f32 one-hot over block ids
    planes  [nB, D, B, K*B+1]  f32 one-hot slot -> source rows (dummy
                               slots point at the trailing sentinel column)
    rev     [n, D, D]          f32 one-hot: rev[v, d, d'] = 1 iff the
                               reverse of slot (v, d) is slot (nbr, d')
    slot_col [nB, D, B]        int32 (k*B + c) position of each slot's source
    n_pad, block_size, degree
    nbr     [n, D]             int64 source node of each slot, -1 for dummies
    rev_slot [n, D]            int64 d' of each slot's reverse, -1 for dummies
    """
    gather: np.ndarray
    planes: np.ndarray
    rev: np.ndarray
    slot_col: np.ndarray
    n_pad: int
    block_size: int
    degree: int
    nbr: np.ndarray
    rev_slot: np.ndarray


def build_edge_slot_planes(col_idx: np.ndarray, adj_union: np.ndarray,
                           *, max_degree: int = 16) -> EdgeSlotPlanes:
    """Build the slotted-edge structure from union block-sparse tiles.

    col_idx: [nB, K] int32; adj_union: [nB, K, B, B] bool, True where ANY
    instance of the family has a coupling. Symmetric topologies only.
    Raises ValueError past the degree cap or on an asymmetric topology.
    """
    col_idx = np.asarray(col_idx)
    adj = np.asarray(adj_union, bool)
    nB, K, B, _ = adj.shape
    n = nB * B
    deg = adj.sum(axis=(1, 3))                   # [nB, B]
    D = int(deg.max()) if deg.size else 0
    if D > max_degree:
        raise ValueError(
            f"max node degree {D} exceeds the edge-slot plane cap "
            f"{max_degree}; use the edge-list LBP for dense instances")
    D = max(D, 1)

    gather = np.zeros((nB, K, nB), np.float32)
    gather[np.arange(nB)[:, None], np.arange(K)[None, :], col_idx] = 1.0

    nbr = np.full((n, D), -1, np.int64)          # global source node ids
    slot_col = np.zeros((nB, D, B), np.int32)    # k*B + c per slot
    planes = np.zeros((nB, D, B, K * B + 1), np.float32)
    planes[:, :, :, K * B] = 1.0
    for i in range(nB):
        for r in range(B):
            ks, cs = np.nonzero(adj[i, :, r, :])
            v = i * B + r
            for d, (k, c) in enumerate(zip(ks, cs)):
                planes[i, d, r, K * B] = 0.0
                planes[i, d, r, k * B + c] = 1.0
                slot_col[i, d, r] = k * B + c
                nbr[v, d] = col_idx[i, k] * B + c

    rev = np.zeros((n, D, D), np.float32)
    rev_slot = np.full((n, D), -1, np.int64)
    for v in range(n):
        for d in range(D):
            u = nbr[v, d]
            if u < 0:
                continue
            dprime = np.nonzero(nbr[u] == v)[0]
            if dprime.size != 1:
                raise ValueError(
                    f"topology is not symmetric at edge {u}->{v}")
            rev[v, d, dprime[0]] = 1.0
            rev_slot[v, d] = dprime[0]
    return EdgeSlotPlanes(gather, planes, rev, slot_col, n, B, D, nbr,
                          rev_slot)


def w_slot_from_tiles(esp: EdgeSlotPlanes, J_tiles: np.ndarray) -> np.ndarray:
    """Per-instance slot couplings w[v, d] from the instance's union-layout
    tiles [nB, K, B, B] (zero where this instance lacks the union edge)."""
    J_tiles = np.asarray(J_tiles)
    nB, K, B, _ = J_tiles.shape
    D = esp.degree
    flat = J_tiles.transpose(0, 2, 1, 3).reshape(nB, B, K * B)  # [i, r, kc]
    w = np.zeros((nB, D, B), J_tiles.dtype)
    for d in range(D):
        w[:, d, :] = np.take_along_axis(
            flat, esp.slot_col[:, d, :, None].astype(np.int64),
            axis=2)[..., 0]
    # dummy slots (sentinel) may alias position 0; zero them explicitly
    dummy = np.asarray(esp.planes, np.float32)[:, :, :, K * B] > 0.5
    w[dummy] = 0.0
    return np.ascontiguousarray(
        w.transpose(0, 2, 1).reshape(esp.n_pad, D))   # [n, D]


def slot_gather_index(esp: EdgeSlotPlanes, device):
    """(src [n, D], rev [n, D]) int64 gather indices on `device`: the source
    node of each slot (dummies -> n, a zero sentinel appended to S) and the
    flat index v' * D + d' of its reverse message (dummies -> n * D)."""
    n, D = esp.nbr.shape
    dummy = esp.nbr < 0
    src = np.where(dummy, n, esp.nbr)
    rev = np.where(dummy, n * D, esp.nbr * D + esp.rev_slot)
    return (host_sync(torch.as_tensor, src, dtype=torch.int64, device=device),
            host_sync(torch.as_tensor, rev, dtype=torch.int64, device=device))


def convexified_marginal_planes(
    esp: EdgeSlotPlanes,
    w_slot: torch.Tensor,     # [n, D] or [C, n, D] slot couplings
    h: torch.Tensor,          # [C, n]
    epsilon: torch.Tensor,    # [C, n]
    m_star: torch.Tensor,     # [C, n]
    *,
    beta: float,
    ladder: Sequence[float],
    max_iterations: int,
    tolerance: float,
) -> torch.Tensor:
    """Belief logits [C, n] over the slotted layout: the same ladder,
    divergence policy and return convention as
    `lbp_jit.convexified_marginal_sparse`."""
    dtype, device = h.dtype, h.device
    C, n = h.shape
    D = esp.degree
    src, rev = slot_gather_index(esp, device)
    beta = host_sync(torch.as_tensor, beta, dtype=dtype, device=device)
    w = w_slot.to(dtype)
    tanh_bw = torch.tanh(beta * w)
    zero = torch.zeros((C, 1), dtype=dtype, device=device)

    def solve(h_lambda, msgs):
        def step(carry):
            (u,) = carry
            S = h_lambda + torch.sum(u, dim=-1)                     # [C, n]
            S_src = torch.cat([S, zero], dim=1)[:, src]             # [C, n, D]
            u_rev = torch.cat([u.reshape(C, n * D), zero], dim=1)[:, rev]
            u_new = atanh_saturated(
                tanh_bw * torch.tanh(beta * (S_src - u_rev))) / beta
            return (u_new,), _rel_change(u_new, u, (-2, -1)) < tolerance

        (u,), conv = iterate_per_chain(step, msgs, max_iterations)
        return beta * (h_lambda + torch.sum(u, dim=-1)), (u,), conv

    # u0[v, d] = w * m_star[v]: slot (v, d) receives at v
    u0 = (w * m_star[:, :, None]).expand(C, n, D)
    return _ladder(solve, h, epsilon, m_star, ladder, (u0,))
