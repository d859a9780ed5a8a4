"""Edge-message loopy belief propagation for large sparse instances (torch).

The counterpart of ``nmc_tpu/ops/lbp_sparse.py``. Dense LBP (ops/lbp.py)
carries [N, N] messages per chain; at chimera 16x16 that is 4.2 M entries
against 12,032 directed-edge messages. Here one message lives on each
directed edge e = i -> j:

    S[i]          = h[i] + sum_{e: dst(e) = i} u[e]
    h_msg[e=i->j] = S[i] - u[rev(e)]
    u_new[e]      = atanh_sat(tanh(beta * J_e) * tanh(beta * h_msg[e])) / beta
    mag[i]        = tanh(beta * S[i])

which is the dense recursion restricted to the nonzero couplings. The
segment sum over in-edges runs on a padded in-edge table [N, max_degree]
(missing slots point at one extra zero message), added slot by slot: a
fixed order, so the sum is deterministic on the card, where `index_add_`
adds in atomic order.

`sparse_lbp` takes an optional leading batch axis (one chain per row); each
chain stops at its own convergence and keeps its messages from then on, as
under ``jax.vmap`` of the JAX package's ``lax.while_loop``.
`sparse_lbp_convexified` is the per-chain lambda ladder (warm start, ladder
and divergence policy of ``lbp_convexified``); `sparse_lbp_convexified_batch`
runs it for R chains at once, one batched solve per rung, and gives each
chain what the per-chain function gives. Eager torch needs one host sync per
iteration to test convergence, so batching the chains is what keeps that
to ~100 syncs per rung instead of ~100 per chain and rung.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .lbp import _DIVERGED_MSG, atanh_saturated, lambda_ladder


class EdgeTensors(NamedTuple):
    """An EdgeGraph's index and weight arrays on one device."""
    src: torch.Tensor       # [E] int64
    dst: torch.Tensor       # [E] int64
    weight: torch.Tensor    # [E]
    rev: torch.Tensor       # [E] int64
    in_edges: torch.Tensor  # [N, D] int64, E = the zero message


@dataclasses.dataclass(frozen=True)
class EdgeGraph:
    """Directed edge-list view of a symmetric J (host-built, numpy)."""

    src: np.ndarray       # [E] int32 source node per directed edge
    dst: np.ndarray       # [E] int32 destination node
    weight: np.ndarray    # [E] J[src, dst]
    rev: np.ndarray       # [E] index of the reversed edge
    n: int
    in_edges: np.ndarray  # [N, D] edges e with dst(e) = i in index order,
    #                       padded with E (a zero message); D = max degree

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @staticmethod
    def from_dense(J: np.ndarray) -> "EdgeGraph":
        J = np.asarray(J.toarray() if hasattr(J, "toarray") else J)
        iu, ju = np.nonzero(np.triu(J, 1))
        w = J[iu, ju]
        E2 = len(iu)
        src = np.concatenate([iu, ju]).astype(np.int32)
        dst = np.concatenate([ju, iu]).astype(np.int32)
        weight = np.concatenate([w, w])
        rev = np.concatenate([np.arange(E2) + E2,
                              np.arange(E2)]).astype(np.int32)
        n = J.shape[0]
        order = np.argsort(dst, kind="stable")
        degree = np.bincount(dst, minlength=n)
        slot = np.arange(2 * E2) - np.repeat(np.cumsum(degree) - degree,
                                             degree)
        in_edges = np.full((n, max(int(degree.max(initial=0)), 1)), 2 * E2,
                           dtype=np.int64)
        in_edges[dst[order], slot] = order
        return EdgeGraph(src=src, dst=dst, weight=weight, rev=rev, n=n,
                         in_edges=in_edges)

    def tensors(self, device, dtype) -> EdgeTensors:
        def idx(a):
            return torch.as_tensor(a, dtype=torch.int64, device=device)
        return EdgeTensors(
            src=idx(self.src), dst=idx(self.dst),
            weight=torch.as_tensor(self.weight, dtype=dtype, device=device),
            rev=idx(self.rev), in_edges=idx(self.in_edges))


class SparseLBPResult(NamedTuple):
    magnetizations: torch.Tensor  # [..., N]
    h_tilde: torch.Tensor         # [..., N]
    u_msgs: torch.Tensor          # [..., E]
    iterations: torch.Tensor      # [...] int: iterations run
    converged: torch.Tensor       # [...] bool
    belief: torch.Tensor          # [..., N] pre-tanh total field h + sum u
    #   (magnetizations = tanh(beta * belief); f32-safe thresholding)


def _in_sum(u: torch.Tensor, in_edges: torch.Tensor) -> torch.Tensor:
    """sum_{e: dst(e) = i} u[..., e] -> [..., N], slot by slot."""
    u = torch.cat([u, u.new_zeros(u.shape[:-1] + (1,))], dim=-1)
    acc = u[..., in_edges[:, 0]]
    for d in range(1, in_edges.shape[1]):
        acc = acc + u[..., in_edges[:, d]]
    return acc


def sparse_lbp(
    graph: EdgeTensors,
    h: torch.Tensor,        # [..., N]
    beta,
    u0: torch.Tensor,       # [..., E] warm-start messages
    tolerance,
    *,
    max_iterations: int,
) -> SparseLBPResult:
    """Edge-message LBP; per chain, iterate until the relative change of
    the messages drops below the tolerance or max_iterations is reached."""
    dtype, device = h.dtype, h.device
    beta = torch.as_tensor(beta, dtype=dtype, device=device)
    # dtype-aware tolerance floor (see ops/lbp.loopy_belief_propagation)
    eps = torch.finfo(dtype).eps
    tol = max(float(tolerance), eps if dtype == torch.float64 else 4 * eps)
    tanh_bw = torch.tanh(beta * graph.weight)

    u = u0
    batch = u0.shape[:-1]
    it = torch.zeros(batch, dtype=torch.int64, device=device)
    converged = torch.zeros(batch, dtype=torch.bool, device=device)
    for _ in range(max_iterations):
        live = ~converged
        if not bool(live.any()):
            break
        S = h + _in_sum(u, graph.in_edges)
        h_msg = S[..., graph.src] - u[..., graph.rev]
        u_new = atanh_saturated(tanh_bw * torch.tanh(beta * h_msg)) / beta
        change = torch.abs(u_new - u).amax(dim=-1) / (
            (torch.abs(u_new) + torch.abs(u)).amax(dim=-1) + 1e-30)
        u = torch.where(live[..., None], u_new, u)
        it = it + live.to(it.dtype)
        converged = converged | (live & (change < tol))
    S = h + _in_sum(u, graph.in_edges)
    mag = torch.tanh(beta * S)
    h_tilde = atanh_saturated(mag) / beta
    return SparseLBPResult(magnetizations=mag, h_tilde=h_tilde, u_msgs=u,
                           iterations=it, converged=converged, belief=S)


def sparse_lbp_convexified(
    graph: EdgeGraph,
    h: torch.Tensor,        # [N]; its dtype and device are the solve's
    global_beta,
    m_star,
    epsilon,
    *,
    lambda_start: float,
    lambda_end: float,
    lambda_reduction_factor: float,
    tolerance: float,
    max_iterations: int,
    return_belief: bool = False,
):
    """Lambda-annealed convexified LBP over edge messages, one chain.

    Same ladder and divergence policy as ops/lbp.lbp_convexified; the warm
    start u0[e = i->j] = J_ij * m_star[j] mirrors the dense
    u_msgs = J * m_star row broadcast.
    """
    dtype, device = h.dtype, h.device
    g = graph.tensors(device, dtype)
    h = h.reshape(-1)
    m_star = torch.as_tensor(m_star, dtype=dtype, device=device).reshape(-1)
    epsilon = torch.as_tensor(epsilon, dtype=dtype, device=device).reshape(-1)
    u = g.weight * m_star[g.dst]

    ladder = lambda_ladder(lambda_start, lambda_end, lambda_reduction_factor)
    marginal = belief = None
    for i, lam in enumerate(ladder):
        res = sparse_lbp(g, h + lam * m_star * epsilon, global_beta, u,
                         tolerance, max_iterations=max_iterations)
        u = res.u_msgs
        if not bool(res.converged):
            if i == 0:
                raise ValueError(_DIVERGED_MSG)
            break          # keep the previous rung's marginal
        marginal = res.magnetizations.cpu().numpy()
        belief = res.belief.cpu().numpy()
    if return_belief:
        return marginal, belief
    return marginal


def sparse_lbp_convexified_batch(
    graph: EdgeGraph,
    h: torch.Tensor,        # [N]; its dtype and device are the solve's
    global_beta,
    m_stars,                # [R, N] one clamp state per chain
    epsilon,                # [N]
    *,
    lambda_start: float,
    lambda_end: float,
    lambda_reduction_factor: float,
    tolerance: float,
    max_iterations: int,
    return_belief: bool = False,
):
    """`sparse_lbp_convexified` for R chains, one batched solve per rung
    over [R, E] messages. A chain that diverges at a later rung keeps its
    previous marginal and leaves the batch, as the per-chain ladder stops.
    Returns marginals [R, N] (and beliefs [R, N]), numpy."""
    dtype, device = h.dtype, h.device
    g = graph.tensors(device, dtype)
    h = h.reshape(-1)
    m_stars = torch.as_tensor(np.asarray(m_stars), dtype=dtype, device=device)
    epsilon = torch.as_tensor(epsilon, dtype=dtype, device=device).reshape(-1)
    R, N = m_stars.shape
    u = g.weight * m_stars[:, g.dst]                     # [R, E]

    marginals = np.zeros((R, N))
    beliefs = np.zeros((R, N))
    live = np.ones(R, dtype=bool)
    ladder = lambda_ladder(lambda_start, lambda_end, lambda_reduction_factor)
    for i, lam in enumerate(ladder):
        rows = torch.as_tensor(np.flatnonzero(live), device=device)
        res = sparse_lbp(g, h + lam * m_stars[rows] * epsilon, global_beta,
                         u[rows], tolerance, max_iterations=max_iterations)
        u[rows] = res.u_msgs
        ok = res.converged.cpu().numpy()
        if i == 0 and not ok.all():
            raise ValueError(_DIVERGED_MSG)
        ran = np.flatnonzero(live)
        marginals[ran[ok]] = res.magnetizations.cpu().numpy()[ok]
        beliefs[ran[ok]] = res.belief.cpu().numpy()[ok]
        live[ran[~ok]] = False
        if not live.any():
            break
    if return_belief:
        return marginals, beliefs
    return marginals
