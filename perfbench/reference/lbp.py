"""The NMC backbone: convexified loopy belief propagation clamped at a
chain's state, then a threshold on the beliefs.

A frozen copy of the program's slotted-message LBP (one message per
directed edge, slot d of node v holding the message from its d-th
neighbour in ascending blocked index), so that the convergence tests,
which compare relative changes with 1e-7 in float32, take the same
branches and the masks can be held bit for bit. The neighbour slots are
worked out here from the union coupling graph.

Per rung lambda of the ladder (lambda_start, halved down to lambda_end):
h_lambda = h + lambda m* epsilon; messages u <- atanh(tanh(beta w) tanh(beta
(S_src - u_rev))) / beta until a chain's relative change drops below the
tolerance (a converged chain keeps its messages) or the iterations run
out; a rung that did not converge keeps the previous rung's beliefs unless
none has converged yet. Beliefs are logits beta (h_lambda + sum u); the
mask is |logit| >= atanh(threshold) on active spins, grown along couplings
over the threshold rungs above the cutoff.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch


def lambda_ladder(start: float, end: float, factor: float) -> List[float]:
    out, lam = [], float(start)
    while lam >= end:
        out.append(lam)
        lam *= factor
        if round(lam, 6) == 0:
            break
    return out


def neighbour_slots(adj: np.ndarray):
    """(nbr [n, D], rev [n, D]) int64 of a symmetric boolean adjacency
    [n, n]: the d-th neighbour of v in ascending index (-1 past its last)
    and the slot of v in that neighbour's list."""
    n = adj.shape[0]
    lists = [np.flatnonzero(adj[v]) for v in range(n)]
    D = max(1, max(len(x) for x in lists))
    nbr = np.full((n, D), -1, np.int64)
    rev = np.full((n, D), -1, np.int64)
    for v, x in enumerate(lists):
        nbr[v, :len(x)] = x
    pos = {}
    for v, x in enumerate(lists):
        for d, u in enumerate(x):
            pos[(v, u)] = d
    for v, x in enumerate(lists):
        for d, u in enumerate(x):
            rev[v, d] = pos[(u, v)]
    return nbr, rev


def _atanh_saturated(x):
    eps = torch.finfo(x.dtype).eps
    sat = torch.tanh(torch.tensor(19.06, dtype=x.dtype)).item()
    return torch.atanh(torch.clamp(x, -sat + eps, sat - eps))


def _rel_change(new, old, dims):
    return (torch.abs(new - old).amax(dim=dims)
            / ((torch.abs(new) + torch.abs(old)).amax(dim=dims) + 1e-30))


def _iterate(step, carry, max_iterations):
    C = carry[0].shape[0]
    conv = torch.zeros(C, dtype=torch.bool, device=carry[0].device)
    for _ in range(max_iterations):
        live = ~conv
        if not bool(live.any()):
            break
        new, c = step(carry)
        carry = tuple(torch.where(live.reshape((C,) + (1,) * (x.ndim - 1)),
                                  y, x) for x, y in zip(carry, new))
        conv = conv | (live & c)
    return carry, conv


def beliefs(nbr, rev, w, h, epsilon, m_star, *, beta: float,
            ladder: Sequence[float], max_iterations: int, tolerance: float):
    """Belief logits [C, n] of C chains: nbr / rev [n, D] from
    `neighbour_slots`, w [C, n, D] slot couplings (0 on empty slots), h,
    epsilon, m_star [C, n]."""
    dtype, device = h.dtype, h.device
    C, n = h.shape
    D = nbr.shape[1]
    dummy = nbr < 0
    src = torch.as_tensor(np.where(dummy, n, nbr), device=device)
    rv = torch.as_tensor(np.where(dummy, n * D, nbr * D + rev), device=device)
    beta = torch.as_tensor(beta, dtype=dtype, device=device)
    w = w.to(dtype)
    tanh_bw = torch.tanh(beta * w)
    zero = torch.zeros((C, 1), dtype=dtype, device=device)

    def solve(h_lambda, msgs):
        def step(carry):
            (u,) = carry
            S = h_lambda + torch.sum(u, dim=-1)
            S_src = torch.cat([S, zero], dim=1)[:, src]
            u_rev = torch.cat([u.reshape(C, n * D), zero], dim=1)[:, rv]
            u_new = _atanh_saturated(
                tanh_bw * torch.tanh(beta * (S_src - u_rev))) / beta
            return (u_new,), _rel_change(u_new, u, (-2, -1)) < tolerance

        (u,), conv = _iterate(step, msgs, max_iterations)
        return beta * (h_lambda + torch.sum(u, dim=-1)), (u,), conv

    marginal = torch.zeros_like(h)
    have_prev = torch.zeros(C, dtype=torch.bool, device=device)
    msgs = ((w * m_star[:, :, None]).expand(C, n, D),)
    for lam in ladder:
        logit, msgs, conv = solve(h + lam * m_star * epsilon, msgs)
        marginal = torch.where((conv | ~have_prev)[:, None], logit, marginal)
        have_prev = have_prev | conv
    return marginal


def backbone_mask(logits, J_abs, active, threshold_initial: float,
                  threshold_cutoff: float, threshold_step: float):
    """|logit| >= atanh(threshold_initial) on active spins, then per
    threshold rung t above the cutoff: mask |= coupled(mask) & |logit| >=
    atanh(t)."""
    def thr(t):
        return math.atanh(min(float(t), 1.0 - 1e-16))

    mag = torch.abs(logits)
    mask = (mag >= thr(threshold_initial)) & active
    t = threshold_initial - threshold_step
    while t > threshold_cutoff:
        nbr = torch.matmul(mask.to(J_abs.dtype), J_abs) > 0
        mask = mask | (nbr & (mag >= thr(t)) & active)
        t -= threshold_step
    return mask
