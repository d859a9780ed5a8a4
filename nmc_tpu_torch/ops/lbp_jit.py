"""Convexified LBP belief logits for a batch of chains, as the campaign
engine runs them between its rounds (torch).

The counterpart of ``nmc_tpu/ops/lbp_jit.py``, whose per-chain bodies the
JAX engines vmap over NMC slots and instances. Here every function takes a
leading chain axis C and solves all chains at once:

  * `convexified_marginal_dense`: dense [C, n, n] messages; the messages
    are clipped to +-0.9999999 before arctanh, as JAX does there;
  * `convexified_marginal_sparse`: one message per directed edge of an
    `EdgeGraph` (per-chain edge weights [C, E]), with `atanh_saturated`.

Each rung of the lambda ladder iterates every chain until its own relative
message change drops below the tolerance or `max_iterations` is reached;
a chain that has converged keeps its messages from then on, which is what
``jax.vmap`` of ``lax.while_loop`` does. The reference's divergence policy
holds per rung and chain: a rung that did not converge keeps the previous
marginal, unless no rung has converged yet. Both return belief LOGITS
beta * (h_lambda + sum of incoming messages), not tanh of them: in f32 the
tanh saturates to 1.0 and cannot discriminate the reference's thresholds
(`ops/clusters.backbone_mask_device(logits=True)` maps the thresholds
through atanh instead).

The convergence test reads one flag per chain on the host per iteration,
so a solve costs one host sync per iteration for the whole batch. Inside
an engine round that records (`utils.metrics.RoundSpans`) each ladder
counts one "lbp_refreshes" and each iteration one "lbp_iterations".
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from ..utils.metrics import count, host_sync
from .lbp import atanh_saturated
from .lbp_sparse import EdgeGraph, _in_sum

_CLIP = 0.9999999


def iterate_per_chain(step: Callable, carry: Tuple[torch.Tensor, ...],
                      max_iterations: int):
    """Run `step(carry) -> (new_carry, converged [C])` until every chain has
    converged or `max_iterations` steps ran; a converged chain's carry is
    frozen. Returns (carry, converged [C]). Each step counts one
    "lbp_iterations" in a recording round."""
    C = carry[0].shape[0]
    conv = torch.zeros(C, dtype=torch.bool, device=carry[0].device)
    for _ in range(max_iterations):
        live = ~conv
        if not host_sync(bool, live.any()):
            break
        new, c = step(carry)
        count("lbp_iterations")
        carry = tuple(torch.where(live.reshape((C,) + (1,) * (x.ndim - 1)),
                                  y, x) for x, y in zip(carry, new))
        conv = conv | (live & c)
    return carry, conv


def _rel_change(new, old, dims):
    return (torch.abs(new - old).amax(dim=dims)
            / ((torch.abs(new) + torch.abs(old)).amax(dim=dims) + 1e-30))


def _ladder(solve, h, epsilon, m_star, ladder, init):
    """The lambda ladder: `solve(h_lambda, messages) -> (logits, messages,
    converged)`; the marginal is replaced where a rung converged or none
    has yet. One ladder counts one "lbp_refreshes"."""
    count("lbp_refreshes")
    marginal = torch.zeros_like(h)
    have_prev = torch.zeros(h.shape[0], dtype=torch.bool, device=h.device)
    msgs = init
    for lam in ladder:
        h_lambda = h + lam * m_star * epsilon
        logit, msgs, conv = solve(h_lambda, msgs)
        marginal = torch.where((conv | ~have_prev)[:, None], logit, marginal)
        have_prev = have_prev | conv
    return marginal


def convexified_marginal_dense(
    J_full: torch.Tensor,     # [n, n] or [C, n, n] couplings, blocked layout
    h: torch.Tensor,          # [C, n]
    epsilon: torch.Tensor,    # [C, n]
    m_star: torch.Tensor,     # [C, n] clamp states
    *,
    beta: float,
    ladder: Sequence[float],
    max_iterations: int,
    tolerance: float,
) -> torch.Tensor:
    """Belief logits [C, n] at each chain's last converged rung, dense
    messages (h_msgs[i, j], u_msgs[i, j] per chain)."""
    dtype, device = h.dtype, h.device
    n = h.shape[-1]
    beta = host_sync(torch.as_tensor, beta, dtype=dtype, device=device)
    J_full = J_full.to(dtype)
    tanh_bJ = torch.tanh(beta * J_full)
    off_diag = 1.0 - torch.eye(n, dtype=dtype, device=device)

    def solve(h_lambda, msgs):
        def step(carry):
            h_m, u_m = carry
            col_in = h_lambda + torch.sum(u_m, dim=-2)
            h_new = (col_in[..., :, None] - u_m.transpose(-1, -2)) * off_diag
            u_new = torch.atanh(torch.clamp(
                tanh_bJ * torch.tanh(beta * h_new), -_CLIP, _CLIP)) / beta
            conv = ((_rel_change(u_new, u_m, (-2, -1)) < tolerance)
                    & (_rel_change(h_new, h_m, (-2, -1)) < tolerance))
            return (h_new, u_new), conv

        (h_m, u_m), conv = iterate_per_chain(step, msgs, max_iterations)
        logit = beta * (h_lambda + torch.sum(u_m, dim=-2))
        return logit, (h_m, u_m), conv

    C = h.shape[0]
    u0 = (J_full * m_star[:, None, :]).expand(C, n, n)
    h0 = torch.zeros((C, n, n), dtype=dtype, device=device)
    return _ladder(solve, h, epsilon, m_star, ladder, (h0, u0))


def convexified_marginal_sparse(
    graph: EdgeGraph,         # union topology of the family
    w_e: torch.Tensor,        # [E] or [C, E] per-chain edge couplings
    h: torch.Tensor,          # [C, n]
    epsilon: torch.Tensor,    # [C, n]
    m_star: torch.Tensor,     # [C, n]
    *,
    beta: float,
    ladder: Sequence[float],
    max_iterations: int,
    tolerance: float,
) -> torch.Tensor:
    """Belief logits [C, n], one message per directed edge (O(nnz) per
    iteration). Union edges a chain's instance lacks carry w = 0, hence
    zero messages."""
    dtype, device = h.dtype, h.device
    g = graph.tensors(device, dtype)
    beta = host_sync(torch.as_tensor, beta, dtype=dtype, device=device)
    w_e = w_e.to(dtype)
    tanh_bw = torch.tanh(beta * w_e)

    def solve(h_lambda, msgs):
        def step(carry):
            (u,) = carry
            S = h_lambda + _in_sum(u, g.in_edges)
            h_msg = S[:, g.src] - u[:, g.rev]
            u_new = atanh_saturated(tanh_bw * torch.tanh(beta * h_msg)) / beta
            return (u_new,), _rel_change(u_new, u, -1) < tolerance

        (u,), conv = iterate_per_chain(step, msgs, max_iterations)
        return beta * (h_lambda + _in_sum(u, g.in_edges)), (u,), conv

    u0 = (w_e * m_star[:, g.dst]).expand(h.shape[0], -1)
    return _ladder(solve, h, epsilon, m_star, ladder, (u0,))
