"""Loopy belief propagation with convexification (backbone inference), torch.

The counterpart of ``nmc_tpu/ops/lbp.py``:
  * `loopy_belief_propagation`: dense tanh message passing with the
    reference's relative-change convergence test. It takes an optional
    leading batch axis (one chain per row); each chain stops at its own
    convergence and its messages stay frozen from then on, as under
    ``jax.vmap`` of ``lax.while_loop`` in the JAX package.
  * `atanh_saturated`: clip to +-tanh(19.06) -+ eps before arctanh.
  * `lbp_convexified` / `lbp_convexified_batch`: the lambda-annealed soft
    clamp h_lambda = h + lambda * m_star * epsilon with geometric decay,
    warm-started messages, and the reference's divergence policy (error at
    the first lambda; later, reuse the previous marginal and stop).

Messages are dense [N, N] (per chain) tensors on the device of J.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch


def atanh_saturated(x: torch.Tensor) -> torch.Tensor:
    """arctanh with the reference's saturation at +-tanh(19.06) -+ eps."""
    eps = torch.finfo(x.dtype).eps
    sat = torch.tanh(torch.tensor(19.06, dtype=x.dtype)).item()
    return torch.atanh(torch.clamp(x, -sat + eps, sat - eps))


class LBPResult(NamedTuple):
    magnetizations: torch.Tensor  # [..., N]
    correlations: torch.Tensor    # [..., N, N]
    h_tilde: torch.Tensor         # [..., N]
    J_tilde: torch.Tensor         # [..., N, N]
    iterations: torch.Tensor      # [...] int: index of last iteration run
    h_msgs: torch.Tensor          # [..., N, N]
    u_msgs: torch.Tensor          # [..., N, N]
    belief: torch.Tensor          # [..., N] pre-tanh total field h + sum u:
    #   magnetizations = tanh(beta * belief). Thresholds finer than f32
    #   resolution must be applied to the belief (or to an f64 tanh of it):
    #   in f32 the tanh saturates to exactly 1.0 and cannot discriminate.


def _max_last2(x: torch.Tensor) -> torch.Tensor:
    return x.amax(dim=(-2, -1))


def loopy_belief_propagation(
    J: torch.Tensor,        # [N, N]
    h: torch.Tensor,        # [..., N]
    beta,
    h_msgs: torch.Tensor,   # [..., N, N]
    u_msgs: torch.Tensor,   # [..., N, N]
    tolerance,
    *,
    max_iterations: int,
) -> LBPResult:
    """One LBP solve per chain; semantics of the reference's
    LoopyBeliefPropagation.

    `iterations` reports the reference's loop variable at exit: it equals
    max_iterations - 1 iff the tolerance was never met (the divergence
    signal consumed by lbp_convexified).
    """
    dtype, device = J.dtype, J.device
    N = J.shape[0]
    batch = h.shape[:-1]
    beta = torch.as_tensor(beta, dtype=dtype, device=device)
    # Dtype-aware tolerance floor: the reference's float64-eps default is
    # unreachable for the float32 relative-change plateau (rounding noise
    # sits at a few ulps), which would misreport convergence as divergence.
    # float64 keeps the raw tolerance.
    eps = torch.finfo(dtype).eps
    floor = eps if dtype == torch.float64 else 4 * eps
    tol = max(float(tolerance), floor)
    tiny = torch.finfo(dtype).tiny  # guards the 0/0 case at exact fixed points
    tanh_bJ = torch.tanh(beta * J)
    off_diag = 1.0 - torch.eye(N, dtype=dtype, device=device)

    h_m, u_m = h_msgs, u_msgs
    it = torch.zeros(batch, dtype=torch.int64, device=device)
    converged = torch.zeros(batch, dtype=torch.bool, device=device)
    for _ in range(max_iterations):
        live = ~converged
        if not bool(live.any()):
            break
        # h_msgs[i, j] = h[i] + sum_k u[k, i] - u[j, i], zero diagonal
        col_in = h + torch.sum(u_m, dim=-2)                    # [..., N]
        h_new = (col_in[..., :, None] - u_m.transpose(-1, -2)) * off_diag
        u_new = atanh_saturated(tanh_bJ * torch.tanh(beta * h_new)) / beta
        u_change = _max_last2(torch.abs(u_new - u_m)) / (
            _max_last2(torch.abs(u_new) + torch.abs(u_m)) + tiny)
        h_change = _max_last2(torch.abs(h_new - h_m)) / (
            _max_last2(torch.abs(h_new) + torch.abs(h_m)) + tiny)
        sel = live[..., None, None]
        h_m = torch.where(sel, h_new, h_m)
        u_m = torch.where(sel, u_new, u_m)
        it = it + live.to(it.dtype)
        converged = converged | (live & (u_change < tol) & (h_change < tol))

    belief = h + torch.sum(u_m, dim=-2)
    mag = torch.tanh(beta * belief)
    th = torch.tanh(beta * h_m)
    thth = th * th.transpose(-1, -2)
    corr = (tanh_bJ + thth) / (1.0 + tanh_bJ * thth + 1e-10)
    corr = corr * off_diag
    h_tilde = atanh_saturated(mag) / beta
    J_tilde = atanh_saturated(corr) / beta
    # the reference exposes the 0-based loop index at exit; a full
    # non-converged run leaves it at max_iterations - 1
    iterations = torch.where(converged, it - 1,
                             torch.full_like(it, max_iterations - 1))
    return LBPResult(mag, corr, h_tilde, J_tilde, iterations, h_m, u_m,
                     belief)


def lambda_ladder(lambda_start: float, lambda_end: float,
                  reduction_factor: float) -> List[float]:
    """The lambda values LBP_convexified visits (host-precomputed),
    including the reference's round(lambda, 6) == 0 early break."""
    if reduction_factor >= 1.0 or reduction_factor <= 0.0:
        raise ValueError("lambda_reduction_factor must be in (0, 1)")
    out = []
    lam = float(lambda_start)
    while lam >= lambda_end:
        out.append(lam)
        lam *= reduction_factor
        if round(lam, 6) == 0:
            break
    return out


class ConvexifiedLBPResult(NamedTuple):
    marginal: np.ndarray                 # final marginal used for clusters
    marginals_all: Dict[float, np.ndarray]
    mean_marginals_all: Dict[float, float]
    h_tilde_all: Dict[float, np.ndarray]
    J_tilde_all: Dict[float, np.ndarray]
    belief: np.ndarray                   # final pre-tanh field h + sum u
    #   (same divergence-fallback rung as `marginal`); marginal ==
    #   tanh(global_beta * belief). Use for f32-safe thresholding.


_DIVERGED_MSG = ("LBP diverged at initial lambda, please try a larger "
                 "lambda_start or increase max_iterations or beta")


def lbp_convexified(
    J: torch.Tensor,
    h: torch.Tensor,
    global_beta: float,
    m_star,
    epsilon,
    *,
    lambda_start: float,
    lambda_end: float,
    lambda_reduction_factor: float,
    tolerance: float,
    max_iterations: int,
    keep_history: bool = False,
) -> ConvexifiedLBPResult:
    """Lambda-annealed LBP soft-clamped at m_star.

    Messages warm-start as h_msgs = 0, u_msgs = J * m_star (row vector
    broadcast); each rung runs LBP on h + lambda * m_star * epsilon;
    divergence at the first rung raises, later divergence reuses the
    previous marginal and stops.
    """
    dtype, device = J.dtype, J.device
    h = torch.as_tensor(h, dtype=dtype, device=device).reshape(-1)
    m_star = torch.as_tensor(m_star, dtype=dtype, device=device).reshape(-1)
    epsilon = torch.as_tensor(epsilon, dtype=dtype, device=device).reshape(-1)

    h_msgs = torch.zeros_like(J)
    u_msgs = J * m_star[None, :]

    marginals_all: Dict[float, np.ndarray] = {}
    mean_all: Dict[float, float] = {}
    h_tilde_all: Dict[float, np.ndarray] = {}
    J_tilde_all: Dict[float, np.ndarray] = {}

    ladder = lambda_ladder(lambda_start, lambda_end, lambda_reduction_factor)
    marginal_prev = belief_prev = None
    marginal = belief = None
    for i, lam in enumerate(ladder):
        h_lambda = h + lam * m_star * epsilon
        res = loopy_belief_propagation(
            J, h_lambda, global_beta, h_msgs, u_msgs, tolerance,
            max_iterations=max_iterations)
        h_msgs, u_msgs = res.h_msgs, res.u_msgs
        diverged = int(res.iterations) == max_iterations - 1
        if diverged and i == 0:
            raise ValueError(_DIVERGED_MSG)
        if diverged:
            marginal, belief = marginal_prev, belief_prev
        else:
            marginal = marginal_prev = res.magnetizations.cpu().numpy()
            belief = belief_prev = res.belief.cpu().numpy()

        marginals_all[lam] = marginal
        mean_all[lam] = float(np.mean(marginal))
        if keep_history:
            h_tilde_all[lam] = res.h_tilde.cpu().numpy()
            J_tilde_all[lam] = res.J_tilde.cpu().numpy()
        if diverged:
            break

    return ConvexifiedLBPResult(
        marginal=np.asarray(marginal),
        marginals_all=marginals_all,
        mean_marginals_all=mean_all,
        h_tilde_all=h_tilde_all,
        J_tilde_all=J_tilde_all,
        belief=np.asarray(belief),
    )


def convexification_epsilon(J: np.ndarray, h: np.ndarray) -> np.ndarray:
    """epsilon_i = |h_i| + sum_j |J_ij| (host, numpy)."""
    return np.abs(np.asarray(h).reshape(-1)) + np.sum(np.abs(J), axis=1)


def lbp_convexified_batch(
    J: torch.Tensor,
    h: torch.Tensor,
    global_beta: float,
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
    """Convexified LBP for a BATCH of chains (one batched LBP per rung).

    Per chain the semantics match lbp_convexified: warm-started messages,
    geometric lambda ladder, divergence at rung 0 raises, later divergence
    freezes that chain's marginal at the previous rung (its messages keep
    iterating on later rungs, as in the JAX package). Returns final
    marginals [R, N] (plus final beliefs [R, N] when return_belief), numpy.
    """
    dtype, device = J.dtype, J.device
    h = torch.as_tensor(h, dtype=dtype, device=device).reshape(-1)
    m_stars = torch.as_tensor(m_stars, dtype=dtype, device=device)
    epsilon = torch.as_tensor(epsilon, dtype=dtype, device=device).reshape(-1)
    R, N = m_stars.shape

    h_msgs = torch.zeros((R, N, N), dtype=dtype, device=device)
    u_msgs = J[None, :, :] * m_stars[:, None, :]

    marginals = np.zeros((R, N))
    beliefs = np.zeros((R, N))
    prev = np.zeros((R, N))
    prev_b = np.zeros((R, N))
    frozen = np.zeros(R, dtype=bool)
    ladder = lambda_ladder(lambda_start, lambda_end, lambda_reduction_factor)
    for i, lam in enumerate(ladder):
        h_lambda = h[None, :] + lam * m_stars * epsilon[None, :]
        res = loopy_belief_propagation(J, h_lambda, global_beta, h_msgs,
                                       u_msgs, tolerance,
                                       max_iterations=max_iterations)
        h_msgs, u_msgs = res.h_msgs, res.u_msgs
        diverged = res.iterations.cpu().numpy() == max_iterations - 1
        if i == 0 and diverged.any():
            raise ValueError(_DIVERGED_MSG)
        mags = res.magnetizations.cpu().numpy()
        bels = res.belief.cpu().numpy()
        newly_frozen = diverged & ~frozen
        live = ~frozen
        marginals[live & ~diverged] = mags[live & ~diverged]
        marginals[newly_frozen] = prev[newly_frozen]
        beliefs[live & ~diverged] = bels[live & ~diverged]
        beliefs[newly_frozen] = prev_b[newly_frozen]
        frozen |= diverged
        prev = np.where(frozen[:, None], marginals, mags)
        prev_b = np.where(frozen[:, None], beliefs, bels)
        if frozen.all():
            break
    if return_belief:
        return marginals, beliefs
    return marginals
