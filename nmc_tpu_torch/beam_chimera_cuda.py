"""The device beam tier for chimera graphs (exact integer min-plus DP).

Holds `quantize_problem`, a copy of ``nmc_tpu/beam_chimera_tpu.py``'s (held
equal to it by the tests): the induced-tree refinement
(`refine.tree_refine_state`) runs its exact integer arithmetic on the
couplings it snaps. The beam DP on the card is still to be ported
(ROADMAP.md, queue 1 item 3).
"""
from __future__ import annotations

import numpy as np

__all__ = ["quantize_problem"]


def quantize_problem(prob, q_max: int = 10000):
    """Smallest q <= q_max with J*q, h*q integral (within print rounding).

    Returns (Jq, hq, q) int64 arrays. Raises ValueError when no such q
    exists (the shipped chimera/DCL instances all qualify; q = 75 for the
    droplet families).
    """
    J = np.asarray(prob.J, np.float64)
    h = np.asarray(prob.h, np.float64)
    vals = np.concatenate([J[np.nonzero(J)], h[np.nonzero(h)]])
    if vals.size == 0:
        return J.astype(np.int64), h.astype(np.int64), 1
    for q in range(1, q_max + 1):
        vq = vals * q
        # the files print 6 decimals; |rounding error| * q stays < ~q*5e-7
        if np.all(np.abs(vq - np.round(vq)) < max(1e-4, q * 2e-5)):
            return (np.round(J * q).astype(np.int64),
                    np.round(h * q).astype(np.int64), q)
    raise ValueError(f"couplings are not multiples of 1/q for q <= {q_max}")
