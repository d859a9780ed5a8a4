"""Backbone cluster extraction.

Copies of ``find_clusters``, ``flatten_clusters`` and ``cluster_mask`` from
``nmc_tpu/ops/clusters.py`` (host side, numpy), and its device-side
`backbone_mask_device` in torch. Seeds are spins with |marginal| >=
threshold_initial; each unclaimed seed starts a cluster together with its
direct J-neighbors that are also seeds; then the threshold decays by
threshold_step down to threshold_cutoff, each pass absorbing yet-unclaimed
neighbors above the current threshold. (With the reference's shipped
defaults the growth loop body never executes; that quirk is kept, since it
follows from the same arithmetic.)
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch


def find_clusters(
    J: np.ndarray,
    magnetizations: np.ndarray,
    threshold_initial: float,
    threshold_cutoff: float,
    threshold_step: float = 0.01,
) -> List[np.ndarray]:
    """Backbone clusters from LBP marginals (host-side).

    Returns a list of int index arrays; claimed spins are excluded from
    later clusters exactly as in the reference.
    """
    J = np.asarray(J.toarray() if hasattr(J, "toarray") else J)
    mag = np.asarray(magnetizations).reshape(-1)
    n = mag.shape[0]
    is_seed = np.abs(mag) >= threshold_initial
    claimed = np.zeros(n, dtype=bool)
    clusters: List[np.ndarray] = []

    for seed in np.flatnonzero(is_seed):
        if claimed[seed]:
            continue
        nbrs = J[seed] != 0
        grab = nbrs & is_seed & ~claimed
        grab[seed] = True
        members = np.flatnonzero(grab)
        # keep the seed first, like the reference's np.append(seed, common)
        members = np.concatenate(([seed], members[members != seed]))
        claimed[members] = True
        clusters.append(members)

    threshold = threshold_initial - threshold_step
    while threshold > threshold_cutoff:
        for i, cluster in enumerate(clusters):
            nbrs = np.any(J[cluster] != 0, axis=0) & ~claimed
            grow = np.flatnonzero(nbrs & (np.abs(mag) >= threshold))
            if grow.size:
                claimed[grow] = True
                clusters[i] = np.concatenate([cluster, grow])
        threshold -= threshold_step

    return clusters


def flatten_clusters(clusters: List[np.ndarray]) -> np.ndarray:
    """Concatenate cluster index arrays."""
    if not clusters:
        return np.array([], dtype=np.int64)
    return np.concatenate(clusters).astype(np.int64)


def cluster_mask(n: int, clusters: List[np.ndarray] | np.ndarray) -> np.ndarray:
    """Boolean membership mask [n] from clusters or a flat index array."""
    mask = np.zeros(n, dtype=bool)
    flat = clusters if isinstance(clusters, np.ndarray) else flatten_clusters(clusters)
    mask[flat.astype(np.int64)] = True
    return mask


def backbone_mask_device(
    marginal: torch.Tensor,   # [..., N] LBP marginals (or logits, see below)
    J_abs: torch.Tensor,      # [..., N, N] |J| (any nonneg matrix with J's sparsity)
    threshold_initial: float,
    threshold_cutoff: float,
    threshold_step: float = 0.01,
    active: Optional[torch.Tensor] = None,
    *,
    logits: bool = False,
) -> torch.Tensor:
    """Flat backbone mask with the reference's threshold-decay growth,
    batched over leading axes: seeds are |marginal| >= threshold_initial,
    then one masked adjacency propagation per static threshold rung
    (initial - step, ... > cutoff): mask |= neighbor(mask) & (|m| >= t).
    With the shipped defaults the rung ladder is empty and the mask is pure
    thresholding, as in `find_clusters`.

    `logits=True`: `marginal` carries the belief logit beta * (h + sum u)
    and each threshold t is mapped to atanh(t) in float64 on the host, so
    thresholds such as 0.9999999 keep their float64 meaning on float32
    beliefs (|m| >= t <=> |logit| >= atanh(t)).
    """
    if logits:
        def _thr(t):
            # t may sit at 1.0 in user-specified ladders: stay inside atanh
            return math.atanh(min(float(t), 1.0 - 1e-16))
    else:
        def _thr(t):
            return t
    mag = torch.abs(marginal)
    mask = mag >= _thr(threshold_initial)
    if active is not None:
        mask = mask & active
    thr = threshold_initial - threshold_step
    while thr > threshold_cutoff:
        cand = mag >= _thr(thr)
        if active is not None:
            cand = cand & active
        nbr = torch.matmul(mask.to(J_abs.dtype), J_abs) > 0
        mask = mask | (nbr & cand)
        thr -= threshold_step
    return mask
