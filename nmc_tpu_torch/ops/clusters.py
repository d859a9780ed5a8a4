"""Backbone cluster extraction (host side, numpy).

Copies of ``find_clusters``, ``flatten_clusters`` and ``cluster_mask`` from
``nmc_tpu/ops/clusters.py``. Seeds are spins with |marginal| >=
threshold_initial; each unclaimed seed starts a cluster together with its
direct J-neighbors that are also seeds; then the threshold decays by
threshold_step down to threshold_cutoff, each pass absorbing yet-unclaimed
neighbors above the current threshold. (With the reference's shipped
defaults the growth loop body never executes; that quirk is kept, since it
follows from the same arithmetic.)
"""

from __future__ import annotations

from typing import List

import numpy as np


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
