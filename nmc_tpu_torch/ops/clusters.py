"""Backbone clusters and Houdayer disagreement clusters.

The counterpart of ``nmc_tpu/ops/clusters.py``.

Backbones: copies of ``find_clusters``, ``flatten_clusters`` and
``cluster_mask`` (host side, numpy), and the device-side
`backbone_mask_device` in torch. Seeds are spins with |marginal| >=
threshold_initial; each unclaimed seed starts a cluster together with its
direct J-neighbors that are also seeds; then the threshold decays by
threshold_step down to threshold_cutoff, each pass absorbing yet-unclaimed
neighbors above the current threshold. (With the reference's shipped
defaults the growth loop body never executes; that quirk is kept, since it
follows from the same arithmetic.)

Houdayer clusters: the connected components of the J-adjacency subgraph
induced on the spins where two states disagree (s1_i * s2_i == -1).
  * host: `disagreement_clusters` over dense J (scipy) and
    `disagreement_clusters_adj` over a `CSRAdjacency` built once per
    problem (the native C++ union-find, `native/cluster.cpp`), both
    listing the components by smallest member;
  * device (torch), batched over a leading pair axis [P, n]: min-label
    propagation to the fixed point (`_label_fixpoint`), where each
    disagreeing spin ends with the smallest spin index of its component
    and every other spin with n. One propagation step per backend: dense
    adjacency (`disagreement_labels_device`), an edge list
    (`_sparse`), the union block-sparse tiles (`_blocked`) and a
    neighbour index table (`_matmul`, the JAX package's one-hot matmul
    step computed as an integer gather over `NeighborPlanes.index`). All
    reach the same labels; `matmul` runs without pointer jumping, the
    others with it, as in JAX, so a `num_iters` cap gives the same capped
    labels too. `houdayer_move_*` then picks one cluster uniformly and
    exchanges it between the two states, or flips all of s1 when it
    exceeds n // 2 spins (Katzgraber), from uniforms `g` [P, n] that are
    injected or drawn from a `torch.Generator`.

Operands of the device ops (J, edge lists, tiles, index tables) are either
shared by all pairs or carry a leading instance axis, which `group` [P]
(each pair's instance) indexes.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components

from ..native import CSRAdjacency, connected_components_masked
from ..utils.metrics import count, host_sync

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


# ---- Houdayer disagreement clusters: host --------------------------------

def disagreement_clusters(
    J: np.ndarray, s1: np.ndarray, s2: np.ndarray
) -> List[np.ndarray]:
    """Houdayer clusters: connected components where s1 * s2 == -1 (host),
    by scipy's connected_components, listed by smallest member."""
    s1 = np.asarray(s1).reshape(-1)
    s2 = np.asarray(s2).reshape(-1)
    diff = np.flatnonzero(s1 * s2 == -1)
    if diff.size == 0:
        return []
    J = np.asarray(J.toarray() if hasattr(J, "toarray") else J)
    sub = csr_matrix((J[np.ix_(diff, diff)] != 0).astype(np.int8))
    ncomp, labels = connected_components(sub, directed=False)
    return [diff[labels == c] for c in range(ncomp)]


def disagreement_clusters_adj(adj: CSRAdjacency, s1, s2) -> List[np.ndarray]:
    """Houdayer clusters over a prebuilt `CSRAdjacency` by the native C++
    union-find (`native.connected_components_masked`, as the JAX package
    calls it): O(active nodes + incident edges) per call instead of
    re-densifying J. The same partition in the same order (by smallest
    member) as `disagreement_clusters`."""
    s1 = np.asarray(s1).reshape(-1)
    s2 = np.asarray(s2).reshape(-1)
    active = (s1 * s2) < 0
    if not active.any():
        return []
    return connected_components_masked(adj, active)


# ---- Houdayer disagreement clusters: device, batched over pairs ----------

# Pairs per chunk of the blocked propagation are chosen so that its
# [pairs, nB, K, B, B] mask holds at most this many elements.
_BLOCKED_CHUNK_ELEMENTS = 2 ** 26
# Fixed-point steps between two convergence tests (each reads the device).
_CHECK_EVERY = 4


def _pairwise(x, ndim: int, group):
    """Operand `x` for every pair: shared (x.ndim == ndim) gets a leading
    axis of 1; with a leading instance axis, `group` [P] picks each pair's
    instance (None: the leading axis already runs over the pairs)."""
    x = torch.as_tensor(x)
    if x.ndim == ndim:
        return x.unsqueeze(0)
    return x if group is None else x[torch.as_tensor(group).to(x.device)]


def _label_fixpoint(propagate, labels0, diff, max_iters: int, *,
                    jump: bool = True, stats=None):
    """Min-label propagation (+ optional pointer jumping) to a fixed point,
    for a batch of pairs at once. `propagate(labels) -> nbr_min` [P, n]
    gives each spin's minimum neighbour label over the active subgraph.

    A pair at its fixed point does not change under further steps, so the
    batch runs until no pair changes (or `max_iters` steps): every pair ends
    at its own fixed point, or at its labels after `max_iters` steps, as
    the JAX package's per-pair while_loop gives them. The convergence test
    reads the device once every `_CHECK_EVERY` steps. `stats` (a dict)
    receives "steps" (steps run) and "iterations" (the steps the JAX loop
    of the slowest pair counts: up to and including the first step that
    changes nothing, at most `max_iters`). While an engine records a round
    (`utils.metrics.RoundSpans`), the steps run are added to its counter
    "houdayer_steps" (a host integer: no sync)."""
    n = labels0.shape[-1]
    big = n
    labels = labels0
    last = torch.full((), -1, dtype=torch.int64, device=labels0.device)
    it = 0
    while it < max_iters:
        for _ in range(min(_CHECK_EVERY, max_iters - it)):
            new = torch.where(diff, torch.minimum(labels, propagate(labels)),
                              big)
            if jump:
                # pointer jumping: follow the label's own label (component
                # minima only decrease, so the fixed point stays exact)
                safe = new.clamp(max=n - 1).long()
                jumped = torch.where(new < big, new.gather(-1, safe), big)
                new = torch.minimum(new, jumped)
            changed = (new != labels).any()
            last = torch.where(changed, it, last)
            labels = new
            it += 1
        if not host_sync(bool, changed):
            break
    count("houdayer_steps", it)
    if stats is not None:
        stats["steps"] = max(stats.get("steps", 0), it)
        stats["iterations"] = max(stats.get("iterations", 0),
                                  min(host_sync(int, last) + 2, max_iters))
    return labels


def _labels0(s1, s2):
    """(diff [P, n], initial labels [P, n] int32: own index or n)."""
    P, n = s1.shape
    diff = (s1 * s2) < 0
    idx = torch.arange(n, dtype=torch.int32, device=s1.device)
    return diff, torch.where(diff, idx, n).to(torch.int32)


def _cap(num_iters, n):
    return n if num_iters is None else int(num_iters)


def disagreement_labels_device(J, s1, s2, *, num_iters: Optional[int] = None,
                               group=None, stats=None) -> torch.Tensor:
    """Labels [P, n] over dense adjacency J [n, n] (or [I, n, n] with
    `group`): disagreeing spins get the minimum spin index of their
    disagreement component, the others n. Runs to the fixed point;
    `num_iters` only caps the loop (None = n). Holds [P, n, n]: small n."""
    P, n = s1.shape
    diff, labels0 = _labels0(s1, s2)
    adj = _pairwise(J, 2, group) != 0
    adj_diff = adj & diff[:, None, :] & diff[:, :, None]

    def propagate(labels):
        return torch.where(adj_diff, labels[:, None, :], n).amin(dim=2)

    return _label_fixpoint(propagate, labels0, diff, _cap(num_iters, n),
                           stats=stats)


def disagreement_labels_sparse(src, dst, s1, s2, *,
                               num_iters: Optional[int] = None, group=None,
                               stats=None) -> torch.Tensor:
    """Edge-list labels: src, dst [E] (or [I, E] with `group`) directed
    edges, a segment-min per step, O(nnz) memory."""
    P, n = s1.shape
    diff, labels0 = _labels0(s1, s2)
    src = _pairwise(src, 1, group).to(s1.device).long().expand(P, -1)
    dst = _pairwise(dst, 1, group).to(s1.device).long().expand(P, -1)
    edge_active = diff.gather(1, src) & diff.gather(1, dst)

    def propagate(labels):
        cand = torch.where(edge_active, labels.gather(1, src), n)
        return torch.full_like(labels, n).scatter_reduce(
            1, dst, cand, reduce="amin", include_self=True)

    return _label_fixpoint(propagate, labels0, diff, _cap(num_iters, n),
                           stats=stats)


def disagreement_labels_blocked(col_idx, adj_tiles, s1, s2, *,
                                num_iters: Optional[int] = None, group=None,
                                stats=None) -> torch.Tensor:
    """Labels over union block-sparse tiles: col_idx [nB, K] block-column
    ids, adj_tiles [nB, K, B, B] bool (row-block spin i adjacent to
    column-block spin j; or [I, nB, K, B, B] with `group`). Each step is
    one masked min over the tiles. The pairs run in chunks whose
    [pairs, nB, K, B, B] mask stays within `_BLOCKED_CHUNK_ELEMENTS`."""
    P, n = s1.shape
    adj_tiles = torch.as_tensor(adj_tiles)
    nB, K, B = adj_tiles.shape[-4:-1]
    assert n == nB * B, (tuple(s1.shape), tuple(adj_tiles.shape))
    col = torch.as_tensor(col_idx).to(s1.device).long()
    diff, labels0 = _labels0(s1, s2)
    chunk = max(1, _BLOCKED_CHUNK_ELEMENTS // (nB * K * B * B))
    out = []
    for c0 in range(0, P, chunk):
        sl = slice(c0, min(c0 + chunk, P))
        p = sl.stop - sl.start
        if adj_tiles.ndim == 4:
            adj = adj_tiles[None]
        else:
            adj = adj_tiles[sl if group is None
                            else torch.as_tensor(group)[sl].to(
                                adj_tiles.device)]
        dif_c = diff[sl].reshape(p, nB, B)[:, col]            # [p, nB, K, B]
        mask = adj.to(s1.device) & dif_c[:, :, :, None, :]   # [p, nB, K, B, B]

        def propagate(labels, mask=mask, p=p):
            lab_c = labels.reshape(p, nB, B)[:, col]          # [p, nB, K, B]
            cand = torch.where(mask, lab_c[:, :, :, None, :], n)
            return cand.amin(dim=(2, 4)).reshape(p, n)

        out.append(_label_fixpoint(propagate, labels0[sl], diff[sl],
                                   _cap(num_iters, n), stats=stats))
    return torch.cat(out)


class NeighborPlanes:
    """The static adjacency of one blocked instance as an index table for
    `disagreement_labels_matmul`, over the union tiles' column blocks
    (col_idx [nB, K]): `index` [nB, D, B] points, for row r of block i and
    its d-th neighbour, at that neighbour's position k * B + c in block
    i's gathered neighbour labels ("lab_c", [nB, K * B]), or at the
    sentinel K * B (label n) beyond the row's degree. `gather` and `planes`
    give the JAX package's one-hot matmul operands ([nB, K, nB] and
    [nB, D, B, K * B + 1]) computed from it, for comparison; they are not
    kept. `col_idx` and `index` may carry a leading instance axis."""

    def __init__(self, col_idx, index, n_pad: int, block_size: int):
        self.col_idx = col_idx
        self.index = index
        self.n_pad = int(n_pad)
        self.block_size = int(block_size)

    @property
    def degree(self) -> int:
        return self.index.shape[-2]

    @property
    def gather(self) -> np.ndarray:
        col_idx = np.asarray(self.col_idx)
        nB, K = col_idx.shape
        g = np.zeros((nB, K, nB), np.float32)
        g[np.arange(nB)[:, None], np.arange(K)[None, :], col_idx] = 1.0
        return g

    @property
    def planes(self) -> np.ndarray:
        index = np.asarray(self.index)
        nB, D, B = index.shape
        K = np.asarray(self.col_idx).shape[1]
        p = np.zeros((nB, D, B, K * B + 1), np.float32)
        np.put_along_axis(p, index[..., None], 1.0, axis=-1)
        return p


def build_neighbor_planes(col_idx: np.ndarray, J_tiles: np.ndarray,
                          *, max_degree: Optional[int] = None,
                          degree: Optional[int] = None) -> NeighborPlanes:
    """NeighborPlanes of one instance's block-sparse tiles (col_idx
    [nB, K] int32, J_tiles [nB, K, B, B]). `max_degree` (default 16) bounds
    the plane count; a denser instance raises ValueError. `degree` forces
    the plane count (to stack instances of different max degree)."""
    col_idx = np.asarray(col_idx)
    J_tiles = np.asarray(J_tiles)
    nB, K, B, _ = J_tiles.shape
    adj = J_tiles != 0                                   # [nB, K, B, B]
    deg = adj.sum(axis=(1, 3))                           # [nB, B]
    D = int(deg.max()) if deg.size else 0
    cap = 16 if max_degree is None else int(max_degree)
    if D > cap:
        raise ValueError(
            f"max node degree {D} exceeds the neighbor-plane cap {cap}; "
            f"use the sparse Houdayer path for dense instances")
    if degree is not None:
        if degree < D:
            raise ValueError(f"degree={degree} < instance max degree {D}")
        D = int(degree)
    D = max(D, 1)
    # row r of block i: its neighbours in (k, c) order, the d-th at k*B + c
    i, r, q = np.nonzero(adj.transpose(0, 2, 1, 3).reshape(nB, B, K * B))
    first = np.searchsorted(i * B + r, i * B + r)        # start of each row
    d = np.arange(i.size) - first
    index = np.full((nB, D, B), K * B, np.int64)
    index[i, d, r] = q
    return NeighborPlanes(col_idx.astype(np.int32), index, nB * B, B)


def disagreement_labels_matmul(planes: NeighborPlanes, s1, s2, *,
                               num_iters: Optional[int] = None, group=None,
                               stats=None) -> torch.Tensor:
    """Labels over a `NeighborPlanes` index table: per step the row blocks'
    neighbour column blocks are gathered (lab_c), then each row's D
    neighbour labels through `index`, then a min over D. The JAX package
    computes the same two selections as one-hot matmuls; no pointer
    jumping (iterations grow to the component eccentricity), as there."""
    P, n = s1.shape
    if n != planes.n_pad:
        raise ValueError(f"states have {n} spins, planes {planes.n_pad}")
    if n > 65536:
        raise ValueError(f"the neighbor planes support n_pad <= 65536, "
                         f"got {n}")
    B = planes.block_size
    nB = n // B
    col = torch.as_tensor(planes.col_idx).to(s1.device).long()
    K = col.shape[-1]
    D = planes.degree
    idx = _pairwise(planes.index, 3, group).to(s1.device).long()
    idx = idx.reshape(-1, nB, D * B).expand(P, nB, D * B)
    diff, labels0 = _labels0(s1, s2)
    sentinel = torch.full((P, nB, 1), n, dtype=torch.int32, device=s1.device)

    def propagate(labels):
        lab_c = labels.reshape(P, nB, B)[:, col].reshape(P, nB, K * B)
        ext = torch.cat([lab_c, sentinel], dim=2)
        return ext.gather(2, idx).reshape(P, nB, D, B).amin(dim=2).reshape(
            P, n)

    return _label_fixpoint(propagate, labels0, diff, _cap(num_iters, n),
                           jump=False, stats=stats)


def _cluster_uniforms(g, generator, s1):
    """The cluster choice's uniforms [P, n]: injected, or drawn."""
    if g is not None:
        g = torch.as_tensor(g, device=s1.device)
        if tuple(g.shape) != tuple(s1.shape):
            raise ValueError(f"g must be {tuple(s1.shape)}, "
                             f"got {tuple(g.shape)}")
        return g
    if generator is None:
        raise ValueError("pass a torch.Generator or injected uniforms g")
    return torch.rand(tuple(s1.shape), generator=generator, dtype=s1.dtype,
                      device=s1.device)


def _houdayer_from_labels(labels, s1, s2, g, *, use_katzgraber: bool,
                          katzgraber_threshold: Optional[int]):
    """The move of each pair from its labels [P, n]: the cluster whose root
    has the smallest g is chosen (uniform over clusters) and exchanged
    between s1 and s2, or, when it has more than `katzgraber_threshold`
    (default n // 2) spins and `use_katzgraber`, all of s1 is flipped.
    Returns (s1', s2', moved [P], flipped [P])."""
    P, n = s1.shape
    valid = labels < n
    any_diff = valid.any(dim=1)
    is_root = labels == torch.arange(n, device=labels.device)
    scores = torch.where(is_root & valid, g, torch.inf)
    chosen = scores.argmin(dim=1)                    # uniform over clusters
    in_cluster = labels == chosen[:, None]
    size = in_cluster.sum(dim=1)
    thresh = n // 2 if katzgraber_threshold is None else katzgraber_threshold
    big = (size > thresh) & bool(use_katzgraber)
    s1_swap = torch.where(in_cluster, s2, s1)
    s2_swap = torch.where(in_cluster, s1, s2)
    s1_new = torch.where(any_diff[:, None],
                         torch.where(big[:, None], -s1, s1_swap), s1)
    s2_new = torch.where(any_diff[:, None],
                         torch.where(big[:, None], s2, s2_swap), s2)
    return s1_new, s2_new, any_diff & ~big, any_diff & big


def _move(labels_fn, operands, s1, s2, generator, g, num_iters,
          use_katzgraber, katzgraber_threshold, group, stats):
    labels = labels_fn(*operands, s1, s2, num_iters=num_iters, group=group,
                       stats=stats)
    return _houdayer_from_labels(labels, s1, s2,
                                 _cluster_uniforms(g, generator, s1),
                                 use_katzgraber=use_katzgraber,
                                 katzgraber_threshold=katzgraber_threshold)


def houdayer_move_device(J, s1, s2, generator=None, *, g=None,
                         num_iters: Optional[int] = None,
                         use_katzgraber: bool = True,
                         katzgraber_threshold: Optional[int] = None,
                         group=None, stats=None):
    """One Houdayer move per pair [P, n] over dense J: labels to the fixed
    point, one cluster chosen uniformly by `g` (or `generator`) and
    exchanged, or s1 flipped when the cluster exceeds n // 2 spins.
    Returns (s1', s2', moved [P], flipped [P])."""
    return _move(disagreement_labels_device, (J,), s1, s2, generator, g,
                 num_iters, use_katzgraber, katzgraber_threshold, group,
                 stats)


def houdayer_move_sparse(src, dst, s1, s2, generator=None, *, g=None,
                         num_iters: Optional[int] = None,
                         use_katzgraber: bool = True,
                         katzgraber_threshold: Optional[int] = None,
                         group=None, stats=None):
    """`houdayer_move_device` over an edge list (O(nnz) per step)."""
    return _move(disagreement_labels_sparse, (src, dst), s1, s2, generator,
                 g, num_iters, use_katzgraber, katzgraber_threshold, group,
                 stats)


def houdayer_move_blocked(col_idx, adj_tiles, s1, s2, generator=None, *,
                          g=None, num_iters: Optional[int] = None,
                          use_katzgraber: bool = True,
                          katzgraber_threshold: Optional[int] = None,
                          group=None, stats=None):
    """`houdayer_move_device` over union block-sparse tiles."""
    return _move(disagreement_labels_blocked, (col_idx, adj_tiles), s1, s2,
                 generator, g, num_iters, use_katzgraber,
                 katzgraber_threshold, group, stats)


def houdayer_move_matmul(planes, s1, s2, generator=None, *, g=None,
                         num_iters: Optional[int] = None,
                         use_katzgraber: bool = True,
                         katzgraber_threshold: Optional[int] = None,
                         group=None, stats=None):
    """`houdayer_move_device` over a `NeighborPlanes` index table."""
    return _move(disagreement_labels_matmul, (planes,), s1, s2, generator,
                 g, num_iters, use_katzgraber, katzgraber_threshold, group,
                 stats)
