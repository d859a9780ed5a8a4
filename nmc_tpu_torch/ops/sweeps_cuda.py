"""Gibbs sweeps on the card: the CUDA kernels' wrappers and their plain twins.

The counterparts of the three sweep kernels of
``nmc_tpu/ops/sweeps_pallas.py``, each running T sweeps of block-Jacobi
heat-bath Gibbs on a graph-coloured layout with the replica state kept on
chip for the whole launch, and of one XLA function and its `vmap`:

  * `colored_sweeps` (K1, ``pallas_colored_sweeps``): dense J [n_pad, n_pad],
    beta = beta_t * beta_spin, mask [R, n_pad];
  * `colored_sweeps_streamed` (K2, ``pallas_colored_sweeps_streamed``): dense
    J row blocks [nB, B, n_pad], beta = (beta_t * beta_row) * beta_spin with
    beta_spin optional, mask [1 | R, n_pad];
  * `colored_sweeps_sparse` (K3, ``pallas_colored_sweeps_sparse``): K2 over
    each row block's nonzero column tiles (col_idx [nB, K], J_tiles
    [nB, K, B, B] from `block_sparse_tiles`);
  * `sequential_sweeps` (the sequential fixed-order sweep of
    ``nmc_tpu/ops/sweeps.py:run_sweeps``, which JAX ran through XLA) and
    `sequential_sweeps_batched` (the same over an instance axis, as
    JAX's `EnsemblePT` vmaps it): JAX's blocked algorithm in its own
    kernel (csrc/sequential_sweeps.cu): per row block of B spins an
    in-block chain on one warp per replica, the block's [B, B] diagonal
    tile J_diag in shared memory, then one phi update over the block's
    couplings (`sequential_neighbors`: per row block of B its targets and
    their sources, stored rank by rank). Their CPU twin is
    `run_sweeps(within_block="sequential")`; `sequential_sweeps_reference`
    is the plain version with the kernel's association (bit for bit on
    the card, for the tests and chip_smoke.py; no route calls it).

They take the Pallas kernels' arrays and return the same outputs; a
`torch.Generator` stands in for the seed, and optional injected uniforms
[T, R, n_pad] replace the kernels' Philox draws.

The three colored kernels launch one kernel body (csrc/colored_sweeps_nbr.cu) that reads
the couplings only through a `SweepNeighbors` layout: the row blocks cut
into steps (maximal runs of blocks with no coupling between two of them: a
coloured layout's colour classes), per step the targets coupled to it and
per target its sources in the step. It is built once from dense J
(`sweep_neighbors_from_dense`) or from the tiles
(`sweep_neighbors_from_tiles`), which give the same layout for the same
couplings; `SweepEngine` builds it at setup and passes it as `nbrs=`, and a
wrapper called without it builds it. K1 runs P replicas per CTA, sharing
each coupling load, with (P, CTA width) from `k1_launch`; K2 and K3 run one,
with the CTA width from `sweep_threads`. K1 hands the body a beta_spin that
is the same along each row (a scalar, [R, 1]) as the body's beta_row with
no per-spin factor (beta_t * c either way), any other as beta_spin with
beta_row = 1 (beta_t * 1 == beta_t), and a mask that repeats one row
(stride 0) as that row, so the body computes K1's function bit for bit.
`neighbor_sweeps_reference` runs the sweeps in plain torch over the layout
with the kernel's steps and association (for the tests and chip_smoke.py;
no route calls it).

Each takes `record_m=True` to also return the state after every sweep
(M [T, R, n_pad], written by the kernel; the result is then a
`SweepResult`).

On a CPU tensor a wrapper runs its `*_reference`, the same function in plain
torch (K1's from dense J row blocks, the TPU kernel's function), and
launches nothing. On a CUDA tensor it launches the kernel or raises. Each
wrapper counts its kernel launches in `<wrapper>.launches`.

A launch may run a slice of a larger replica ladder (a shard of it on one
rank): `replica_offset` is the global index of its first replica, which
the kernel adds to the replica word of its Philox counter, so that the
slice draws what the whole ladder's launch draws for those rows. On the
CPU a wrapper given a generator and `replicas_total` draws each sweep's
uniforms for the whole ladder, in the order the unsliced call draws them,
and keeps its rows (`sliced_uniforms`); injected uniforms are the slice's
own and the offsets select nothing. `seed=` (int32 [2] on the card) stands
in for the generator's two seed words, for launches whose seeds a caller
draws in one batch.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.energy import energy_from_fields
from ._build import bind, load_library
from .sweeps import SweepResult, _uniforms, heat_bath_update, run_sweeps

_LIB_NBR = "colored_sweeps_nbr"
# Dynamic shared memory one CTA may use on Hopper (227 KB).
MAX_SHARED_BYTES = 232_448
_INT16_MAX = 32767
# The CTA widths K2/K3 are built for, and the threads one Hopper SM holds.
SWEEP_WIDTHS = (256, 512, 1024)
_SM_THREADS = 2048
# K1's CTA widths and replicas per CTA (a width holds at least 32 threads,
# one warp, per replica: warp p sums replica p's energy), and the width its
# launch rule takes (k1_launch).
K1_WIDTHS = (128, 256, 512, 1024)
K1_REPLICAS_PER_CTA = (1, 2, 4, 8)
K1_WIDTH = 512


class ColoredSweepResult(NamedTuple):
    m: torch.Tensor         # [R, n_pad]
    phi: torch.Tensor       # [R, n_pad]
    m_best: torch.Tensor    # [R, n_pad]
    e_best: torch.Tensor    # [R]
    energies: torch.Tensor  # [T, R]


def _result(m, phi, m_best, e_best, energies, M=None):
    """A ColoredSweepResult, or with recorded states M a SweepResult."""
    if M is None:
        return ColoredSweepResult(m, phi, m_best, e_best, energies)
    return SweepResult(m, phi, m_best, e_best, energies, M)


def colored_sweeps_reference(
    J, h, m0, phi0, generator, beta_sweep, beta_spin, update_mask, *,
    num_sweeps: int, block_size: int = 128,
    uniforms: Optional[torch.Tensor] = None, record_m: bool = False,
) -> ColoredSweepResult:
    """Plain-torch colored sweeps: the block-Jacobi engine on J's row blocks."""
    n_pad = J.shape[0]
    if n_pad % block_size:
        raise ValueError("n_pad must be a multiple of block_size")
    res = run_sweeps(
        J.reshape(n_pad // block_size, block_size, n_pad), None, h, m0, phi0,
        generator, beta_sweep, beta_spin, update_mask, num_sweeps=num_sweeps,
        within_block="jacobi", uniforms=uniforms, record_m=record_m)
    return _result(*res)


class SweepNeighbors(NamedTuple):
    """K2/K3's coupling layout. The row blocks are cut into steps, maximal
    runs of consecutive blocks with no coupling between two of them (on a
    colored layout, its colour classes). Per step: the targets j with a
    coupling from a spin of the step (longest source list first, then
    ascending j), and per target its sources k in the step (ascending k)
    with their weights."""
    step_ptr: torch.Tensor  # [n_steps + 1] int32: step s holds row blocks step_ptr[s]:step_ptr[s+1]
    tgt_ptr: torch.Tensor   # [n_steps + 1] int32: step s's targets tgt_ptr[s]:tgt_ptr[s+1]
    tgt: torch.Tensor       # [n_tgt] int16 target spin j
    src_ptr: torch.Tensor   # [n_tgt + 1] int32: target t's sources
    src: torch.Tensor       # [nnz] int16 source spin k
    w: torch.Tensor         # [nnz] J[k, j], in J's dtype
    block_size: int
    n_pad: int


def _pack_neighbors(g, j, src, w, num_groups, width, n_pad):
    """A neighbour layout from entries (group g, target j, source src)
    sorted by (g, j, src), with their weights w [I, nnz]: (tgt_ptr, tgt,
    src_ptr, src, w). Within a group the targets go by source count (at
    most `width`), longest first (then by j), so that the kernels' warps,
    one target per lane, run lists of about equal length; the order of
    targets changes no sum."""
    device = g.device
    nnz = g.numel()
    if n_pad > _INT16_MAX + 1:
        raise ValueError(f"n_pad {n_pad} does not fit the int16 layout")
    starts = torch.ones(nnz, dtype=torch.bool, device=device)
    starts[1:] = (g[1:] != g[:-1]) | (j[1:] != j[:-1])
    first = torch.nonzero(starts).squeeze(1)       # first entry of each target
    count = torch.diff(first, append=torch.tensor([nnz], device=device))
    order = torch.argsort((g[first] * (width + 1) + width - count) * n_pad
                          + j[first])
    first, count = first[order], count[order]
    src_ptr = torch.zeros(first.numel() + 1, dtype=torch.int64, device=device)
    src_ptr[1:] = torch.cumsum(count, 0)
    # the entries of the reordered targets, each target's run kept in order
    entry = (torch.repeat_interleave(first - src_ptr[:-1], count)
             + torch.arange(nnz, device=device))
    tgt_ptr = torch.zeros(num_groups + 1, dtype=torch.int32, device=device)
    tgt_ptr[1:] = torch.cumsum(torch.bincount(g[first], minlength=num_groups),
                               0)
    return (tgt_ptr, j[first].to(torch.int16), src_ptr.to(torch.int32),
            src[entry].to(torch.int16), w[:, entry].contiguous())


def sweep_steps(adj) -> List[int]:
    """Step boundaries [0, ..., nB] over the row blocks, from the blocks'
    coupling pattern adj [nB, nB] (adj[b, c]: a spin of block b couples to
    one of block c). Left to right, a block joins the current step unless
    it couples to a block already in it, so each step is a maximal run of
    consecutive blocks with no coupling between two of them. Couplings
    inside one block (an uncoloured layout) stay in its step, drawn all at
    once as in the block-by-block sweep."""
    adj = np.asarray(adj, dtype=bool)
    b, c = np.nonzero(adj)
    return _pair_steps(torch.as_tensor(b), torch.as_tensor(c), adj.shape[0])


def _pair_steps(b, c, nB) -> List[int]:
    """`sweep_steps` of the pattern given as block pairs (b[e] couples to
    c[e]), without an [nB, nB] array: block c opens a step when the latest
    block before it that it couples to lies in the open step."""
    lo, hi = torch.minimum(b, c).long(), torch.maximum(b, c).long()
    keep = lo < hi
    last = torch.full((nB,), -1, dtype=torch.int64, device=lo.device)
    last.scatter_reduce_(0, hi[keep], lo[keep], reduce="amax")
    bounds = [0]
    for col, prev in enumerate(last.tolist()):
        if col and prev >= bounds[-1]:
            bounds.append(col)
    return bounds + [nB]


def _step_layout(k, j, w, nB, B, steps):
    """(steps, tgt_ptr, tgt, src_ptr, src, w) of the couplings w [I, nnz]
    of (source k, target j) in blocks of B, cut into `steps`, the step
    boundaries over blocks (default `_pair_steps`; returned as a list):
    per step its targets and per target its sources in the step, ascending
    k (`_pack_neighbors`)."""
    n_pad = nB * B
    device = k.device
    if steps is None:
        steps = _pair_steps(k // B, j // B, nB)
    steps = list(steps)
    if steps[0] != 0 or steps[-1] != nB or np.any(np.diff(steps) <= 0):
        raise ValueError(f"steps {steps} do not cut {nB} blocks")
    n_steps = len(steps) - 1
    step_of_block = torch.repeat_interleave(
        torch.arange(n_steps, device=device),
        torch.diff(torch.tensor(steps, device=device)))
    g = step_of_block[k // B]
    order = torch.argsort((g * n_pad + j) * n_pad + k)
    return (steps, *_pack_neighbors(g[order], j[order], k[order],
                                    w[:, order], n_steps, n_pad, n_pad))


def _sweep_neighbors(k, j, w, nB, B, steps) -> SweepNeighbors:
    """The layout of the couplings w of (source k, target j) in blocks of B;
    `steps` gives the step boundaries over blocks (default `sweep_steps`)."""
    steps, tgt_ptr, tgt, src_ptr, src, w = _step_layout(k, j, w[None], nB,
                                                        B, steps)
    return SweepNeighbors(
        step_ptr=torch.tensor(steps, dtype=torch.int32, device=k.device),
        tgt_ptr=tgt_ptr, tgt=tgt, src_ptr=src_ptr, src=src, w=w[0],
        block_size=B, n_pad=nB * B)


def sweep_neighbors_from_dense(J_blocks, *,
                               steps: Optional[Sequence[int]] = None
                               ) -> SweepNeighbors:
    """The layout of dense J row blocks [nB, B, n_pad] (rows are sources)."""
    nB, B, n_pad = J_blocks.shape
    if nB * B != n_pad:
        raise ValueError(f"J_blocks {tuple(J_blocks.shape)} is not square")
    J = J_blocks.reshape(n_pad, n_pad)
    k, j = torch.nonzero(J, as_tuple=True)
    return _sweep_neighbors(k, j, J[k, j], nB, B, steps)


def sweep_neighbors_from_tiles(col_idx, J_tiles, *,
                               steps: Optional[Sequence[int]] = None
                               ) -> SweepNeighbors:
    """The layout of block-sparse tiles J_tiles [nB, K, B, B] over col_idx
    [nB, K]; padding tiles (zero, aliasing column block 0) give no
    entries."""
    nB, K, B, _ = J_tiles.shape
    b, t, kk, jj = torch.nonzero(J_tiles, as_tuple=True)
    j = torch.as_tensor(col_idx, device=b.device).long()[b, t] * B + jj
    return _sweep_neighbors(b * B + kk, j, J_tiles[b, t, kk, jj], nB, B,
                            steps)


def steps_are_independent(nbrs: SweepNeighbors) -> bool:
    """True when no step holds a coupled pair: no target of a step is a
    spin of the step."""
    bounds = nbrs.step_ptr.long() * nbrs.block_size
    counts = torch.diff(nbrs.tgt_ptr.long())
    step = torch.repeat_interleave(
        torch.arange(counts.numel(), device=counts.device), counts)
    j = nbrs.tgt.long()
    return not bool(((j >= bounds[step]) & (j < bounds[step + 1])).any())


def sweep_threads(R: int, num_sms: int) -> int:
    """K2/K3's CTA width for R replicas (one CTA each) on num_sms SMs: the
    widest of SWEEP_WIDTHS at which all R CTAs fit the SMs' threads at once
    (R * width <= num_sms * 2048), else the narrowest."""
    for width in sorted(SWEEP_WIDTHS, reverse=True):
        if R * width <= num_sms * _SM_THREADS:
            return width
    return SWEEP_WIDTHS[0]


def k1_launch(R: int, n_pad: int, num_sms: int) -> Tuple[int, int]:
    """K1's (replicas per CTA P, CTA width) for R replicas at this n_pad on
    num_sms SMs: the fewest replicas per CTA at which the ceil(R / P) CTAs
    need no more than one per SM, else the most that fit shared memory
    (6 P n_pad bytes; P <= 8), at K1_WIDTH threads. From chip_smoke.py
    --sweep-ablation on chimera 8x8 (PERF.md): one CTA of two replicas ran
    faster than two CTAs of one sharing an SM (R = 256 x 500), P = 8 was
    fastest at R = 2048 x 1024, and 512 threads (about one per target of a
    colour class, 244-320 there) at both."""
    fits = [P for P in K1_REPLICAS_PER_CTA
            if _shared_bytes_nbr(n_pad, P) <= MAX_SHARED_BYTES]
    for P in fits:
        if -(-R // P) <= num_sms:
            return P, K1_WIDTH
    return fits[-1], K1_WIDTH


def warp0_energy(h, m, phi):
    """E = -1/2 m.(phi + h) summed as the sweep body's warp p sums replica
    p's (end_of_sweep in colored_sweeps_nbr.cu): lane l adds
    m_j (phi_j + h_j) over j = l, l + 32, ... in order from 0, then an xor
    butterfly over the 32 lanes."""
    R, n_pad = m.shape
    lanes = -(-n_pad // 32)
    x = torch.zeros((R, lanes * 32), dtype=m.dtype, device=m.device)
    x[:, :n_pad] = m * (phi + h)
    x = x.reshape(R, lanes, 32)
    acc = torch.zeros((R, 32), dtype=m.dtype, device=m.device)
    for i in range(lanes):
        acc = acc + x[:, i]
    lane = torch.arange(32, device=m.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ off]
    return -0.5 * acc[:, 0]


def _row_beta_sweeps(phi_update, ranges, h, m0, phi0, generator, beta_sweep,
                     beta_row, mask, beta_spin, num_sweeps, uniforms,
                     energy=energy_from_fields,
                     record_m=False) -> ColoredSweepResult:
    """The streamed kernels' sweep loop in plain torch: per spin range
    (s0, s1) of `ranges` (a block, or a step), all its spins draw at once
    with beta = (beta_t * beta_row) * beta_spin in that order, then
    phi = phi_update(phi, dm, i) for range i; each sweep ends with
    energy(h, m, phi)."""
    R, n_pad = m0.shape
    dtype, device = m0.dtype, m0.device
    if uniforms is not None and tuple(uniforms.shape) != (num_sweeps, R, n_pad):
        raise ValueError(f"uniforms must be [{num_sweeps}, {R}, {n_pad}], "
                         f"got {tuple(uniforms.shape)}")
    beta_sweep = torch.as_tensor(beta_sweep, dtype=dtype,
                                 device=device).expand(num_sweeps)
    beta_row = torch.as_tensor(beta_row, dtype=dtype,
                               device=device).reshape(R, 1)
    mask = torch.as_tensor(mask, device=device)
    mask = (mask if mask.dtype == torch.bool else mask > 0).expand(R, n_pad)
    if beta_spin is not None:
        beta_spin = torch.as_tensor(beta_spin, dtype=dtype,
                                    device=device).expand(R, n_pad)
    h = h.to(dtype)

    m = m0.clone()
    phi = phi0.clone()
    m_best = m0.clone()
    e_best = torch.full((R,), float("inf"), dtype=dtype, device=device)
    energies = torch.empty((num_sweeps, R), dtype=dtype, device=device)
    M = (torch.empty((num_sweeps, R, n_pad), dtype=dtype, device=device)
         if record_m else None)
    for t in range(num_sweeps):
        u = _uniforms(generator, uniforms, t, (R, n_pad), dtype, device)
        beta_tr = beta_sweep[t] * beta_row                       # [R, 1]
        for i, (s0, s1) in enumerate(ranges):
            betab = (beta_tr if beta_spin is None
                     else beta_tr * beta_spin[:, s0:s1])
            mb = m[:, s0:s1]
            mb_new = heat_bath_update(phi[:, s0:s1], betab, u[:, s0:s1], mb,
                                      mask[:, s0:s1])
            phi = phi_update(phi, mb_new - mb, i)
            m[:, s0:s1] = mb_new
        e = energy(h, m, phi)
        better = e < e_best
        m_best = torch.where(better[:, None], m, m_best)
        e_best = torch.where(better, e, e_best)
        energies[t] = e
        if record_m:
            M[t] = m
    return _result(m, phi, m_best, e_best, energies, M)


def colored_sweeps_streamed_reference(
    J_blocks, h, m0, phi0, generator, beta_sweep, beta_row, mask,
    beta_spin=None, *, num_sweeps: int,
    uniforms: Optional[torch.Tensor] = None, record_m: bool = False,
) -> ColoredSweepResult:
    """Plain-torch K2: phi += dm @ J_blocks[b] after each block."""
    nB, B, _ = J_blocks.shape

    def dense(phi, dm, b):
        return phi + torch.matmul(dm, J_blocks[b])

    return _row_beta_sweeps(dense, _block_ranges(nB, B), h, m0, phi0,
                            generator, beta_sweep, beta_row, mask, beta_spin,
                            num_sweeps, uniforms, record_m=record_m)


def _block_ranges(nB, B):
    return [(b * B, (b + 1) * B) for b in range(nB)]


def colored_sweeps_sparse_reference(
    col_idx, J_tiles, h, m0, phi0, generator, beta_sweep, beta_row, mask,
    beta_spin=None, *, num_sweeps: int,
    uniforms: Optional[torch.Tensor] = None, record_m: bool = False,
) -> ColoredSweepResult:
    """Plain-torch K3: after each block, out = dm @ [tile_0 | ... | tile_K-1]
    and phi[:, col block col_idx[b, k]] += out[:, k-th B columns], in tile
    order, as the Pallas kernel adds them."""
    nB, K, B, _ = J_tiles.shape
    J_cat = J_tiles.permute(0, 2, 1, 3).reshape(nB, B, K * B)
    cols = torch.as_tensor(col_idx).reshape(nB, K).tolist()

    def sparse(phi, dm, b):
        out = torch.matmul(dm, J_cat[b])
        for k, c in enumerate(cols[b]):
            phi[:, c * B:(c + 1) * B] += out[:, k * B:(k + 1) * B]
        return phi

    return _row_beta_sweeps(sparse, _block_ranges(nB, B), h, m0, phi0,
                            generator, beta_sweep, beta_row, mask, beta_spin,
                            num_sweeps, uniforms, record_m=record_m)


def neighbor_sweeps_reference(
    nbrs, h, m0, phi0, generator, beta_sweep, beta_row, mask,
    beta_spin=None, *, num_sweeps: int,
    uniforms: Optional[torch.Tensor] = None, record_m: bool = False,
) -> ColoredSweepResult:
    """Plain-torch K2/K3 over a `SweepNeighbors` layout with the kernel's
    steps and association: per step every spin draws at once, then per
    target acc = phi[j], acc = acc + dm_k * w_kj over its sources in
    ascending k (dm_k in {0, +-2}, so each product is exact and the
    kernel's fmaf rounds as this sum does; a zero dm adds a zero), and the
    energies in warp 0's order (`warp0_energy`), so that in f32 it equals
    the kernel bit for bit. Vectorised over a step's targets by source
    rank. For the tests and chip_smoke.py; no route calls it."""
    B = nbrs.block_size
    dtype = m0.dtype
    steps = nbrs.step_ptr.tolist()
    tgt_ptr = nbrs.tgt_ptr.tolist()
    src_ptr = nbrs.src_ptr.long()
    counts = src_ptr[1:] - src_ptr[:-1]
    ranges, plans = [], []
    for s in range(len(steps) - 1):
        s0, s1 = steps[s] * B, steps[s + 1] * B
        t0, t1 = tgt_ptr[s], tgt_ptr[s + 1]
        D = int(counts[t0:t1].max()) if t1 > t0 else 0
        # the sources of the step's targets, padded to D with weight 0
        d = torch.arange(D, device=m0.device)
        e = src_ptr[t0:t1, None] + d
        live = d < counts[t0:t1, None]
        e = torch.where(live, e, 0)
        idx = torch.where(live, nbrs.src.long()[e] - s0, 0)
        wt = torch.where(live, nbrs.w.to(dtype)[e], 0)
        ranges.append((s0, s1))
        plans.append((nbrs.tgt.long()[t0:t1], idx, wt))

    def gather(phi, dm, s):
        tgt, idx, wt = plans[s]
        acc = phi[:, tgt]
        for d in range(idx.shape[1]):
            acc = acc + dm[:, idx[:, d]] * wt[:, d]
        phi[:, tgt] = acc
        return phi

    return _row_beta_sweeps(gather, ranges, h, m0, phi0, generator,
                            beta_sweep, beta_row, mask, beta_spin, num_sweeps,
                            uniforms, energy=warp0_energy, record_m=record_m)


# argument kinds of each C entry point, in order ('p' pointer, 'i' int); the
# CUDA stream follows as one more pointer. The three take the neighbour
# layout (6 pointers) and the same sweep arguments (M last of the
# pointers, null unless recorded); K1 also the replicas per CTA; the
# replica offset is the last int of each. The sequential sweeps
# (csrc/sequential_sweeps.cu) take their layout (4 pointers), the weights
# and the tiles, the same sweep arguments (M the last pointer), and the
# replica and instance offsets last.
_SIGNATURES = {"colored_sweeps_f32": "p" * 21 + "i" * 9,
               "colored_sweeps_streamed_f32": "p" * 21 + "i" * 8,
               "colored_sweeps_sparse_f32": "p" * 21 + "i" * 8}
_SEQ_SIGNATURES = {"sequential_sweeps_f32": "p" * 23 + "i" * 10}


def _bind(lib, fn: str = "colored_sweeps_f32"):
    return bind(lib, fn, _SIGNATURES[fn])


def _check(name, x, shape, dtype, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _broadcast(name, x, shape, dtype, device):
    """Materialise a broadcastable argument (0-d, [R, 1], expand views)."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    else:
        x = torch.as_tensor(x, dtype=dtype, device=device)
    return x.expand(shape).contiguous()


def _mask_rows(mask, R, n_pad, device):
    """A [1 | R, n_pad] bool mask, materialised; returns (mask, rows). A
    mask that repeats one row (an expand view, row stride 0) is that row."""
    rows = mask.shape[0] if getattr(mask, "ndim", 0) == 2 else 1
    if rows > 1 and isinstance(mask, torch.Tensor) and mask.stride(0) == 0:
        mask, rows = mask[:1], 1
    if rows not in (1, R):
        raise ValueError(f"mask must have 1 or {R} rows, got {rows}")
    return _broadcast("mask", mask, (rows, n_pad), torch.bool, device), rows


def _check_shared(name, nbytes):
    if nbytes > MAX_SHARED_BYTES:
        raise ValueError(f"{name} needs {nbytes} bytes of shared memory per "
                         f"replica, above the {MAX_SHARED_BYTES} a CTA has")


def draw_seeds(generator, shape=()) -> torch.Tensor:
    """Seed word pairs [*shape, 2] int32 drawn where the generator lives:
    what a launch draws for itself, for a batch of launches at once."""
    return torch.randint(0, 2 ** 31 - 1, tuple(shape) + (2,),
                         generator=generator, dtype=torch.int32,
                         device=generator.device)


def _seed(generator, uniforms, shape, device, seed=None):
    """None with injected uniforms (checked), else two seed words (`seed`,
    or drawn where the generator lives) read by the kernel from device
    memory: no host sync before the launch."""
    if uniforms is not None:
        _check("uniforms", uniforms, shape, torch.float32, device)
        return None
    if seed is not None:
        _check("seed", seed, (2,), torch.int32, device)
        return seed
    if generator is None:
        raise ValueError("pass a torch.Generator or injected uniforms")
    return draw_seeds(generator).to(device, non_blocking=True)


def sliced_uniforms(generator, lead, axes, n_pad, dtype, device):
    """The uniforms of a slice of a larger launch, drawn on the CPU as the
    whole launch draws them: per index of `lead` (sweeps, or phases x
    sweeps), in order, one [*totals, n_pad] draw of which the slice's rows
    are kept. `axes` holds (offset, count, total) per sliced axis."""
    totals = tuple(t for _, _, t in axes)
    rows = tuple(slice(o, o + c) for o, c, _ in axes)
    out = torch.empty(tuple(lead) + tuple(c for _, c, _ in axes) + (n_pad,),
                      dtype=dtype, device=device)
    for k in itertools.product(*map(range, lead)):
        out[k] = torch.rand(totals + (n_pad,), generator=generator,
                            dtype=dtype, device=device)[rows]
    return out


def slice_axis(name, offset, count, total):
    """(offset, count, total) of a launch's slice of an axis, checked; total
    None means the slice ends the axis."""
    total = offset + count if total is None else total
    if offset < 0 or offset + count > total:
        raise ValueError(f"{name}: rows [{offset}, {offset + count}) do not "
                         f"lie in [0, {total})")
    return offset, count, total


def _cpu_uniforms(generator, uniforms, seed, lead, axes, n_pad, dtype,
                  device):
    """A CPU twin's uniforms: injected, else None (the twin draws them
    itself) for a whole launch, else the slice's `sliced_uniforms`."""
    if seed is not None:
        raise ValueError("seed= is for CUDA launches; on the CPU pass a "
                         "generator or uniforms")
    if uniforms is not None or all(c == t for _, c, t in axes):
        return uniforms
    if generator is None:
        raise ValueError("pass a torch.Generator or injected uniforms")
    return sliced_uniforms(generator, lead, axes, n_pad, dtype, device)


def _outputs(m0, num_sweeps, record_m=False):
    R, n_pad = m0.shape
    f32 = dict(dtype=torch.float32, device=m0.device)
    return SweepResult(
        m=torch.empty_like(m0), phi=torch.empty_like(m0),
        m_best=torch.empty_like(m0), e_best=torch.empty((R,), **f32),
        energies=torch.empty((num_sweeps, R), **f32),
        M=(torch.empty((num_sweeps, R, n_pad), **f32) if record_m
           else None))


def _ptr(x):
    return x.data_ptr() if x is not None else None


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _require_cuda(x, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")


def colored_sweeps(
    J,            # [n_pad, n_pad] float32, colored layout (zero diagonal blocks)
    h,            # [n_pad]
    m0,           # [R, n_pad] in {-1, +1}
    phi0,         # [R, n_pad]
    generator,    # torch.Generator the seed is drawn from (None with uniforms)
    beta_sweep,   # [T] or scalar
    beta_spin,    # broadcastable to [R, n_pad]
    update_mask,  # broadcastable to [R, n_pad] bool
    *,
    num_sweeps: int,
    block_size: int = 128,
    uniforms: Optional[torch.Tensor] = None,   # [T, R, n_pad] injected draws
    nbrs: Optional[SweepNeighbors] = None,     # J's layout (built if None)
    threads: Optional[int] = None,             # CTA width (k1_launch)
    replicas_per_cta: Optional[int] = None,    # P (k1_launch)
    record_m: bool = False,                    # also return M [T, R, n_pad]
    replica_offset: int = 0,                   # global index of row 0
    replicas_total: Optional[int] = None,      # the whole ladder's R
    seed: Optional[torch.Tensor] = None,       # int32 [2] (CUDA)
) -> ColoredSweepResult:
    """T colored heat-bath sweeps (K1); the CUDA kernel on CUDA tensors, the
    plain torch version on CPU tensors (which ignores `nbrs`, `threads` and
    `replicas_per_cta`)."""
    rows = slice_axis("replicas", replica_offset, m0.shape[0], replicas_total)
    if m0.device.type == "cpu":
        return colored_sweeps_reference(
            J, h, m0, phi0, generator, beta_sweep, beta_spin, update_mask,
            num_sweeps=num_sweeps, block_size=block_size,
            uniforms=_cpu_uniforms(generator, uniforms, seed, (num_sweeps,),
                                   (rows,), m0.shape[1], m0.dtype, m0.device),
            record_m=record_m)
    _require_cuda(m0, "colored_sweeps")
    device = m0.device
    n_pad = J.shape[0]
    R = m0.shape[0]
    if n_pad % block_size:
        raise ValueError("n_pad must be a multiple of block_size")
    _check("J", J, (n_pad, n_pad), torch.float32, device)
    if nbrs is None:
        nbrs = sweep_neighbors_from_dense(
            J.reshape(n_pad // block_size, block_size, n_pad))
    beta_row, beta_spin = _k1_betas(beta_spin, R, n_pad, device)
    P, width = _k1_shape(R, n_pad, device, replicas_per_cta, threads)
    out = _launch_nbr("colored_sweeps_f32", nbrs, block_size, h, m0, phi0,
                      generator, beta_sweep, beta_row, update_mask, beta_spin,
                      num_sweeps, uniforms, width, P, record_m=record_m,
                      replica_offset=replica_offset, seed=seed)
    colored_sweeps.launches += 1
    return _result(*out)


def _k1_shape(R, n_pad, device, replicas_per_cta, threads):
    """(P, width) of a K1-shaped launch: `k1_launch`'s unless given."""
    P, width = k1_launch(R, n_pad, _num_sms(device))
    P = P if replicas_per_cta is None else replicas_per_cta
    width = width if threads is None else threads
    if P not in K1_REPLICAS_PER_CTA or width not in K1_WIDTHS \
            or width < 32 * P:
        raise ValueError(f"K1 takes replicas_per_cta in {K1_REPLICAS_PER_CTA} "
                         f"and threads in {K1_WIDTHS}, at least 32 per "
                         f"replica; got {P} and {width}")
    return P, width


def _k1_betas(beta_spin, rows, n_pad, device):
    """A beta_spin broadcastable to [*rows, n_pad] (rows: R, or the
    sequential kernel's (I, R)) as the kernels' (beta_row [prod(rows)],
    beta_spin [prod(rows), n_pad] or None). A factor that is the same along
    each row (a scalar, 0-d, [..., 1]) becomes beta_row with no per-spin
    factor (beta_t * c either way); else beta_row is 1 and beta_spin is
    materialised ((beta_t * 1) * b == beta_t * b)."""
    rows = (rows,) if isinstance(rows, int) else tuple(rows)
    n = int(np.prod(rows))
    x = (beta_spin if isinstance(beta_spin, torch.Tensor)
         else torch.as_tensor(beta_spin, dtype=torch.float32, device=device))
    if x.ndim == 0 or x.shape[-1] == 1:
        return _broadcast("beta_spin", x.expand(*rows, 1)[..., 0], rows,
                          torch.float32, device).reshape(n), None
    return (torch.ones((n,), dtype=torch.float32, device=device),
            _broadcast("beta_spin", x, rows + (n_pad,), torch.float32,
                       device).reshape(n, n_pad))


def _row_beta_args(h, m0, phi0, beta_sweep, beta_row, mask, beta_spin,
                   num_sweeps, n_pad, device):
    """Checked and materialised inputs shared by K2 and K3."""
    f32 = torch.float32
    R = m0.shape[0]
    _check("h", h, (n_pad,), f32, device)
    _check("m0", m0, (R, n_pad), f32, device)
    _check("phi0", phi0, (R, n_pad), f32, device)
    beta_sweep = _broadcast("beta_sweep", beta_sweep, (num_sweeps,), f32, device)
    if isinstance(beta_row, torch.Tensor):
        beta_row = beta_row.reshape(-1)
    beta_row = _broadcast("beta_row", beta_row, (R,), f32, device)
    mask, rows = _mask_rows(mask, R, n_pad, device)
    if beta_spin is not None:
        beta_spin = _broadcast("beta_spin", beta_spin, (R, n_pad), f32, device)
    return beta_sweep, beta_row, mask, rows, beta_spin


def _check_sweep_neighbors(nbrs, n_pad, B, device):
    if not isinstance(nbrs, SweepNeighbors):
        raise TypeError("nbrs must be a SweepNeighbors")
    if nbrs.block_size != B:
        raise ValueError(f"nbrs has block_size {nbrs.block_size}, expected {B}")
    n_steps = nbrs.step_ptr.shape[0] - 1
    n_tgt, nnz = nbrs.tgt.shape[0], nbrs.src.shape[0]
    if not 1 <= n_steps <= n_pad // B:
        raise ValueError(f"nbrs has {n_steps} steps for {n_pad // B} blocks")
    if nbrs.n_pad != n_pad:
        raise ValueError(f"nbrs is for n_pad {nbrs.n_pad}, not {n_pad}")
    _check("nbrs.step_ptr", nbrs.step_ptr, (n_steps + 1,), torch.int32, device)
    _check("nbrs.tgt_ptr", nbrs.tgt_ptr, (n_steps + 1,), torch.int32, device)
    _check("nbrs.tgt", nbrs.tgt, (n_tgt,), torch.int16, device)
    _check("nbrs.src_ptr", nbrs.src_ptr, (n_tgt + 1,), torch.int32, device)
    _check("nbrs.src", nbrs.src, (nnz,), torch.int16, device)
    _check("nbrs.w", nbrs.w, (nnz,), torch.float32, device)


@functools.lru_cache(maxsize=None)
def _num_sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _shared_bytes_nbr(n_pad, replicas=1):
    """The sweep body's dynamic shared memory per CTA: phi (f32), m and dm
    (int8) of each of its replicas."""
    return 6 * n_pad * replicas


def _launch_nbr(fn, nbrs, B, h, m0, phi0, generator, beta_sweep, beta_row,
                mask, beta_spin, num_sweeps, uniforms, threads, replicas=None,
                record_m=False, replica_offset=0, seed=None) -> SweepResult:
    """Check the arguments and launch entry point `fn` over the layout:
    K2 or K3 (replicas None: one replica per CTA, `threads` per CTA, default
    `sweep_threads`), or K1 with `replicas` per CTA and `threads` given. M is None unless `record_m`."""
    device = m0.device
    R, n_pad = m0.shape
    _check_sweep_neighbors(nbrs, n_pad, B, device)
    beta_sweep, beta_row, mask, rows, beta_spin = _row_beta_args(
        h, m0, phi0, beta_sweep, beta_row, mask, beta_spin, num_sweeps, n_pad,
        device)
    _check_shared(fn, _shared_bytes_nbr(n_pad, replicas or 1))
    if replicas is None:
        if threads is None:
            threads = sweep_threads(R, _num_sms(device))
        if threads not in SWEEP_WIDTHS:
            raise ValueError(f"threads must be one of {SWEEP_WIDTHS}, "
                             f"got {threads}")
    seed = _seed(generator, uniforms, (num_sweeps, R, n_pad), device, seed)

    lib = _bind(load_library(_LIB_NBR), fn)
    out = _outputs(m0, num_sweeps, record_m)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, fn)(
        nbrs.step_ptr.data_ptr(), nbrs.tgt_ptr.data_ptr(), nbrs.tgt.data_ptr(),
        nbrs.src_ptr.data_ptr(), nbrs.src.data_ptr(), nbrs.w.data_ptr(),
        h.data_ptr(), m0.data_ptr(), phi0.data_ptr(), _ptr(beta_spin),
        mask.data_ptr(), beta_sweep.data_ptr(), beta_row.data_ptr(),
        _ptr(uniforms), _ptr(seed), out.m.data_ptr(), out.phi.data_ptr(),
        out.m_best.data_ptr(), out.e_best.data_ptr(), out.energies.data_ptr(),
        _ptr(out.M), R, n_pad, B, num_sweeps, rows, nbrs.step_ptr.shape[0] - 1, threads,
        *(() if replicas is None else (replicas,)), replica_offset, stream)
    _raise_on(err, fn)
    return out


def colored_sweeps_streamed(
    J_blocks,     # [nB, B, n_pad] float32 row blocks of the colored layout
    h,            # [n_pad]
    m0,           # [R, n_pad] in {-1, +1}
    phi0,         # [R, n_pad]
    generator,    # torch.Generator the seed is drawn from (None with uniforms)
    beta_sweep,   # [T] or scalar
    beta_row,     # [R] per-replica beta multiplier
    mask,         # [1, n_pad] activity, or [R, n_pad] per-chain mask (bool)
    beta_spin=None,  # [R, n_pad] per-spin beta multiplier, or None
    *,
    num_sweeps: int,
    uniforms: Optional[torch.Tensor] = None,   # [T, R, n_pad] injected draws
    nbrs: Optional[SweepNeighbors] = None,     # J's layout (built if None)
    threads: Optional[int] = None,             # CTA width (sweep_threads)
    record_m: bool = False,                    # also return M [T, R, n_pad]
    replica_offset: int = 0,                   # global index of row 0
    replicas_total: Optional[int] = None,      # the whole ladder's R
    seed: Optional[torch.Tensor] = None,       # int32 [2] (CUDA)
) -> ColoredSweepResult:
    """T colored heat-bath sweeps with per-replica beta over dense J row
    blocks (K2); the CUDA kernel on CUDA tensors, the plain torch version
    on CPU tensors (which ignores `nbrs` and `threads`)."""
    rows = slice_axis("replicas", replica_offset, m0.shape[0], replicas_total)
    if m0.device.type == "cpu":
        return colored_sweeps_streamed_reference(
            J_blocks, h, m0, phi0, generator, beta_sweep, beta_row, mask,
            beta_spin, num_sweeps=num_sweeps, uniforms=_cpu_uniforms(
                generator, uniforms, seed, (num_sweeps,), (rows,),
                m0.shape[1], m0.dtype, m0.device),
            record_m=record_m)
    _require_cuda(m0, "colored_sweeps_streamed")
    nB, B, n_pad = J_blocks.shape
    if nB * B != n_pad:
        raise ValueError(f"J_blocks {tuple(J_blocks.shape)} is not square")
    _check("J_blocks", J_blocks, (nB, B, n_pad), torch.float32, m0.device)
    if nbrs is None:
        nbrs = sweep_neighbors_from_dense(J_blocks)
    out = _launch_nbr("colored_sweeps_streamed_f32", nbrs, B, h, m0, phi0,
                      generator, beta_sweep, beta_row, mask, beta_spin,
                      num_sweeps, uniforms, threads, record_m=record_m,
                      replica_offset=replica_offset, seed=seed)
    colored_sweeps_streamed.launches += 1
    return _result(*out)


def colored_sweeps_sparse(
    col_idx,      # [nB, K] int32 nonzero column-tile indices per row block
    J_tiles,      # [nB, K, B, B] float32 (padding tiles are zero, col 0)
    h,            # [n_pad]
    m0,           # [R, n_pad] in {-1, +1}
    phi0,         # [R, n_pad]
    generator,    # torch.Generator the seed is drawn from (None with uniforms)
    beta_sweep,   # [T] or scalar
    beta_row,     # [R] per-replica beta multiplier
    mask,         # [1, n_pad] activity, or [R, n_pad] per-chain mask (bool)
    beta_spin=None,  # [R, n_pad] per-spin beta multiplier, or None
    *,
    num_sweeps: int,
    uniforms: Optional[torch.Tensor] = None,   # [T, R, n_pad] injected draws
    nbrs: Optional[SweepNeighbors] = None,     # the tiles' layout (built if None)
    threads: Optional[int] = None,             # CTA width (sweep_threads)
    record_m: bool = False,                    # also return M [T, R, n_pad]
    replica_offset: int = 0,                   # global index of row 0
    replicas_total: Optional[int] = None,      # the whole ladder's R
    seed: Optional[torch.Tensor] = None,       # int32 [2] (CUDA)
) -> ColoredSweepResult:
    """T colored heat-bath sweeps with per-replica beta over the block-sparse
    tiles of J (K3); the CUDA kernel on CUDA tensors, the plain torch
    version on CPU tensors (which ignores `nbrs` and `threads`)."""
    rows = slice_axis("replicas", replica_offset, m0.shape[0], replicas_total)
    if m0.device.type == "cpu":
        return colored_sweeps_sparse_reference(
            col_idx, J_tiles, h, m0, phi0, generator, beta_sweep, beta_row,
            mask, beta_spin, num_sweeps=num_sweeps, uniforms=_cpu_uniforms(
                generator, uniforms, seed, (num_sweeps,), (rows,),
                m0.shape[1], m0.dtype, m0.device),
            record_m=record_m)
    _require_cuda(m0, "colored_sweeps_sparse")
    device = m0.device
    nB, K, B, _ = J_tiles.shape
    _check("col_idx", col_idx, (nB, K), torch.int32, device)
    _check("J_tiles", J_tiles, (nB, K, B, B), torch.float32, device)
    if nbrs is None:
        nbrs = sweep_neighbors_from_tiles(col_idx, J_tiles)
    out = _launch_nbr("colored_sweeps_sparse_f32", nbrs, B, h, m0, phi0,
                      generator, beta_sweep, beta_row, mask, beta_spin,
                      num_sweeps, uniforms, threads, record_m=record_m,
                      replica_offset=replica_offset, seed=seed)
    colored_sweeps_sparse.launches += 1
    return _result(*out)


# ---- the sequential sweeps (csrc/sequential_sweeps.cu) ----------------------

_LIB_SEQ = "sequential_sweeps"
# Replicas per CTA (one warp each runs its in-block chain) the kernel is
# built for, its CTA width (every thread joins the phi update), and the
# largest block it takes (four spins a lane): a layout in larger blocks
# runs in sub-blocks (`sequential_block`).
SEQ_REPLICAS_PER_CTA = (1, 2, 4, 8, 16)
SEQ_WIDTH = 512
SEQ_MAX_BLOCK = 128


def sequential_block(block_size: int) -> int:
    """The kernel's block for a layout in blocks of `block_size`: the
    largest divisor of it up to SEQ_MAX_BLOCK. The sweep is the same
    fixed-order chain in any blocks; only the sums' association follows
    the blocks (`sequential_sweeps_reference`)."""
    return max(d for d in range(1, min(block_size, SEQ_MAX_BLOCK) + 1)
               if block_size % d == 0)


def _sub_blocks(J_rows, J_diag):
    """Row blocks [..., nB, B, n_pad] and diagonal tiles [..., nB, B, B]
    in the kernel's blocks (`sequential_block`): views, and the sub-blocks'
    own diagonal tiles, of the given ones (either may be None)."""
    x = J_rows if J_rows is not None else J_diag
    *lead, nB, B = x.shape[:-1]
    Bk = sequential_block(B)
    if Bk == B:
        return J_rows, J_diag
    S = B // Bk
    if J_rows is not None:
        J_rows = J_rows.reshape(*lead, nB * S, Bk, J_rows.shape[-1])
    if J_diag is not None:
        d = torch.diagonal(J_diag.reshape(*lead, nB, S, Bk, S, Bk),
                           dim1=-4, dim2=-2)            # [..., nB, Bk, Bk, S]
        J_diag = d.movedim(-1, -3).reshape(*lead, nB * S, Bk,
                                           Bk).contiguous()
    return J_rows, J_diag


class SequentialNeighbors(NamedTuple):
    """The sequential kernel's coupling layout over row blocks of B spins.
    Per block b: its targets tgt[tgt_ptr[b]:tgt_ptr[b+1]] (the spins j with
    a coupling from a spin of b, longest source list first, then ascending
    j) and its entries [ell_ptr[b], ell_ptr[b+1]), D_b ranks of n_tgt_b
    entries each: entry ell_ptr[b] + d n_tgt_b + i is the d-th source
    (offset k - b B, ascending) of the block's i-th target, or padding
    (source 0, weight 0 in every instance) past its last, so that threads
    owning consecutive targets read consecutive entries. A block whose
    couplings fill at least half of its [targets, sources] rectangle is
    stored dense (`dense[b]`): rank d is source offset d for every target,
    with weight 0 where there is no coupling, so that the kernel needs no
    source lookup there (every sum is the same: a zero weight adds
    fmaf(dm, 0, acc) = acc). Weights [I, n_ell] follow the entries (0
    where an instance lacks a union coupling). For the in-block chain,
    byte s of next_coupled[b, l] is the first spin of block b after its
    spin kS l + s (lane l's slot s, kS = ceil(B / 32)) that the union
    pattern couples to it, or B: a round of the chain keeps flips up to
    the first spin coupled to a kept one."""
    tgt_ptr: torch.Tensor  # [nB + 1] int32
    tgt: torch.Tensor      # [n_tgt] int16 target spin j
    ell_ptr: torch.Tensor  # [nB + 1] int32 block b's entries
    src: torch.Tensor      # [n_ell] int16 source offset k - b * B
    dense: torch.Tensor    # [nB] uint8: block b stored dense
    w: torch.Tensor        # [I, n_ell] J[i, k, j], in J's dtype
    block_size: int
    next_coupled: torch.Tensor  # [nB, 32] int32 (four bytes a lane)


def _next_coupled(J_rows):
    """`SequentialNeighbors.next_coupled` of row blocks [I, nB, B, n_pad],
    over the union pattern of the diagonal tiles."""
    I, nB, B, n_pad = J_rows.shape
    kS = -(-B // 32)
    tiles = torch.diagonal(J_rows.reshape(I, nB, B, nB, B), dim1=1, dim2=3)
    after = torch.triu((tiles != 0).any(0).permute(2, 0, 1), 1)  # [nB, k, j]
    first = torch.where(after.any(-1), after.int().argmax(-1), B)
    nxt = torch.full((nB, 32 * kS), B, dtype=torch.int64,
                     device=J_rows.device)
    nxt[:, :B] = first
    shift = 8 * torch.arange(kS, device=J_rows.device)
    words = (nxt.reshape(nB, 32, kS) << shift).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)


def sequential_neighbors(J_rows) -> SequentialNeighbors:
    """The sequential kernel's layout of J's row blocks [nB, B, n_pad] (or
    an ensemble's [I, nB, B, n_pad], over the union pattern; I = 1 for one
    instance): per block the targets with a coupling from it and their
    sources in it, stored rank by rank (`SequentialNeighbors`), weights in J's
    dtype, in the kernel's blocks (`sequential_block`)."""
    if J_rows.ndim == 3:
        J_rows = J_rows[None]
    J_rows, _ = _sub_blocks(J_rows, None)
    I, nB, B, n_pad = J_rows.shape
    if nB * B != n_pad:
        raise ValueError(f"J_rows {tuple(J_rows.shape)} is not square")
    union = (J_rows != 0).any(0).transpose(1, 2)        # [nB, n_pad, B]
    b, j, kk = torch.nonzero(union.contiguous(), as_tuple=True)
    tgt_ptr, tgt, src_ptr, src, w = _pack_neighbors(
        b, j, kk, J_rows[:, b, kk, j], nB, B, n_pad)
    device = J_rows.device
    counts = torch.diff(src_ptr.long())
    bounds, starts = tgt_ptr.tolist(), src_ptr.tolist()
    ell_ptr, srcs, ws, dense = [0], [], [], []
    for blk in range(nB):
        t0, t1 = bounds[blk], bounds[blk + 1]
        nt, c = t1 - t0, counts[t0:t1]
        top = int(src[starts[t0]:starts[t1]].max()) + 1 if nt else 0
        if int(c.sum()) * 2 >= nt * top:      # dense: rank d = offset d
            D = top
            d = torch.arange(D, device=device)
            srcs.append(d[:, None].expand(D, nt).reshape(-1))
            ws.append(J_rows[:, blk, :D][:, :, tgt[t0:t1].long()]
                      .reshape(I, -1))
        else:                                 # ranks, padded with zeros
            D = int(c.max())
            d = torch.arange(D, device=device)[:, None]     # [D, nt]
            e = torch.where(d < c[None, :],
                            src_ptr[t0:t1].long()[None, :] + d, -1)
            e = e.reshape(-1)
            pad = e < 0
            e = e.clamp(min=0)
            srcs.append(torch.where(pad, 0, src[e].long()))
            ws.append(torch.where(pad, 0, w[:, e]))
        dense.append(D == top and nt > 0)
        ell_ptr.append(ell_ptr[-1] + D * nt)
    return SequentialNeighbors(
        tgt_ptr=tgt_ptr, tgt=tgt,
        ell_ptr=torch.tensor(ell_ptr, dtype=torch.int32, device=device),
        src=torch.cat(srcs).to(torch.int16),
        dense=torch.tensor(dense, dtype=torch.uint8, device=device),
        w=torch.cat(ws, dim=1).contiguous(), block_size=B,
        next_coupled=_next_coupled(J_rows))


def _check_sequential_neighbors(nbrs, I, n_pad, B, device):
    if not isinstance(nbrs, SequentialNeighbors):
        raise TypeError("nbrs must be a SequentialNeighbors")
    if nbrs.block_size != B:
        raise ValueError(f"nbrs has block_size {nbrs.block_size}, expected {B}")
    n_tgt, n_ell = nbrs.tgt.shape[0], nbrs.src.shape[0]
    _check("nbrs.tgt_ptr", nbrs.tgt_ptr, (n_pad // B + 1,), torch.int32,
           device)
    _check("nbrs.tgt", nbrs.tgt, (n_tgt,), torch.int16, device)
    _check("nbrs.ell_ptr", nbrs.ell_ptr, (n_pad // B + 1,), torch.int32,
           device)
    _check("nbrs.src", nbrs.src, (n_ell,), torch.int16, device)
    _check("nbrs.dense", nbrs.dense, (n_pad // B,), torch.uint8, device)
    _check("nbrs.w", nbrs.w, (I, n_ell), torch.float32, device)
    _check("nbrs.next_coupled", nbrs.next_coupled, (n_pad // B, 32),
           torch.int32, device)


def _seq_shared_bytes(n_pad, B, P, n_buf):
    """The sequential kernel's dynamic shared memory per CTA: n_buf [B, B]
    f32 tiles, phi (f32) and m (int8) of each of its P replicas, dm
    [B, P] (f32) and two [B] u32 flip masks."""
    return 4 * (n_buf * B * B + P * n_pad + B * P + 2 * B) + P * n_pad


def sequential_kernel_limit(n_pad: int, block_size: int) -> Optional[str]:
    """Why the sequential kernel cannot take n_pad spins in blocks of
    `block_size` (run in `sequential_block`s), or None when it can: the
    layout's int16 spin indices and one replica with one tile in a CTA's
    shared memory."""
    if n_pad > _INT16_MAX + 1:
        return (f"n_pad {n_pad} > {_INT16_MAX + 1}, the int16 spin indices "
                "of the sequential kernel's layout")
    nbytes = _seq_shared_bytes(n_pad, sequential_block(block_size), 1, 1)
    if nbytes > MAX_SHARED_BYTES:
        return (f"n_pad {n_pad} needs {nbytes} bytes of shared memory per "
                f"CTA, above the {MAX_SHARED_BYTES} a CTA has")
    return None


def sequential_launch(I: int, R: int, n_pad: int, B: int,
                      num_sms: int) -> Tuple[int, int]:
    """(replicas per CTA P, tile buffers) of a sequential launch of I
    instances x R replicas of a layout in blocks of B (run in
    `sequential_block`s) on num_sms SMs: the fewest replicas per CTA at
    which the I * ceil(R / P) CTAs need no more than one per SM, else the
    most that fit shared memory (fewer CTAs, each weight load shared by
    more chains), as `k1_launch` chooses; then two tile buffers where they
    fit, else one."""
    limit = sequential_kernel_limit(n_pad, B)
    if limit:
        raise ValueError(limit)
    B = sequential_block(B)
    fits = [P for P in SEQ_REPLICAS_PER_CTA
            if _seq_shared_bytes(n_pad, B, P, 1) <= MAX_SHARED_BYTES]
    P = next((P for P in fits if I * -(-R // P) <= num_sms), fits[-1])
    return P, _tile_buffers(n_pad, B, P)


def _tile_buffers(n_pad, B, P):
    """Two tile buffers where they fit beside P replicas, else one."""
    return 2 if _seq_shared_bytes(n_pad, B, P, 2) <= MAX_SHARED_BYTES else 1


def sequential_sweeps_reference(
    nbrs, J_diag, h, m0, phi0, generator, beta_sweep, beta_row, mask,
    beta_spin=None, *, num_sweeps: int,
    uniforms: Optional[torch.Tensor] = None, record_m: bool = False,
) -> SweepResult:
    """Plain-torch sequential sweeps of I instances with the kernel's
    association, over [I, ...] inputs: J_diag [I, nB, B, B], h [I, n_pad],
    m0 / phi0 [I, R, n_pad], beta_row [I, R], mask and beta_spin (or None)
    broadcastable to [I, R, n_pad], uniforms [T, I, R, n_pad]; `nbrs` the
    union layout (`sequential_neighbors`, weights [I, n_ell]). Per block the
    in-block chain of run_sweeps (corr += d_i * J_diag row i, spin after
    spin, beta = (beta_t * beta_row) * beta_spin), then per target acc = 0,
    acc += dm_k * w_kj over its sources in ascending k (dm_k in {0, +-2}, so
    each product is exact and the kernel's fmaf rounds as this sum does),
    phi[j] += acc; energies in the kernel's lane order (`warp0_energy`).
    Blocks are the kernel's (`sequential_block`; `nbrs` is built in them).
    In f32 it equals the kernel bit for bit. Outputs carry the leading I:
    energies [I, T, R], M [I, T, R, n_pad]. For the tests and
    chip_smoke.py; no route calls it."""
    I, R, n_pad = m0.shape
    _, J_diag = _sub_blocks(None, J_diag)
    nB, B = J_diag.shape[1], J_diag.shape[2]
    dtype, device = m0.dtype, m0.device
    if uniforms is not None and tuple(uniforms.shape) != (num_sweeps, I, R,
                                                          n_pad):
        raise ValueError(f"uniforms must be [{num_sweeps}, {I}, {R}, "
                         f"{n_pad}], got {tuple(uniforms.shape)}")
    # per block: its targets, and their sources and weights [D, n_tgt]
    # rank by rank, as the kernel reads them
    tgt_ptr, ell_ptr = nbrs.tgt_ptr.tolist(), nbrs.ell_ptr.tolist()
    blocks = []
    for b in range(nB):
        t0, t1 = tgt_ptr[b], tgt_ptr[b + 1]
        e0, e1 = ell_ptr[b], ell_ptr[b + 1]
        D = (e1 - e0) // max(t1 - t0, 1)
        blocks.append((nbrs.tgt[t0:t1].long(),
                       nbrs.src[e0:e1].long().reshape(D, t1 - t0),
                       nbrs.w[:, e0:e1].to(dtype).reshape(I, 1, D, t1 - t0)))
    beta_sweep = torch.as_tensor(beta_sweep, dtype=dtype,
                                 device=device).expand(num_sweeps)
    beta_row = torch.as_tensor(beta_row, dtype=dtype,
                               device=device).reshape(I, R, 1)
    mask = torch.as_tensor(mask, device=device)
    mask = (mask if mask.dtype == torch.bool else mask > 0).expand(I, R,
                                                                   n_pad)
    if beta_spin is not None:
        beta_spin = torch.as_tensor(beta_spin, dtype=dtype,
                                    device=device).expand(I, R, n_pad)
    J_diag = J_diag.to(dtype)
    h_rows = h.to(dtype)[:, None, :].expand(I, R, n_pad).reshape(I * R,
                                                                 n_pad)

    m = m0.clone()
    phi = phi0.clone()
    m_best = m0.clone()
    e_best = torch.full((I, R), float("inf"), dtype=dtype, device=device)
    energies = torch.empty((I, num_sweeps, R), dtype=dtype, device=device)
    M = (torch.empty((I, num_sweeps, R, n_pad), dtype=dtype, device=device)
         if record_m else None)
    for t in range(num_sweeps):
        u = _uniforms(generator, uniforms, t, (I, R, n_pad), dtype, device)
        beta_tr = beta_sweep[t] * beta_row                      # [I, R, 1]
        for b in range(nB):
            s0 = b * B
            xb = phi[..., s0:s0 + B]
            mb = m[..., s0:s0 + B]
            betab = (beta_tr if beta_spin is None
                     else beta_tr * beta_spin[..., s0:s0 + B])
            betab = betab.expand(I, R, B)
            mb_new = mb.clone()
            corr = torch.zeros_like(xb)
            for i in range(B):
                old = mb_new[..., i]
                new = heat_bath_update(xb[..., i] + corr[..., i],
                                       betab[..., i], u[..., s0 + i], old,
                                       mask[..., s0 + i])
                corr = corr + (new - old)[..., None] * J_diag[:, None, b, i]
                mb_new[..., i] = new
            tgt, src, wt = blocks[b]
            dm = mb_new - mb
            acc = torch.zeros((I, R, tgt.numel()), dtype=dtype, device=device)
            for d in range(src.shape[0]):
                acc = acc + dm[..., src[d]] * wt[:, :, d]
            phi = phi.clone()
            phi[..., tgt] += acc
            m[..., s0:s0 + B] = mb_new
        e = warp0_energy(h_rows, m.reshape(I * R, n_pad),
                         phi.reshape(I * R, n_pad)).reshape(I, R)
        better = e < e_best
        m_best = torch.where(better[..., None], m, m_best)
        e_best = torch.where(better, e, e_best)
        energies[:, t] = e
        if record_m:
            M[:, t] = m
    return SweepResult(m=m, phi=phi, m_best=m_best, e_best=e_best,
                       energies=energies, M=M)


def _seq_mask(mask, rows, n_pad, device):
    """A mask broadcastable to [*rows, n_pad] as the kernel's [1 | prod(rows),
    n_pad] bool rows; returns (mask, mask_rows). One row when it repeats
    one row (a [n_pad] or [1, ..., n_pad] mask, or an expand view)."""
    x = mask if isinstance(mask, torch.Tensor) else torch.as_tensor(
        mask, device=device)
    if x.device != device:
        raise ValueError(f"mask is on {x.device}, expected {device}")
    if x.dtype != torch.bool:
        raise TypeError(f"mask must be torch.bool, got {x.dtype}")
    x = x.expand(*rows, n_pad)
    if all(st == 0 or n == 1 for st, n in zip(x.stride()[:-1], x.shape[:-1])):
        return x.reshape(-1, n_pad)[:1].contiguous(), 1
    return x.contiguous().reshape(-1, n_pad), int(np.prod(rows))


def _launch_seq(nbrs, J_diag, h, m0, phi0, generator, beta_sweep, beta_spin,
                mask, num_sweeps, uniforms, seeds, replicas_per_cta,
                record_m, replica_offset) -> SweepResult:
    """Check the [I, ...] arguments and launch the sequential kernel in
    its blocks (`sequential_block`); M is None unless `record_m`."""
    device = m0.device
    I, R, n_pad = m0.shape
    _, J_diag = _sub_blocks(None, J_diag)
    nB, B = J_diag.shape[1], J_diag.shape[2]
    if nB * B != n_pad:
        raise ValueError(f"J_diag {tuple(J_diag.shape)} does not tile "
                         f"{n_pad} spins")
    f32 = torch.float32
    _check_sequential_neighbors(nbrs, I, n_pad, B, device)
    _check("J_diag", J_diag, (I, nB, B, B), f32, device)
    _check("h", h, (I, n_pad), f32, device)
    _check("m0", m0, (I, R, n_pad), f32, device)
    _check("phi0", phi0, (I, R, n_pad), f32, device)
    beta_sweep = _broadcast("beta_sweep", beta_sweep, (num_sweeps,), f32,
                            device)
    beta_row, beta_spin = _k1_betas(beta_spin, (I, R), n_pad, device)
    mask, mask_rows = _seq_mask(mask, (I, R), n_pad, device)
    P = (sequential_launch(I, R, n_pad, B, _num_sms(device))[0]
         if replicas_per_cta is None else replicas_per_cta)
    if P not in SEQ_REPLICAS_PER_CTA:
        raise ValueError(f"the sequential kernel takes replicas_per_cta in "
                         f"{SEQ_REPLICAS_PER_CTA}; got {P}")
    n_buf = _tile_buffers(n_pad, B, P)
    _check_shared("sequential_sweeps", _seq_shared_bytes(n_pad, B, P, n_buf))
    if uniforms is not None:
        _check("uniforms", uniforms, (num_sweeps, I, R, n_pad), f32, device)
        seeds = None
    elif seeds is not None:
        _check("seeds", seeds, (I, 2), torch.int32, device)
    elif generator is None:
        raise ValueError("pass a torch.Generator or injected uniforms")
    else:
        seeds = draw_seeds(generator, (I,)).to(device, non_blocking=True)

    fn = "sequential_sweeps_f32"
    lib = bind(load_library(_LIB_SEQ), fn, _SEQ_SIGNATURES[fn])
    f32d = dict(dtype=f32, device=device)
    out = SweepResult(
        m=torch.empty_like(m0), phi=torch.empty_like(m0),
        m_best=torch.empty_like(m0), e_best=torch.empty((I, R), **f32d),
        energies=torch.empty((I, num_sweeps, R), **f32d),
        M=(torch.empty((I, num_sweeps, R, n_pad), **f32d) if record_m
           else None))
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, fn)(
        nbrs.tgt_ptr.data_ptr(), nbrs.tgt.data_ptr(), nbrs.ell_ptr.data_ptr(),
        nbrs.src.data_ptr(), nbrs.dense.data_ptr(),
        nbrs.next_coupled.data_ptr(), nbrs.w.data_ptr(), J_diag.data_ptr(),
        h.data_ptr(), m0.data_ptr(), phi0.data_ptr(), _ptr(beta_spin),
        mask.data_ptr(), beta_sweep.data_ptr(), beta_row.data_ptr(),
        _ptr(uniforms), _ptr(seeds), out.m.data_ptr(), out.phi.data_ptr(),
        out.m_best.data_ptr(), out.e_best.data_ptr(), out.energies.data_ptr(),
        _ptr(out.M), I, R, n_pad, B, num_sweeps, nbrs.src.shape[0], mask_rows,
        P, n_buf, replica_offset, stream)
    _raise_on(err, fn)
    return out


def sequential_sweeps(
    J_rows,       # [nB, B, n_pad] float32 row blocks of an uncoloured layout
    J_diag,       # [nB, B, B] the blocks' diagonal tiles
    h,            # [n_pad]
    m0,           # [R, n_pad] in {-1, +1}
    phi0,         # [R, n_pad]
    generator,    # torch.Generator the seed is drawn from (None with uniforms)
    beta_sweep,   # [T] or scalar
    beta_spin,    # broadcastable to [R, n_pad]
    update_mask,  # broadcastable to [R, n_pad] bool
    *,
    num_sweeps: int,
    record_m: bool = False,                    # also return M [T, R, n_pad]
    uniforms: Optional[torch.Tensor] = None,   # [T, R, n_pad] injected draws
    nbrs=None,                                 # `sequential_neighbors` (built if None)
    replicas_per_cta: Optional[int] = None,    # P (sequential_launch)
    replica_offset: int = 0,                   # global index of row 0
    replicas_total: Optional[int] = None,      # the whole ladder's R
    seed: Optional[torch.Tensor] = None,       # int32 [2] (CUDA)
) -> SweepResult:
    """T sequential fixed-order heat-bath sweeps (spin 0 .. n_pad - 1, each
    seeing every earlier flip), the function of
    `run_sweeps(within_block="sequential")`; the CUDA kernel (one instance
    of `sequential_sweeps_batched`'s launch) on CUDA tensors, that plain
    version on CPU tensors (which ignores `nbrs` and
    `replicas_per_cta`)."""
    rows = slice_axis("replicas", replica_offset, m0.shape[0], replicas_total)
    if m0.device.type == "cpu":
        return run_sweeps(J_rows, J_diag, h, m0, phi0, generator, beta_sweep,
                          beta_spin, update_mask, num_sweeps=num_sweeps,
                          within_block="sequential", record_m=record_m,
                          uniforms=_cpu_uniforms(
                              generator, uniforms, seed, (num_sweeps,),
                              (rows,), m0.shape[1], m0.dtype, m0.device))
    _require_cuda(m0, "sequential_sweeps")
    device = m0.device
    nB, B, n_pad = J_rows.shape
    if nB * B != n_pad:
        raise ValueError(f"J_rows {tuple(J_rows.shape)} is not square")
    _check("J_rows", J_rows, (nB, B, n_pad), torch.float32, device)
    if nbrs is None:
        nbrs = sequential_neighbors(J_rows)
    if uniforms is not None:
        uniforms = uniforms[:, None]
    if seed is not None:
        _check("seed", seed, (2,), torch.int32, device)
        seed = seed[None]
    bs = beta_spin if isinstance(beta_spin, torch.Tensor) else \
        torch.as_tensor(beta_spin, dtype=torch.float32, device=device)
    mask = torch.as_tensor(update_mask, device=device)
    out = _launch_seq(nbrs, J_diag[None], h[None], m0[None], phi0[None],
                      generator, beta_sweep, bs[None] if bs.ndim else bs,
                      mask.expand(m0.shape[0], n_pad)[None], num_sweeps,
                      uniforms, seed, replicas_per_cta, record_m,
                      replica_offset)
    sequential_sweeps.launches += 1
    return SweepResult(out.m[0], out.phi[0], out.m_best[0], out.e_best[0],
                       out.energies[0], None if out.M is None else out.M[0])


def sequential_sweeps_batched(
    J_rows,       # [I, nB, B, n_pad] float32 row blocks, uncoloured layouts
    J_diag,       # [I, nB, B, B]
    h,            # [I, n_pad]
    m0,           # [I, R, n_pad] in {-1, +1}
    phi0,         # [I, R, n_pad]
    generator,    # torch.Generator (None with uniforms or seeds)
    beta_sweep,   # [T] or scalar, shared by the instances
    beta_spin,    # broadcastable to [I, R, n_pad]
    update_mask,  # broadcastable to [I, R, n_pad] bool
    *,
    num_sweeps: int,
    record_m: bool = False,                    # also return M [I, T, R, n_pad]
    uniforms: Optional[torch.Tensor] = None,   # [T, I, R, n_pad] injected draws
    nbrs=None,                                 # `sequential_neighbors` (built if None)
    replicas_per_cta: Optional[int] = None,    # P (sequential_launch)
    seeds: Optional[torch.Tensor] = None,      # int32 [I, 2] (CUDA)
) -> SweepResult:
    """`sequential_sweeps` of I same-size instances in one launch, as JAX's
    `EnsemblePT` runs them under `vmap`: outputs carry the leading I
    (energies [I, T, R], e_best [I, R]). On CUDA tensors one kernel launch
    over (replica tiles, instances), instance i drawing from its seed words
    seeds[i] alone, so that it equals `sequential_sweeps(...,
    seed=seeds[i])` bit for bit, and a launch over a slice of the instances
    with their rows of seeds equals the whole launch's rows (seeds drawn
    from `generator` when not given). On CPU tensors its plain twin:
    `sequential_sweeps`' CPU path instance after instance (uniforms[:, i],
    or each instance's T sweeps drawn from the generator in turn)."""
    I, R, n_pad = m0.shape
    if m0.device.type == "cpu":
        if seeds is not None:
            raise ValueError("seeds= is for CUDA launches; on the CPU pass a "
                             "generator or uniforms")
        bs = torch.as_tensor(beta_spin, dtype=m0.dtype)
        bs = bs.expand(I, R, bs.shape[-1] if bs.ndim else 1)
        mask = torch.as_tensor(update_mask).expand(I, R, n_pad)
        res = [sequential_sweeps(
            J_rows[i], J_diag[i], h[i], m0[i], phi0[i], generator,
            beta_sweep, bs[i], mask[i], num_sweeps=num_sweeps,
            record_m=record_m,
            uniforms=None if uniforms is None else uniforms[:, i])
            for i in range(I)]
        return SweepResult(*(None if xs[0] is None else torch.stack(xs)
                             for xs in zip(*res)))
    _require_cuda(m0, "sequential_sweeps_batched")
    device = m0.device
    _, nB, B, _ = J_rows.shape
    _check("J_rows", J_rows, (I, nB, B, n_pad), torch.float32, device)
    if nbrs is None:
        nbrs = sequential_neighbors(J_rows)
    out = _launch_seq(nbrs, J_diag, h, m0, phi0, generator, beta_sweep,
                      beta_spin, update_mask, num_sweeps, uniforms, seeds,
                      replicas_per_cta, record_m, 0)
    sequential_sweeps_batched.launches += 1
    return out


def sequential_occupancy(n_pad: int, block_size: int, replicas_per_cta: int,
                         n_buf: int = 1):
    """(registers per thread, CTAs per SM) of the sequential kernel at
    `replicas_per_cta` per CTA with its dynamic shared memory at this
    n_pad, block size (the kernel's, `sequential_block`) and tile buffers,
    from the CUDA runtime (builds the library)."""
    lib = load_library(_LIB_SEQ)
    f = lib.sequential_sweeps_occupancy
    f.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    f.restype = ctypes.c_int
    regs, ctas = ctypes.c_int(), ctypes.c_int()
    block_size = sequential_block(block_size)
    _raise_on(f(block_size, replicas_per_cta,
                _seq_shared_bytes(n_pad, block_size, replicas_per_cta, n_buf),
                ctypes.byref(regs), ctypes.byref(ctas)),
              "sequential_sweeps_occupancy")
    return regs.value, ctas.value


def sweep_occupancy(n_pad: int, threads: int, replicas_per_cta: int = 1):
    """(registers per thread, CTAs per SM) of the sweep body at `threads`
    and `replicas_per_cta` per CTA with its dynamic shared memory at this
    n_pad, from the CUDA runtime (builds the library)."""
    lib = load_library(_LIB_NBR)
    f = lib.colored_sweeps_nbr_occupancy
    f.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    f.restype = ctypes.c_int
    regs, ctas = ctypes.c_int(), ctypes.c_int()
    _raise_on(f(threads, replicas_per_cta,
                _shared_bytes_nbr(n_pad, replicas_per_cta), ctypes.byref(regs),
                ctypes.byref(ctas)), "colored_sweeps_nbr_occupancy")
    return regs.value, ctas.value


colored_sweeps.launches = 0
colored_sweeps_streamed.launches = 0
colored_sweeps_sparse.launches = 0
sequential_sweeps.launches = 0
sequential_sweeps_batched.launches = 0
