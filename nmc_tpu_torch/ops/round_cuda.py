"""Whole-round ensemble kernels K4 and K5: the CUDA wrappers and plain twins.

The counterparts of ``nmc_tpu/ops/round_pallas.py``. One launch runs one
full NMC / PT swap round for every instance and replica slot of an
ensemble: the static phase list of `phase_list` (per cycle a heated
backbone phase C, a frozen backbone phase NC and, every
`full_update_frequency` cycles, a full phase ALL). Per phase the update
mask and heated beta are rebuilt from the activity mask, the backbone masks
`cl` and the NMC-slot flags, phi is rebuilt from scratch, `sweeps_per_phase`
colored heat-bath sweeps run, and NMC slots jump to their phase-best state.
The outputs are the carried states, each slot's best state and energy over
the round (strict <, energies at sweep ends) and the energy of the carried
state, which the replica-exchange test reads.

  * `ensemble_round` (K4, ``pallas_ensemble_round``): dense J
    [I, n_pad, n_pad] (csrc/ensemble_round.cu, `ensemble_round_f32`);
  * `ensemble_round_sparse` (K5, ``pallas_ensemble_round_streamed``): the
    family's union block-sparse tiles J_tiles [I, nB, K, B, B] over one
    col_idx [nB, K] (`ensemble_round_sparse_f32`). The TPU's `resident`
    variant only changes how the tiles reach VMEM, so there is one K5.

Both kernels read the couplings only through a `RoundNeighbors` layout:
the row blocks cut into steps by the rule of the sweep kernels
(`sweeps_cuda.sweep_steps`: maximal runs of consecutive blocks with no
coupling between two of them, a colored layout's colour classes), per
step each target spin with a coupling from the step and its sources in
ascending order, with per-instance weights. A launch walks a sweep step
by step: every spin of a step draws at once, then each target sums its
sources block by block as the block-by-block walk does. The layout is
built once from dense J (`neighbors_from_dense`) or from the union tiles
(`neighbors_from_tiles`), which give the same layout for the same
couplings; the engines build it at setup and pass it as `nbrs=`, and a
wrapper called without it builds it. The two entry points launch one
kernel body, so on one layout and one seed K4 and K5 agree bit for bit.
`ensemble_round_neighbors_reference` runs the round in plain torch over
the layout with the kernel's association (for the tests and
chip_smoke.py; no route calls it). The CTA width follows from the
launch's slot count (`round_threads`). While an engine records a round
(`utils.metrics.RoundSpans`), a launch adds its sweeps' steps and the
block steps a block-by-block walk would take to the counters
"round_steps" and "round_blocks".

The heated beta is beta_row * (1 + f32(temp_x_inv - 1)), computed in f32
as the Pallas kernels compute it (the plain XLA round of the JAX engine
multiplies by f32(1 / temp_x) instead; `parallel/ensemble_nmc.py` keeps
that for its plain route).

A `torch.Generator` stands in for the Pallas seed: two seed words are drawn
on its device per launch. Optional injected uniforms [P, T, I, R, n_pad]
(P phases, T sweeps per phase) replace the draws. On a CPU tensor a wrapper
runs its `*_reference` in plain torch and launches nothing; on a CUDA
tensor it launches the kernel or raises. Launches are counted in
`<wrapper>.launches`. An optional `flips` tensor [I, R] int32 receives each
slot's number of spin flips over the round.

A launch may run a slice of a larger ensemble (a shard on one rank):
`replica_offset` and `instance_offset`, the global indices of its first
replica and instance, are added to the Philox counter's replica and
instance words, so the slice draws what the whole launch draws for its
rows. On the CPU a wrapper given a generator and the totals
(`replicas_total`, `instances_total`) draws each sweep's uniforms for the
whole ensemble in the unsliced order and keeps its rows; `seed=` (int32
[2]) stands in for the generator's seed words on the card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.metrics import count
from ._build import bind, load_library
from .sweeps import heat_bath_update
from .sweeps_cuda import (_INT16_MAX, MAX_SHARED_BYTES, _broadcast, _check,
                          _check_shared, _cpu_uniforms, _num_sms, _ptr,
                          _raise_on, _require_cuda, _seed, _step_layout,
                          slice_axis, warp0_energy)

_LIB = "ensemble_round"
# argument kinds of each C entry point, in order ('p' pointer, 'i' int,
# 'f' float); the CUDA stream follows as one more pointer. Both take the
# neighbour layout (5 pointers) and the same round arguments, then the
# replica and instance offsets and the CTA width.
_SIGNATURES = {"ensemble_round_f32": "p" * 20 + "i" * 10 + "f" + "iii",
               "ensemble_round_sparse_f32": "p" * 20 + "i" * 10 + "f" + "iii"}
# The CTA widths the round kernel is built for: 256 threads, five CTAs an
# SM, where the slots fill the SMs; 1024, one CTA an SM, where every slot
# has an SM of its own (`round_threads`).
ROUND_WIDTHS = (256, 1024)


class EnsembleRoundResult(NamedTuple):
    m: torch.Tensor          # [I, R, n_pad] carried states after the round
    m_best: torch.Tensor     # [I, R, n_pad] best state per slot over the round
    e_best: torch.Tensor     # [I, R] best sweep-end energy per slot
    e_carried: torch.Tensor  # [I, R] energy of the carried state


class RoundNeighbors(NamedTuple):
    """The round kernels' coupling layout over a family's union graph. The
    row blocks of `block_size` spins are cut into steps, maximal runs of
    consecutive blocks with no coupling between two of them (the rule of
    `sweeps_cuda.sweep_steps`; on a colored layout its colour classes).
    Per step: the targets j with a coupling from a spin of the step
    (longest source list first, then ascending j), and per target its
    sources k in the step in ascending k, so block after block; the
    weights follow the source entries."""
    step_ptr: torch.Tensor  # [n_steps + 1] int32: step s holds row blocks step_ptr[s]:step_ptr[s+1]
    tgt_ptr: torch.Tensor   # [n_steps + 1] int32: step s's targets tgt_ptr[s]:tgt_ptr[s+1]
    tgt: torch.Tensor       # [n_tgt] int16 target spin j
    src_ptr: torch.Tensor   # [n_tgt + 1] int32: target t's sources
    src: torch.Tensor       # [nnz] int16 source spin k
    w: torch.Tensor         # [I, nnz] float32 J[i, k, j]; exactly 0 where
                            # instance i lacks the union edge
    block_size: int
    step_spins: int         # the widest step's spins


def _round_neighbors(k, j, w, nB, B, steps) -> RoundNeighbors:
    """The layout of union entries (source k, target j) with their weights
    w [I, nnz], cut into `steps` (default `sweeps_cuda.sweep_steps`'
    rule)."""
    steps, tgt_ptr, tgt, src_ptr, src, w = _step_layout(k, j, w, nB, B, steps)
    return RoundNeighbors(
        step_ptr=torch.tensor(steps, dtype=torch.int32, device=k.device),
        tgt_ptr=tgt_ptr, tgt=tgt, src_ptr=src_ptr, src=src,
        w=w.to(torch.float32), block_size=B,
        step_spins=B * int(np.diff(steps).max()))


def neighbors_from_dense(J, block_size: int, *,
                         steps: Optional[Sequence[int]] = None
                         ) -> RoundNeighbors:
    """The layout of dense J [I, n_pad, n_pad] (rows are sources) over its
    union nonzero pattern, blocked by `block_size`; `steps` (boundaries
    over the blocks) replaces the rule's."""
    I, n_pad, _ = J.shape
    B = block_size
    if n_pad % B:
        raise ValueError("n_pad must be a multiple of block_size")
    k, j = torch.nonzero((J != 0).any(0), as_tuple=True)
    return _round_neighbors(k, j, J[:, k, j], n_pad // B, B, steps)


def neighbors_from_tiles(col_idx, J_tiles, *,
                         steps: Optional[Sequence[int]] = None
                         ) -> RoundNeighbors:
    """The layout of union block-sparse tiles J_tiles [I, nB, K, B, B] over
    col_idx [nB, K]; padding tiles (zero in every instance, aliasing column
    block 0) give no entries. `steps` as in `neighbors_from_dense`."""
    I, nB, K, B, _ = J_tiles.shape
    b, t, kk, jj = torch.nonzero((J_tiles != 0).any(0), as_tuple=True)
    j = col_idx.to(b.device).long()[b, t] * B + jj
    return _round_neighbors(b * B + kk, j, J_tiles[:, b, t, kk, jj], nB, B,
                            steps)


def round_threads(slots: int, num_sms: int) -> int:
    """The round kernel's CTA width for a launch of `slots` CTAs (I * R)
    on num_sms SMs: 1024 threads, one CTA an SM, when every slot has an SM
    of its own; else 256, five CTAs an SM (a wave of 660 on 132 SMs). A
    step of 1,000-2,800 spins gives work to more threads than 256, but
    where the slots fill the SMs the narrow CTAs share them."""
    return ROUND_WIDTHS[1] if slots <= num_sms else ROUND_WIDTHS[0]


def _check_neighbors(nbrs, I, n_pad, B, device):
    if not isinstance(nbrs, RoundNeighbors):
        raise TypeError("nbrs must be a RoundNeighbors")
    if nbrs.block_size != B:
        raise ValueError(f"nbrs has block_size {nbrs.block_size}, expected {B}")
    n_steps = nbrs.step_ptr.shape[0] - 1
    n_tgt, nnz = nbrs.tgt.shape[0], nbrs.src.shape[0]
    if not 1 <= n_steps <= n_pad // B:
        raise ValueError(f"nbrs has {n_steps} steps for {n_pad // B} blocks")
    if not B <= nbrs.step_spins <= n_pad:
        raise ValueError(f"nbrs has steps of {nbrs.step_spins} spins for "
                         f"n_pad {n_pad}")
    _check("nbrs.step_ptr", nbrs.step_ptr, (n_steps + 1,), torch.int32,
           device)
    _check("nbrs.tgt_ptr", nbrs.tgt_ptr, (n_steps + 1,), torch.int32, device)
    _check("nbrs.tgt", nbrs.tgt, (n_tgt,), torch.int16, device)
    _check("nbrs.src_ptr", nbrs.src_ptr, (n_tgt + 1,), torch.int32, device)
    _check("nbrs.src", nbrs.src, (nnz,), torch.int16, device)
    _check("nbrs.w", nbrs.w, (I, nnz), torch.float32, device)


def neighbor_phi_fns(nbrs: RoundNeighbors, h):
    """(phi_of, phi_add) for `_round_reference` over the layout, with the
    kernel's association: per row block b and target j, acc = 0, acc +=
    x_k * w_kj over j's sources in b in ascending k (x_k in {0, +-1,
    +-2}, so each product is exact and the kernel's fmaf rounds as this
    sum does), then phi[j] += acc; phi_of starts from h and adds row block
    after row block. The kernel walks a step's blocks inside each target's
    source list, which adds the same sums in the same order."""
    B = nbrs.block_size
    I = nbrs.w.shape[0]
    n_pad = h.shape[-1]
    dtype, device = h.dtype, h.device
    src = nbrs.src.long()
    counts = torch.diff(nbrs.src_ptr.long())
    t_of = torch.repeat_interleave(
        torch.arange(counts.numel(), device=device), counts)
    w = nbrs.w.to(dtype)
    blocks = []
    for b in range(n_pad // B):
        # block b's entries: a run of ascending k per target
        e = torch.nonzero(src // B == b).squeeze(1)
        t, inv, cnt = torch.unique_consecutive(
            t_of[e], return_inverse=True, return_counts=True)
        D = int(cnt.max()) if e.numel() else 0
        pos = (torch.arange(e.numel(), device=device)
               - (torch.cumsum(cnt, 0) - cnt)[inv])
        # the sources of block b's targets padded to D with weight 0
        idx = torch.zeros((t.numel(), D), dtype=torch.long, device=device)
        idx[inv, pos] = src[e] - b * B
        wt = torch.zeros((I, t.numel(), D), dtype=dtype, device=device)
        wt[:, inv, pos] = w[:, e]
        blocks.append((nbrs.tgt.long()[t], idx, wt[:, None]))
    h3 = h[:, None, :]

    def phi_add(phi, x, b):
        tgt, idx, wt = blocks[b]
        acc = torch.zeros(x.shape[:-1] + (tgt.numel(),), dtype=dtype,
                          device=x.device)
        for d in range(idx.shape[1]):
            acc = acc + x[..., idx[:, d]] * wt[..., d]
        phi = phi.clone()
        phi[..., tgt] += acc
        return phi

    def phi_of(m):
        phi = h3.expand(I, m.shape[1], n_pad)
        for b in range(n_pad // B):
            phi = phi_add(phi, m[..., b * B:(b + 1) * B], b)
        return phi

    return phi_of, phi_add


def phase_list(num_cycles: int, full_update_frequency: int) -> Tuple[str, ...]:
    phases = []
    for cycle in range(num_cycles):
        phases += ["C", "NC"]
        if cycle % full_update_frequency == 0:
            phases.append("ALL")
    return tuple(phases)


def heated_factor(temp_x_inv: float) -> float:
    """1 + f32(temp_x_inv - 1) in f32, the Pallas kernels' heated factor."""
    return float(np.float32(1.0) + np.float32(temp_x_inv - 1.0))


def _bind(lib, fn: str):
    return bind(lib, fn, _SIGNATURES[fn])


def _round_reference(phi_of, phi_add, B, h, act, m0, cl, do_nmc, beta_row,
                     generator, *, num_cycles, sweeps_per_phase,
                     full_update_frequency, temp_x_inv, uniforms, flips,
                     energy=None):
    """The round in plain torch over all instances at once; `phi_of(m)`
    rebuilds phi = J m + h, `phi_add(phi, dm, b)` adds row block b's
    change, `energy(m, phi)` sums -1/2 m.(phi + h) ([I, R]; default
    `torch.sum`'s order)."""
    I, R, n_pad = m0.shape
    dtype, device = m0.dtype, m0.device
    T = sweeps_per_phase
    if T < 1:
        raise ValueError(f"sweeps_per_phase must be >= 1, got {T}")
    if generator is None and uniforms is None:
        raise ValueError("pass a torch.Generator or injected uniforms")
    phases = phase_list(num_cycles, full_update_frequency)
    if uniforms is not None and tuple(uniforms.shape) != (
            len(phases), T, I, R, n_pad):
        raise ValueError(f"uniforms must be [{len(phases)}, {T}, {I}, {R}, "
                         f"{n_pad}], got {tuple(uniforms.shape)}")
    act = torch.as_tensor(act, device=device).bool().expand(I, R, n_pad)
    cl = torch.as_tensor(cl, device=device).bool()
    dn = torch.as_tensor(do_nmc, device=device).bool().reshape(I, R, 1)
    beta = torch.as_tensor(beta_row, dtype=dtype, device=device).reshape(
        I, R, 1)
    heat = torch.tensor(heated_factor(temp_x_inv), dtype=dtype, device=device)
    h3 = h.to(dtype)[:, None, :]
    if energy is None:
        def energy(m, phi):
            return -0.5 * torch.sum(m * (phi + h3), dim=-1)

    m = m0.clone()
    e_best = torch.full((I, R), float("inf"), dtype=dtype, device=device)
    m_best = m0.clone()
    n_flips = torch.zeros((I, R), dtype=torch.int64, device=device)
    for p, kind in enumerate(phases):
        bs = None
        if kind == "C":
            mask = torch.where(dn, cl & act, act)
            bs = torch.where(dn & cl, heat, torch.ones((), dtype=dtype,
                                                       device=device))
        elif kind == "NC":
            mask = torch.where(dn, ~cl & act, act)
        else:
            mask = act
        phi = phi_of(m)
        e_phase = torch.full((I, R), float("inf"), dtype=dtype, device=device)
        m_phase = m.clone()
        for t in range(T):
            u = (uniforms[p, t] if uniforms is not None else
                 torch.rand((I, R, n_pad), generator=generator, dtype=dtype,
                            device=device))
            for b in range(n_pad // B):
                s = b * B
                betab = beta if bs is None else beta * bs[..., s:s + B]
                old = m[..., s:s + B]
                new = heat_bath_update(phi[..., s:s + B], betab,
                                       u[..., s:s + B], old,
                                       mask[..., s:s + B])
                dm = new - old
                n_flips += (dm != 0).sum(-1)
                phi = phi_add(phi, dm, b)
                m[..., s:s + B] = new
            e = energy(m, phi)
            better = e < e_phase
            e_phase = torch.where(better, e, e_phase)
            m_phase = torch.where(better[..., None], m, m_phase)
        m = torch.where(dn, m_phase, m)
        better = e_phase < e_best
        e_best = torch.where(better, e_phase, e_best)
        m_best = torch.where(better[..., None], m_phase, m_best)
    phi = phi_of(m)
    e_carried = energy(m, phi)
    if flips is not None:
        flips.copy_(n_flips)
    return EnsembleRoundResult(m=m, m_best=m_best, e_best=e_best,
                               e_carried=e_carried)


def ensemble_round_reference(
    J, h, act, m0, cl, do_nmc, beta_row, generator, *, num_cycles: int,
    sweeps_per_phase: int, full_update_frequency: int = 1,
    temp_x_inv: float = 1.0 / 20.0, block_size: int = 128,
    uniforms: Optional[torch.Tensor] = None,
    flips: Optional[torch.Tensor] = None,
) -> EnsembleRoundResult:
    """Plain-torch K4: phi += dm @ J[:, block, :] after each block."""
    I, R, n_pad = m0.shape
    if n_pad % block_size:
        raise ValueError("n_pad must be a multiple of block_size")
    J = J.to(m0.dtype)
    h3 = h.to(m0.dtype)[:, None, :]
    B = block_size

    def phi_of(m):
        return torch.matmul(m, J) + h3

    def phi_add(phi, dm, b):
        return phi + torch.matmul(dm, J[:, b * B:(b + 1) * B, :])

    return _round_reference(
        phi_of, phi_add, B, h, act, m0, cl, do_nmc, beta_row, generator,
        num_cycles=num_cycles, sweeps_per_phase=sweeps_per_phase,
        full_update_frequency=full_update_frequency, temp_x_inv=temp_x_inv,
        uniforms=uniforms, flips=flips)


def ensemble_round_sparse_reference(
    col_idx, J_tiles, h, act, m0, cl, do_nmc, beta_row, generator, *,
    num_cycles: int, sweeps_per_phase: int, full_update_frequency: int = 1,
    temp_x_inv: float = 1.0 / 20.0, uniforms: Optional[torch.Tensor] = None,
    flips: Optional[torch.Tensor] = None,
) -> EnsembleRoundResult:
    """Plain-torch K5: after each block, out = dm @ [tile_0 | ... |
    tile_K-1] and phi[:, col block col_idx[b, k]] += out[:, k-th B
    columns], in tile order; phi is rebuilt the same way from h."""
    I, R, n_pad = m0.shape
    _, nB, K, B, _ = J_tiles.shape
    if nB * B != n_pad:
        raise ValueError("tile layout does not match n_pad")
    J_cat = J_tiles.to(m0.dtype).permute(0, 1, 3, 2, 4).reshape(
        I, nB, B, K * B)
    cols = torch.as_tensor(col_idx).reshape(nB, K).tolist()
    h3 = h.to(m0.dtype)[:, None, :]

    def phi_add(phi, dm, b):
        out = torch.matmul(dm, J_cat[:, b])
        phi = phi.clone()
        for k, c in enumerate(cols[b]):
            phi[..., c * B:(c + 1) * B] += out[..., k * B:(k + 1) * B]
        return phi

    def phi_of(m):
        phi = h3.expand(I, R, n_pad)
        for b in range(nB):
            phi = phi_add(phi, m[..., b * B:(b + 1) * B], b)
        return phi

    return _round_reference(
        phi_of, phi_add, B, h, act, m0, cl, do_nmc, beta_row, generator,
        num_cycles=num_cycles, sweeps_per_phase=sweeps_per_phase,
        full_update_frequency=full_update_frequency, temp_x_inv=temp_x_inv,
        uniforms=uniforms, flips=flips)


def ensemble_round_neighbors_reference(
    nbrs, h, act, m0, cl, do_nmc, beta_row, generator, *, num_cycles: int,
    sweeps_per_phase: int, full_update_frequency: int = 1,
    temp_x_inv: float = 1.0 / 20.0, uniforms: Optional[torch.Tensor] = None,
    flips: Optional[torch.Tensor] = None,
) -> EnsembleRoundResult:
    """Plain-torch round over a `RoundNeighbors` layout with the kernels'
    phi association (`neighbor_phi_fns`) and their energy sum (warp 0's
    lane order, `sweeps_cuda.warp0_energy`), so that in f32 it equals the
    kernels bit for bit; for the tests and chip_smoke.py, no route calls
    it."""
    phi_of, phi_add = neighbor_phi_fns(nbrs, h.to(m0.dtype))
    I, R, n_pad = m0.shape
    h_rows = h.to(m0.dtype)[:, None, :].expand(I, R, n_pad).reshape(-1, n_pad)

    def energy(m, phi):
        return warp0_energy(h_rows, m.reshape(-1, n_pad),
                            phi.reshape(-1, n_pad)).reshape(I, R)

    return _round_reference(
        phi_of, phi_add, nbrs.block_size, h, act, m0, cl, do_nmc, beta_row,
        generator, num_cycles=num_cycles, sweeps_per_phase=sweeps_per_phase,
        full_update_frequency=full_update_frequency, temp_x_inv=temp_x_inv,
        uniforms=uniforms, flips=flips, energy=energy)


def _round_args(h, act, m0, cl, do_nmc, beta_row, generator, uniforms, flips,
                num_cycles, sweeps_per_phase, full_update_frequency, seed):
    """Checked and materialised inputs shared by K4 and K5."""
    device = m0.device
    f32 = torch.float32
    I, R, n_pad = m0.shape
    _check("h", h, (I, n_pad), f32, device)
    _check("m0", m0, (I, R, n_pad), f32, device)
    act = _broadcast("act", act, (n_pad,), torch.bool, device)
    cl = _broadcast("cl", cl, (I, R, n_pad), torch.bool, device)
    do_nmc = _broadcast("do_nmc", do_nmc, (I, R), torch.bool, device)
    beta_row = _broadcast("beta_row", beta_row, (I, R), f32, device)
    if flips is not None:
        _check("flips", flips, (I, R), torch.int32, device)
    if sweeps_per_phase < 1:
        raise ValueError(
            f"sweeps_per_phase must be >= 1, got {sweeps_per_phase}")
    P = len(phase_list(num_cycles, full_update_frequency))
    seed = _seed(generator, uniforms, (P, sweeps_per_phase, I, R, n_pad),
                 device, seed)
    out = EnsembleRoundResult(
        m=torch.empty_like(m0), m_best=torch.empty_like(m0),
        e_best=torch.empty((I, R), dtype=f32, device=device),
        e_carried=torch.empty((I, R), dtype=f32, device=device))
    return act, cl, do_nmc, beta_row, seed, out


def _shared_bytes(n_pad, step_spins):
    """Dynamic shared memory per CTA: phi (f32), dm over the widest step
    (f32), m, the phase-best m and the phase flags (1 byte each per
    spin)."""
    return 7 * n_pad + 4 * step_spins


def round_kernel_limit(n_pad: int, step_spins: int) -> Optional[str]:
    """Why the round kernels cannot take a layout of n_pad spins whose
    widest step holds `step_spins` (a layout's block size at least), or
    None when they can: the neighbour layout's int16 spin indices and the
    CTA's shared memory (one replica's state) are their only limits on the
    layout."""
    if n_pad > _INT16_MAX + 1:
        return (f"n_pad {n_pad} > {_INT16_MAX + 1}, the int16 spin indices "
                "of the round kernels' neighbour layout")
    nbytes = _shared_bytes(n_pad, step_spins)
    if nbytes > MAX_SHARED_BYTES:
        return (f"n_pad {n_pad} needs {nbytes} bytes of shared memory per "
                f"CTA, above the {MAX_SHARED_BYTES} a CTA has")
    return None


def _launch(fn, nbrs, h, act, m0, cl, do_nmc, beta_row, generator, *,
            num_cycles, sweeps_per_phase, full_update_frequency, temp_x_inv,
            uniforms, flips, seed, replica_offset, instance_offset):
    """Check the arguments and launch entry point `fn` over the layout."""
    device = m0.device
    I, R, n_pad = m0.shape
    B = nbrs.block_size
    _check_neighbors(nbrs, I, n_pad, B, device)
    act, cl, do_nmc, beta_row, seed, out = _round_args(
        h, act, m0, cl, do_nmc, beta_row, generator, uniforms, flips,
        num_cycles, sweeps_per_phase, full_update_frequency, seed)
    _check_shared(fn, _shared_bytes(n_pad, nbrs.step_spins))
    # the kernel's per-instance slot counters (CTAs claim slots by SM id)
    claims = torch.zeros(I, dtype=torch.int32, device=device)
    lib = _bind(load_library(_LIB), fn)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, fn)(
        nbrs.step_ptr.data_ptr(), nbrs.tgt_ptr.data_ptr(),
        nbrs.tgt.data_ptr(), nbrs.src_ptr.data_ptr(), nbrs.src.data_ptr(),
        nbrs.w.data_ptr(), h.data_ptr(), act.data_ptr(), m0.data_ptr(),
        cl.data_ptr(), do_nmc.data_ptr(), beta_row.data_ptr(),
        _ptr(uniforms), _ptr(seed), out.m.data_ptr(), out.m_best.data_ptr(),
        out.e_best.data_ptr(), out.e_carried.data_ptr(), _ptr(flips),
        claims.data_ptr(), I, R, n_pad, B, nbrs.step_ptr.shape[0] - 1,
        nbrs.step_spins, nbrs.src.shape[0], num_cycles, sweeps_per_phase,
        full_update_frequency, heated_factor(temp_x_inv), replica_offset,
        instance_offset, round_threads(I * R, _num_sms(device)), stream)
    _raise_on(err, fn)
    return out


def _count_steps(nbrs, n_pad, kw):
    """Add the launch's sweep steps and the block steps a block-by-block
    walk of the same sweeps takes to the open round's counters (host
    integers of the layout: no sync)."""
    sweeps = kw["sweeps_per_phase"] * len(
        phase_list(kw["num_cycles"], kw["full_update_frequency"]))
    count("round_steps", (nbrs.step_ptr.shape[0] - 1) * sweeps)
    count("round_blocks", n_pad // nbrs.block_size * sweeps)


def _slice_kw(m0, generator, uniforms, seed, replica_offset, replicas_total,
              instance_offset, instances_total, **kw):
    """(arguments shared by the plain twin and the launch, the launch's
    own): on the CPU the slice's uniforms (`_cpu_uniforms`), on the card
    the injected uniforms, the seed and the offsets."""
    I, R, n_pad = m0.shape
    axes = (slice_axis("instances", instance_offset, I, instances_total),
            slice_axis("replicas", replica_offset, R, replicas_total))
    if m0.device.type == "cpu":
        P = len(phase_list(kw["num_cycles"], kw["full_update_frequency"]))
        kw["uniforms"] = _cpu_uniforms(
            generator, uniforms, seed, (P, kw["sweeps_per_phase"]), axes,
            n_pad, m0.dtype, m0.device)
        return kw, {}
    kw["uniforms"] = uniforms
    return kw, dict(seed=seed, replica_offset=replica_offset,
                    instance_offset=instance_offset)


def ensemble_round(
    J,            # [I, n_pad, n_pad] float32 colored layout, symmetric
    h,            # [I, n_pad]
    act,          # [n_pad] activity mask (bool)
    m0,           # [I, R, n_pad] in {-1, +1}
    cl,           # [I, R, n_pad] backbone masks (bool)
    do_nmc,       # [I, R] NMC-slot flags (bool)
    beta_row,     # [I, R] slot sampling beta (global_beta on NMC slots)
    generator,    # torch.Generator the seed is drawn from (None with uniforms)
    *,
    num_cycles: int,
    sweeps_per_phase: int,
    full_update_frequency: int = 1,
    temp_x_inv: float = 1.0 / 20.0,
    block_size: int = 128,
    uniforms: Optional[torch.Tensor] = None,  # [P, T, I, R, n_pad]
    flips: Optional[torch.Tensor] = None,     # [I, R] int32 out
    nbrs: Optional[RoundNeighbors] = None,    # J's layout (built if None)
    replica_offset: int = 0,                  # global index of replica 0
    replicas_total: Optional[int] = None,     # the whole ensemble's R
    instance_offset: int = 0,                 # global index of instance 0
    instances_total: Optional[int] = None,    # the whole ensemble's I
    seed: Optional[torch.Tensor] = None,      # int32 [2] (CUDA)
) -> EnsembleRoundResult:
    """One whole round for every instance (K4); the CUDA kernel on CUDA
    tensors, the plain torch version on CPU tensors (which ignores
    `nbrs`)."""
    kw, launch_kw = _slice_kw(
        m0, generator, uniforms, seed, replica_offset, replicas_total,
        instance_offset, instances_total, num_cycles=num_cycles,
        sweeps_per_phase=sweeps_per_phase,
        full_update_frequency=full_update_frequency, temp_x_inv=temp_x_inv,
        flips=flips)
    I, R, n_pad = m0.shape
    if m0.device.type == "cpu":
        return ensemble_round_reference(J, h, act, m0, cl, do_nmc, beta_row,
                                        generator, block_size=block_size,
                                        **kw)
    _require_cuda(m0, "ensemble_round")
    if n_pad % block_size:
        raise ValueError("n_pad must be a multiple of block_size")
    _check("J", J, (I, n_pad, n_pad), torch.float32, m0.device)
    if nbrs is None:
        nbrs = neighbors_from_dense(J, block_size)
    _count_steps(nbrs, n_pad, kw)
    out = _launch("ensemble_round_f32", nbrs, h, act, m0, cl, do_nmc,
                  beta_row, generator, **kw, **launch_kw)
    ensemble_round.launches += 1
    return out


def ensemble_round_sparse(
    col_idx,      # [nB, K] int32 union nonzero column-tile indices
    J_tiles,      # [I, nB, K, B, B] float32 (padding tiles zero, column 0)
    h, act, m0, cl, do_nmc, beta_row, generator,   # as ensemble_round
    *,
    num_cycles: int,
    sweeps_per_phase: int,
    full_update_frequency: int = 1,
    temp_x_inv: float = 1.0 / 20.0,
    uniforms: Optional[torch.Tensor] = None,  # [P, T, I, R, n_pad]
    flips: Optional[torch.Tensor] = None,     # [I, R] int32 out
    nbrs: Optional[RoundNeighbors] = None,    # the tiles' layout (built if None)
    replica_offset: int = 0,                  # as ensemble_round
    replicas_total: Optional[int] = None,
    instance_offset: int = 0,
    instances_total: Optional[int] = None,
    seed: Optional[torch.Tensor] = None,
) -> EnsembleRoundResult:
    """One whole round for every instance over block-sparse tiles (K5);
    the CUDA kernel on CUDA tensors, the plain torch version on CPU
    tensors (which ignores `nbrs`)."""
    kw, launch_kw = _slice_kw(
        m0, generator, uniforms, seed, replica_offset, replicas_total,
        instance_offset, instances_total, num_cycles=num_cycles,
        sweeps_per_phase=sweeps_per_phase,
        full_update_frequency=full_update_frequency, temp_x_inv=temp_x_inv,
        flips=flips)
    I, R, n_pad = m0.shape
    if m0.device.type == "cpu":
        return ensemble_round_sparse_reference(
            col_idx, J_tiles, h, act, m0, cl, do_nmc, beta_row, generator,
            **kw)
    _require_cuda(m0, "ensemble_round_sparse")
    device = m0.device
    _, nB, K, B, _ = J_tiles.shape
    if nB * B != n_pad:
        raise ValueError("tile layout does not match n_pad")
    _check("col_idx", col_idx, (nB, K), torch.int32, device)
    _check("J_tiles", J_tiles, (I, nB, K, B, B), torch.float32, device)
    if nbrs is None:
        nbrs = neighbors_from_tiles(col_idx, J_tiles)
    _count_steps(nbrs, n_pad, kw)
    out = _launch("ensemble_round_sparse_f32", nbrs, h, act, m0, cl, do_nmc,
                  beta_row, generator, **kw, **launch_kw)
    ensemble_round_sparse.launches += 1
    return out


def kernel_occupancy(n_pad: int, step_spins: int, threads: int = 256):
    """(registers per thread, CTAs per SM) of the round kernel at `threads`
    per CTA with its dynamic shared memory at this shape (n_pad spins, the
    widest step `step_spins`), from the CUDA runtime (builds the
    library)."""
    lib = load_library(_LIB)
    f = lib.ensemble_round_occupancy
    f.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                  ctypes.POINTER(ctypes.c_int)]
    f.restype = ctypes.c_int
    regs, ctas = ctypes.c_int(), ctypes.c_int()
    _raise_on(f(threads, _shared_bytes(n_pad, step_spins), ctypes.byref(regs),
                ctypes.byref(ctas)), "ensemble_round_occupancy")
    return regs.value, ctas.value


ensemble_round.launches = 0
ensemble_round_sparse.launches = 0
