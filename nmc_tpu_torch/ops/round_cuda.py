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
    variant only changes how the tiles reach VMEM; on the card they come
    from L2 or HBM either way, so there is one kernel.

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
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ._build import bind, load_library
from .sweeps import heat_bath_update
from .sweeps_cuda import (_broadcast, _check, _check_shared, _ptr, _raise_on,
                          _require_cuda, _seed)

_LIB = "ensemble_round"
# argument kinds of each C entry point, in order ('p' pointer, 'i' int,
# 'f' float); the CUDA stream follows as one more pointer
_SIGNATURES = {"ensemble_round_f32": "p" * 14 + "i" * 7 + "f",
               "ensemble_round_sparse_f32": "p" * 15 + "i" * 8 + "f"}


class EnsembleRoundResult(NamedTuple):
    m: torch.Tensor          # [I, R, n_pad] carried states after the round
    m_best: torch.Tensor     # [I, R, n_pad] best state per slot over the round
    e_best: torch.Tensor     # [I, R] best sweep-end energy per slot
    e_carried: torch.Tensor  # [I, R] energy of the carried state


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
                     full_update_frequency, temp_x_inv, uniforms, flips):
    """The round in plain torch over all instances at once; `phi_of(m)`
    rebuilds phi = J m + h, `phi_add(phi, dm, b)` adds row block b's
    change."""
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
            e = -0.5 * torch.sum(m * (phi + h3), dim=-1)
            better = e < e_phase
            e_phase = torch.where(better, e, e_phase)
            m_phase = torch.where(better[..., None], m, m_phase)
        m = torch.where(dn, m_phase, m)
        better = e_phase < e_best
        e_best = torch.where(better, e_phase, e_best)
        m_best = torch.where(better[..., None], m_phase, m_best)
    phi = phi_of(m)
    e_carried = -0.5 * torch.sum(m * (phi + h3), dim=-1)
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


def _round_args(h, act, m0, cl, do_nmc, beta_row, generator, uniforms, flips,
                num_cycles, sweeps_per_phase, full_update_frequency):
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
                 device)
    out = EnsembleRoundResult(
        m=torch.empty_like(m0), m_best=torch.empty_like(m0),
        e_best=torch.empty((I, R), dtype=f32, device=device),
        e_carried=torch.empty((I, R), dtype=f32, device=device))
    return act, cl, do_nmc, beta_row, seed, out


def _shared_bytes(n_pad, K, B):
    return 7 * n_pad + 4 * K * B + 8 * B + 4 * K


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
) -> EnsembleRoundResult:
    """One whole round for every instance (K4); the CUDA kernel on CUDA
    tensors, the plain torch version on CPU tensors."""
    kw = dict(num_cycles=num_cycles, sweeps_per_phase=sweeps_per_phase,
              full_update_frequency=full_update_frequency,
              temp_x_inv=temp_x_inv, uniforms=uniforms, flips=flips)
    if m0.device.type == "cpu":
        return ensemble_round_reference(J, h, act, m0, cl, do_nmc, beta_row,
                                        generator, block_size=block_size,
                                        **kw)
    _require_cuda(m0, "ensemble_round")
    device = m0.device
    I, R, n_pad = m0.shape
    if n_pad % block_size:
        raise ValueError("n_pad must be a multiple of block_size")
    _check("J", J, (I, n_pad, n_pad), torch.float32, device)
    act, cl, do_nmc, beta_row, seed, out = _round_args(
        h, act, m0, cl, do_nmc, beta_row, generator, uniforms, flips,
        num_cycles, sweeps_per_phase, full_update_frequency)
    _check_shared("ensemble_round", _shared_bytes(n_pad, 0, block_size))
    lib = _bind(load_library(_LIB), "ensemble_round_f32")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.ensemble_round_f32(
        J.data_ptr(), h.data_ptr(), act.data_ptr(), m0.data_ptr(),
        cl.data_ptr(), do_nmc.data_ptr(), beta_row.data_ptr(),
        _ptr(uniforms), _ptr(seed), out.m.data_ptr(), out.m_best.data_ptr(),
        out.e_best.data_ptr(), out.e_carried.data_ptr(), _ptr(flips), I, R,
        n_pad, block_size, num_cycles, sweeps_per_phase,
        full_update_frequency, heated_factor(temp_x_inv), stream)
    _raise_on(err, "ensemble_round")
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
) -> EnsembleRoundResult:
    """One whole round for every instance over block-sparse tiles (K5);
    the CUDA kernel on CUDA tensors, the plain torch version on CPU
    tensors."""
    kw = dict(num_cycles=num_cycles, sweeps_per_phase=sweeps_per_phase,
              full_update_frequency=full_update_frequency,
              temp_x_inv=temp_x_inv, uniforms=uniforms, flips=flips)
    if m0.device.type == "cpu":
        return ensemble_round_sparse_reference(
            col_idx, J_tiles, h, act, m0, cl, do_nmc, beta_row, generator,
            **kw)
    _require_cuda(m0, "ensemble_round_sparse")
    device = m0.device
    I, R, n_pad = m0.shape
    _, nB, K, B, _ = J_tiles.shape
    if nB * B != n_pad:
        raise ValueError("tile layout does not match n_pad")
    _check("col_idx", col_idx, (nB, K), torch.int32, device)
    _check("J_tiles", J_tiles, (I, nB, K, B, B), torch.float32, device)
    act, cl, do_nmc, beta_row, seed, out = _round_args(
        h, act, m0, cl, do_nmc, beta_row, generator, uniforms, flips,
        num_cycles, sweeps_per_phase, full_update_frequency)
    _check_shared("ensemble_round_sparse", _shared_bytes(n_pad, K, B))
    lib = _bind(load_library(_LIB), "ensemble_round_sparse_f32")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.ensemble_round_sparse_f32(
        col_idx.data_ptr(), J_tiles.data_ptr(), h.data_ptr(), act.data_ptr(),
        m0.data_ptr(), cl.data_ptr(), do_nmc.data_ptr(), beta_row.data_ptr(),
        _ptr(uniforms), _ptr(seed), out.m.data_ptr(), out.m_best.data_ptr(),
        out.e_best.data_ptr(), out.e_carried.data_ptr(), _ptr(flips), I, R,
        n_pad, B, K, num_cycles, sweeps_per_phase, full_update_frequency,
        heated_factor(temp_x_inv), stream)
    _raise_on(err, "ensemble_round_sparse")
    ensemble_round_sparse.launches += 1
    return out


ensemble_round.launches = 0
ensemble_round_sparse.launches = 0
