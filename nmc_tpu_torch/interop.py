"""Carry the JAX package's host arrays into the port.

Both packages hold their host data as numpy, so these helpers take numpy
arrays (or any object exposing the same fields, such as an
``nmc_tpu`` BlockedProblem) and return the port's containers and tensors.
Tests build both engines from the same arrays through them, so the two
packages compute on identical J, h and layout. Nothing here imports JAX.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Union

import numpy as np
import torch

from .core.problem import BlockedProblem, IsingProblem
from .device import resolve_device, resolve_dtype

_BLOCKED_FIELDS = ("J_rows", "J_diag", "h", "active", "perm", "inv_perm",
                   "n", "block_size", "colored")


def problem_from_numpy(J, h=None, name: str = "ising") -> IsingProblem:
    """IsingProblem from dense J [N, N] and fields h [N] (zeros if None)."""
    J = np.asarray(J)
    return IsingProblem(J, np.zeros(J.shape[0]) if h is None else h, name=name)


def blocked_from_numpy(b) -> BlockedProblem:
    """The port's BlockedProblem from a BlockedProblem of either package,
    or from a mapping of its numpy fields (J_rows, J_diag, h, active, perm,
    inv_perm, n, block_size, colored). Arrays are copied; pass the result to
    `SweepEngine.from_blocked_problem` to put it on a device."""
    get = b.__getitem__ if isinstance(b, Mapping) else (lambda f: getattr(b, f))
    f = {k: get(k) for k in _BLOCKED_FIELDS}
    return BlockedProblem(
        J_rows=np.array(f["J_rows"]), J_diag=np.array(f["J_diag"]),
        h=np.array(f["h"]), active=np.array(f["active"], dtype=bool),
        perm=np.array(f["perm"], dtype=np.int32),
        inv_perm=np.array(f["inv_perm"], dtype=np.int32),
        n=int(f["n"]), block_size=int(f["block_size"]),
        colored=bool(f["colored"]))


def states_from_numpy(m, *, dtype: Union[str, torch.dtype] = torch.float32,
                      device=None) -> torch.Tensor:
    """Spin states (or any per-spin array) as a tensor on `device`."""
    device = resolve_device(device)
    return torch.as_tensor(np.asarray(m), dtype=resolve_dtype(dtype, device),
                           device=device)


def ensemble_nmc_state_from_numpy(s, generator: torch.Generator, *,
                                  dtype: Union[str, torch.dtype] = torch.float32,
                                  device=None):
    """The port's `EnsembleNMCState` from an EnsembleNMCState of the JAX
    package (or any object or mapping with its fields as numpy arrays: m,
    beta_to_slot, slot_to_beta, round_index, m_best, e_best, cl,
    do_nmc_slot). The JAX key has no counterpart: the draws of the port's
    rounds come from `generator`."""
    from .parallel.ensemble_nmc import EnsembleNMCState
    get = s.__getitem__ if isinstance(s, Mapping) else (lambda f: getattr(s, f))
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)

    def t(f, dt):
        return torch.as_tensor(np.array(get(f)), dtype=dt, device=device)

    return EnsembleNMCState(
        m=t("m", dtype), beta_to_slot=t("beta_to_slot", torch.int64),
        slot_to_beta=t("slot_to_beta", torch.int64), generator=generator,
        round_index=int(np.asarray(get("round_index"))),
        m_best=t("m_best", dtype), e_best=t("e_best", dtype),
        cl=t("cl", torch.bool), do_nmc_slot=t("do_nmc_slot", torch.bool))


def ensemble_icm_state_from_numpy(s, generator: torch.Generator, *,
                                  dtype: Union[str, torch.dtype] = torch.float32,
                                  device=None):
    """The port's `EnsembleICMState` from an EnsembleICMState of the JAX
    package (or any object or mapping with its fields as numpy arrays: m,
    beta_to_slot, slot_to_beta, round_index, m_best, e_best, icm_moves,
    icm_flips, cl, dn). Pure ICM's dummy [I, 1, 1, 1] / [I, 1, 1] masks
    become None, as the port carries no masks there. The JAX key has no
    counterpart: the draws of the port's rounds come from `generator`."""
    from .parallel.ensemble_icm import EnsembleICMState
    get = s.__getitem__ if isinstance(s, Mapping) else (lambda f: getattr(s, f))
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)

    def t(f, dt):
        return torch.as_tensor(np.array(get(f)), dtype=dt, device=device)

    m = t("m", dtype)
    full = tuple(np.shape(get("cl"))) == tuple(m.shape)
    return EnsembleICMState(
        m=m, beta_to_slot=t("beta_to_slot", torch.int64),
        slot_to_beta=t("slot_to_beta", torch.int64), generator=generator,
        round_index=int(np.asarray(get("round_index"))),
        m_best=t("m_best", dtype), e_best=t("e_best", dtype),
        icm_moves=t("icm_moves", torch.int64),
        icm_flips=t("icm_flips", torch.int64),
        cl=t("cl", torch.bool) if full else None,
        dn=t("dn", torch.bool) if full else None)


def sharded_pt_state_from_numpy(s, generator: torch.Generator, *,
                                dtype: Union[str, torch.dtype] = torch.float32,
                                device=None):
    """The port's `ShardedPTState` (all R slots, world size 1) from a
    ShardedPTState of the JAX package (or any object or mapping with its
    fields as numpy arrays: m, beta_to_slot, slot_to_beta, round_index,
    m_best, e_best, cl, do_nmc_slot). The JAX key has no counterpart: the
    draws of the port's rounds come from `generator`."""
    from .parallel.sharded_pt import ShardedPTState
    get = s.__getitem__ if isinstance(s, Mapping) else (lambda f: getattr(s, f))
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)

    def t(f, dt):
        return torch.as_tensor(np.array(get(f)), dtype=dt, device=device)

    return ShardedPTState(
        m=t("m", dtype), beta_to_slot=t("beta_to_slot", torch.int64),
        slot_to_beta=t("slot_to_beta", torch.int64), generator=generator,
        round_index=int(np.asarray(get("round_index"))),
        m_best=t("m_best", dtype), e_best=t("e_best", dtype),
        cl=t("cl", torch.bool), do_nmc_slot=t("do_nmc_slot", torch.bool))


def spin_sharded_state_from_numpy(s, generator: torch.Generator, *,
                                  dtype: Union[str, torch.dtype] = torch.float32,
                                  device=None):
    """The port's `SpinShardedState` (world size 1: every replica, every
    column) from a SpinShardedState of the JAX package (or any object or
    mapping with its fields as numpy arrays: m, phi, step, beta_to_slot,
    slot_to_beta), with `generator` for the draws."""
    from .parallel.spin_sharded import SpinShardedState
    get = s.__getitem__ if isinstance(s, Mapping) else (lambda f: getattr(s, f))
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)

    def t(f, dt):
        return torch.as_tensor(np.array(get(f)), dtype=dt, device=device)

    return SpinShardedState(
        m=t("m", dtype), phi=t("phi", dtype), generator=generator,
        step=int(np.asarray(get("step"))),
        beta_to_slot=t("beta_to_slot", torch.int64),
        slot_to_beta=t("slot_to_beta", torch.int64))
