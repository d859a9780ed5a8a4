"""Instance ensembles of independent parallel-tempering runs on one card.

The counterpart of ``nmc_tpu/parallel/ensemble.py``'s `EnsemblePT`: an
ensemble of same-size Ising instances (BASELINE.json config 5, "100
SK-1000 instances x 64 replicas") is a leading instance axis I, with
replicas R inside each instance. Each instance runs its own replica
ladder; swaps are beta-label permutations (`parallel/swaps.py`) batched
over the instances, so a round involves no cross-instance work.

A round per instance: fresh local fields, `sweeps_per_round` sweeps at the
slot temperatures, Metropolis label swaps on the last sweep's energies and
the fold of the round's best state into the instance's best. The fields,
swaps and best fold run batched over instances, and so do the sweeps on
an f32 layout with the sequential sweep (the default):
`sequential_sweeps_batched` over the instances' union layout
(`sequential_neighbors`, built once here), one kernel launch a round on
the card for every instance, as JAX vmaps them (on a CUDA device a
layout past `sequential_kernel_limit` raises at construction); otherwise
(f64, or within_block="jacobi") the plain `run_sweeps` per instance, a
route fixed at construction.

With a `group=` (a `torch.distributed` process group) the instances are
sharded over its ranks: rank k holds instances [k I / W, (k + 1) I / W)
(the largest rank count dividing I; the ranks past it hold none), and a
round involves no communication. Every rank draws a round's randomness
for all I instances and keeps its own: the sweeps' seed words in one
[I, 2] draw on the card (an instance's draws depend on its seed words
alone, so a rank's launch draws the whole launch's rows), or on the CPU the uniforms instance after instance in the unsharded order
(`ensemble_nmc.InstanceDraws`), then the
swaps' Gumbels and uniforms; so the same seed gives the same trajectory
at any world size (a sharded round's fields run per instance,
`core.energy.by_rows`). `best_states` / `best_energies` gather the
instances on every rank. Without a group the instance count is never cut.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.energy import by_rows, local_fields
from ..core.problem import IsingProblem, block_problem
from ..device import resolve_device, resolve_dtype
from ..ops.sweeps import SweepResult, run_sweeps
from ..ops.sweeps_cuda import (sequential_kernel_limit, sequential_neighbors,
                               sequential_sweeps_batched)
from ..utils.metrics import RoundSpans
from . import distributed
from .ensemble_nmc import InstanceDraws, RoundDraws
from .swaps import metropolis_label_swap, swap_draws


@dataclasses.dataclass
class EnsembleConfig:
    """The JAX package's EnsembleConfig, less `precision` (the port turns
    TF32 off globally, `device.py`)."""
    num_replicas: int = 16
    sweeps_per_round: int = 32
    num_swapping_pairs: int = 4
    block_size: int = 128
    within_block: str = "sequential"
    dtype: str = "float32"


class EnsembleState(NamedTuple):
    m: torch.Tensor             # [I, R, n_pad]
    beta_to_slot: torch.Tensor  # [I, R]
    slot_to_beta: torch.Tensor  # [I, R]
    best_e: torch.Tensor        # [I] best energy seen per instance
    best_m: torch.Tensor        # [I, n_pad]
    generator: torch.Generator  # every draw of the rounds (JAX: the key)
    round_index: int


class EnsemblePT:
    """An ensemble of independent PT runs (one per instance) on one card."""

    def __init__(
        self,
        problems: Sequence[IsingProblem],
        beta_list: Sequence[float],
        cfg: EnsembleConfig = EnsembleConfig(),
        *,
        device=None,
        group=None,
    ):
        self.cfg = cfg
        if len({p.n for p in problems}) != 1:
            raise ValueError("ensemble instances must share the same size")
        self.group = group
        self.I_total = len(problems)
        self.i0, self.I = distributed.instance_shard(self.I_total, group)
        self.beta_np = np.asarray(beta_list, dtype=np.float64)
        self.R = self.beta_np.shape[0]
        self.device = dev = resolve_device(device)
        self.dtype = dtype = resolve_dtype(cfg.dtype, dev)
        np_dtype = np.dtype(str(dtype).split(".")[-1])
        blocked = [block_problem(p, block_size=cfg.block_size, dtype=np_dtype)
                   for p in problems[self.i0:self.i0 + self.I]]
        self.blocked0 = (blocked or [block_problem(
            problems[0], block_size=cfg.block_size, dtype=np_dtype)])[0]
        self.n_pad = n_pad = self.blocked0.n_pad

        def put(x, dt=dtype):
            return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

        def stack(f):
            return put(np.stack([getattr(b, f) for b in blocked]) if blocked
                       else np.zeros((0,) + getattr(self.blocked0, f).shape))

        self.J_rows = stack("J_rows")
        self.J_diag = stack("J_diag")
        self.J_full = self.J_rows.reshape(self.I, n_pad, n_pad)
        self.h = stack("h")
        self.active = put(self.blocked0.active, torch.bool)
        self._inv_perm = torch.as_tensor(self.blocked0.inv_perm,
                                         dtype=torch.int64, device=dev)
        self.beta_list = put(self.beta_np)
        self.sweep_kernel = self.sweep_nbrs = None
        if cfg.within_block == "sequential" and dtype == torch.float32:
            self.sweep_kernel = "sequential_sweeps_batched"
            limit = sequential_kernel_limit(n_pad, cfg.block_size)
            if limit and dev.type == "cuda":
                raise ValueError(f"the sequential kernel cannot take this "
                                 f"layout: {limit}")
            if self.I and not limit:
                self.sweep_nbrs = sequential_neighbors(self.J_rows)
        self._spans = RoundSpans("EnsemblePT", dev)

    def init_state(self, generator: torch.Generator,
                   m0=None) -> EnsembleState:
        """Random +-1 start. `m0` (optional, [I, C, n] ORIGINAL spin order,
        ascending energy, e.g. `ops.spectral.spectral_candidates` states)
        seeds the C coldest chains (largest beta = highest slot index at
        init) per instance, best candidate coldest; the remaining R - C
        chains stay random."""
        I, R, n_pad = self.I, self.R, self.n_pad
        u = torch.rand((self.I_total, R, n_pad), generator=generator,
                       dtype=self.dtype, device=self.device)
        m = torch.where(u < 0.5, -1.0, 1.0).to(self.dtype)
        m = m[self.i0:self.i0 + I]
        if m0 is not None:
            m0 = np.asarray(m0)[self.i0:self.i0 + I]
            m0 = torch.as_tensor(self.blocked0.to_blocked(np.asarray(m0),
                                                          fill=1.0),
                                 dtype=self.dtype, device=self.device)
            C = m0.shape[1]
            if C > R:
                raise ValueError(f"m0 has {C} seeds > {R} replicas")
            m[:, R - C:, :] = m0.flip(1)
        m = torch.where(self.active, m, 1.0).to(self.dtype)
        ids = torch.arange(R, device=self.device).expand(I, R)
        return EnsembleState(
            m=m, beta_to_slot=ids.clone(), slot_to_beta=ids.clone(),
            best_e=torch.full((I,), float("inf"), dtype=self.dtype,
                              device=self.device),
            best_m=torch.ones((I, n_pad), dtype=self.dtype,
                              device=self.device),
            generator=generator, round_index=0)

    def _sweeps(self, m, phi, sweep, beta_slot) -> SweepResult:
        """One round's sweeps of the local instances at the slot
        temperatures beta_slot [I, R, 1], from `sweep`'s generator, seed
        words (the kernel) or uniforms; outputs [I, ...]."""
        cfg = self.cfg
        T = cfg.sweeps_per_round
        ones_t = torch.ones((T,), dtype=self.dtype, device=self.device)
        if self.sweep_kernel is not None:
            return sequential_sweeps_batched(
                self.J_rows, self.J_diag, self.h, m, phi, sweep.generator,
                ones_t, beta_slot, self.active, num_sweeps=T,
                nbrs=self.sweep_nbrs, **sweep.batched_kw(0))
        act = self.active.expand(self.R, self.n_pad)
        res = [run_sweeps(
            self.J_rows[i], self.J_diag[i], self.h[i], m[i], phi[i],
            sweep.generator, ones_t, beta_slot[i], act, num_sweeps=T,
            within_block=cfg.within_block, uniforms=sweep.kw(i, 0)["uniforms"])
            for i in range(self.I)]
        return SweepResult(*(None if xs[0] is None else torch.stack(xs)
                             for xs in zip(*res)))

    def round(self, state: EnsembleState,
              draws: Optional[RoundDraws] = None,
              timings: Optional[Dict[str, Any]] = None) -> EnsembleState:
        """One round of every instance. `draws` may inject its draws for
        the whole ensemble: sweep_uniforms [1, T, I, R, n_pad] (one phase),
        gumbels [I, num_pairs, R - 1] and swap_uniforms [I, num_pairs].
        With a `timings` dict the round records sync-free stage spans
        (`utils.metrics.RoundSpans`): the device seconds of "fields" (the
        round's draws and fresh local fields), "round" (the sweeps) and
        "swaps" (label swaps and the best fold), with "rounds", "host_s"
        and "host_syncs"; it lands in the dict once the card has passed
        it, at the latest at `best_states`, `best_energies` or `flush`."""
        d = draws if draws is not None else RoundDraws()
        lo, hi = self.i0, self.i0 + self.I
        if self.I == 0:
            return state._replace(round_index=state.round_index + 1)
        spans = self._spans
        with spans.round(timings):
            with spans.stage("fields"):
                beta_slot = self.beta_list[state.slot_to_beta]       # [I, R]
                sweep = InstanceDraws(self, state.generator, 1,
                                      self.cfg.sweeps_per_round, self.R,
                                      d.sweep_uniforms,
                                      self.sweep_kernel is not None)
                phi = by_rows(local_fields, self.J_full, self.h[:, None, :],
                              state.m, sharded=self.group is not None)
            with spans.stage("round"):
                res = self._sweeps(state.m, phi, sweep, beta_slot[..., None])
                sweep.finish()
            with spans.stage("swaps"):
                m, e_best, m_best = res.m, res.e_best, res.m_best  # [I, R, ..]
                e_slot = res.energies[:, -1]                       # [I, R]
                npairs = self.cfg.num_swapping_pairs
                if d.gumbels is None:
                    g, su = swap_draws(state.generator, self.I_total, npairs,
                                       self.R, lo, self.I)
                else:
                    g, su = d.gumbels[lo:hi], d.swap_uniforms[lo:hi]
                swap = metropolis_label_swap(
                    state.beta_to_slot, self.beta_list.to(torch.float32),
                    e_slot.to(torch.float32), num_pairs=npairs, gumbels=g,
                    uniforms=su)
                r = torch.argmin(e_best, dim=1, keepdim=True)      # [I, 1]
                e_r = torch.gather(e_best, 1, r)[:, 0]
                m_r = torch.gather(m_best, 1,
                                   r[..., None].expand(-1, 1, self.n_pad))[:, 0]
                improved = e_r < state.best_e
                best_e = torch.where(improved, e_r, state.best_e)
                best_m = torch.where(improved[:, None], m_r, state.best_m)
        return EnsembleState(
            m=m, beta_to_slot=swap.beta_to_slot,
            slot_to_beta=swap.slot_to_beta, best_e=best_e, best_m=best_m,
            generator=state.generator, round_index=state.round_index + 1)

    def run(self, state: EnsembleState, num_rounds: int, *,
            draws: Optional[Callable[[int], RoundDraws]] = None
            ) -> EnsembleState:
        """`num_rounds` rounds; `draws(round_index)` may inject each
        round's draws."""
        for _ in range(num_rounds):
            state = self.round(state, None if draws is None
                               else draws(state.round_index))
        return state

    def best_states(self, state: EnsembleState) -> np.ndarray:
        """[I, n] best states per instance, original spin order (every
        instance, gathered over the group)."""
        out = distributed.host_gather(state.best_m[:, self._inv_perm],
                                      self.group)
        self._spans.collect()
        return out

    def best_energies(self, state: EnsembleState) -> np.ndarray:
        out = distributed.host_gather(state.best_e, self.group)
        self._spans.collect()
        return out

    def flush(self) -> None:
        """Sum every round recorded with a `timings` dict into it, waiting
        for the card to pass them (the best calls do so without
        waiting)."""
        self._spans.flush()
