"""Spin-axis sharding: J larger than one card's memory.

The counterpart of ``nmc_tpu/parallel/spin_sharded.py``. When N spins
outgrow a card, the coupling matrix is split by COLUMN blocks over the
ranks of a 'spin' group, and the cached local fields phi are split the
same way; states m (R x N, +-1) are small and every spin rank holds them
whole. An optional replica axis shards the replica rows on top: the ranks
form a `replica_ranks` x (W / replica_ranks) grid (`distributed.grid_groups`,
rows = replica shards, columns = spin shards).

Colored-sweep step per spin block b (exact Gibbs on a colored layout):
  1. every rank draws the block's uniforms for all R replicas (and keeps
     its replica rows); the block's owner (the rank holding its columns)
     draws the heat-bath update from its phi columns;
  2. dm [R, B] travels over the spin group in one `all_reduce(SUM)`
     (non-owners add zeros), the only communication of a block;
  3. every rank updates its phi columns, phi_loc += dm @ J[b, :, loc], and
     its copy of m.
The layout is padded with empty blocks to a multiple of block_size x (spin
ranks), so no block straddles two ranks; the draws skip those blocks
(they hold no spin), so the padding changes no draw. Energies: each
rank's columns of m * (phi + h), gathered over the spin group, and summed
per replica.

Per-sweep beta schedules (anneal), per-replica beta (tempering ladders)
and per-spin update masks (NMC freezing) are arguments; `swap_round` runs
sweeps at each slot's tempering beta and one Metropolis label swap
(`parallel/swaps.py`) on the gathered energies. With `group=None` the
sweeper runs on one card, unsharded; `distributed.global_group()` shards
it over every rank.

Sharding invariance: every rank draws what one rank would, so the same
generator seed gives the same trajectory on 1 rank, on W spin ranks or on a
2-D grid; the fields are built and updated block by block in the same
order everywhere, so they agree bit for bit wherever the block products'
sums are exact (+-J couplings, as in the tests). The JAX sweeper folds the
replica shard index into its key instead. Injected `uniforms`
[T, nB_real, R, B] (whole ladder, the blocks that hold spins) replace the
draws.

Torch ops, no kernel: the JAX sweeper is an XLA program with no Pallas
call. On a card the per-block step is the hot spot (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.energy import by_rows
from ..core.problem import BlockedProblem, IsingProblem, block_problem
from ..device import resolve_dtype
from ..ops.coloring import color_groups
from ..ops.sweeps import anneal_schedule
from . import distributed
from .swaps import metropolis_label_swap


@dataclasses.dataclass
class SpinShardedConfig:
    """The JAX package's SpinShardedConfig, less `precision` (the port
    turns TF32 off globally, `device.py`)."""
    block_size: int = 128
    dtype: str = "float32"


class SpinShardedState(NamedTuple):
    m: torch.Tensor             # [R_local, n_pad], whole along the spin axis
    phi: torch.Tensor           # [R_local, cols] this rank's columns
    generator: torch.Generator  # in the same state on every rank
    step: int
    beta_to_slot: torch.Tensor  # [R] PT label permutation (identity w/o swaps)
    slot_to_beta: torch.Tensor  # [R]


class SpinShardedSweeper:
    """Colored Gibbs sweeps with J column-sharded over a spin group
    (optionally replica-sharded over `replica_ranks` rows of ranks)."""

    def __init__(
        self,
        problem: IsingProblem,
        cfg: SpinShardedConfig = SpinShardedConfig(),
        *,
        group=None,
        replica_ranks: int = 1,
        device=None,
    ):
        self.cfg = cfg
        self.group = group
        self.spin_group, self.replica_group, self.replica_index, \
            self.spin_index = distributed.grid_groups(replica_ranks, group)
        self.replica_ranks = replica_ranks
        self.n_dev = distributed.group_shape(group)[0] // replica_ranks
        self.device = dev = (distributed.rank_device() if device is None
                             else torch.device(device))
        self.dtype = dtype = resolve_dtype(cfg.dtype, dev)
        np_dtype = np.dtype(str(dtype).split(".")[-1])
        B = cfg.block_size
        groups = color_groups(problem.J)
        blocked = block_problem(problem, block_size=B, groups=groups,
                                dtype=np_dtype)
        if not blocked.colored:
            raise ValueError("spin sharding requires a colored layout")
        self.nB_real = blocked.num_blocks      # the blocks that hold spins
        need = (-blocked.n_pad) % (B * self.n_dev)
        if need:
            # empty filler blocks so no block straddles two ranks
            blocked = _pad_blocked(problem, B, groups, np_dtype,
                                   extra_blocks=need // B)
        self.blocked: BlockedProblem = blocked
        self.n_pad = blocked.n_pad
        self.nB = blocked.num_blocks
        self.B = B
        self.cols_per_dev = cols = self.n_pad // self.n_dev
        self.c0 = self.spin_index * cols
        loc = slice(self.c0, self.c0 + cols)
        # the only O(N^2) array, split n_dev ways: J[:, :, loc]
        self.J_rows = torch.as_tensor(
            np.ascontiguousarray(blocked.J_rows[:, :, loc]), dtype=dtype,
            device=dev)
        self.h = torch.as_tensor(blocked.h[loc], dtype=dtype, device=dev)
        self.active = torch.as_tensor(blocked.active, device=dev)

    # ------------------------------------------------------------------
    def _replica_rows(self, R):
        if R % self.replica_ranks:
            raise ValueError(f"{R} replicas do not split over "
                             f"{self.replica_ranks} replica ranks")
        R_loc = R // self.replica_ranks
        return self.replica_index * R_loc, R_loc

    def _fields(self, m):
        """phi = m J[:, loc] + h[loc], block by block as the sweeps add."""
        phi = self.h.expand(m.shape[0], -1).clone()
        B = self.B
        for b in range(self.nB):
            phi = phi + torch.matmul(m[:, b * B:(b + 1) * B], self.J_rows[b])
        return phi

    def init_state(self, generator: torch.Generator,
                   num_replicas: int) -> SpinShardedState:
        r0, R_loc = self._replica_rows(num_replicas)
        n_real = self.nB_real * self.B       # no draws for filler blocks
        u = torch.rand((num_replicas, n_real), generator=generator,
                       dtype=self.dtype, device=self.device)
        m = torch.ones((num_replicas, self.n_pad), dtype=self.dtype,
                       device=self.device)
        m[:, :n_real] = torch.where(u < 0.5, -1.0, 1.0).to(self.dtype)
        m = torch.where(self.active, m, 1.0).to(self.dtype)[r0:r0 + R_loc]
        ids = torch.arange(num_replicas, device=self.device)
        return SpinShardedState(m=m.clone(), phi=self._fields(m),
                                generator=generator, step=0,
                                beta_to_slot=ids, slot_to_beta=ids.clone())

    # ------------------------------------------------------------------
    def sweeps(self, state: SpinShardedState, num_sweeps: int, beta, *,
               anneal: bool = False, initial_beta: float = 0.0,
               beta_replica=None, update_mask=None,
               uniforms: Optional[torch.Tensor] = None):
        """Run `num_sweeps` colored sweeps; returns (state, energies of the
        rank's replicas [R_local]).

        beta: scalar | [T] per-sweep schedule (or anneal=True builds the
        reference's linear ramp); beta_replica: [R] tempering ladder;
        update_mask: [n_pad] / [R, n_pad] bool (False = frozen, blocked
        layout); uniforms: [T, nB_real, R, B] injected draws (the blocks
        that hold spins)."""
        R_loc = state.m.shape[0]
        R = R_loc * self.replica_ranks
        r0 = self.replica_index * R_loc
        dt, dev, B = self.dtype, self.device, self.B
        if anneal:
            beta_sweep = anneal_schedule(num_sweeps, float(beta),
                                         float(initial_beta), 1, dtype=dt,
                                         device=dev)
        else:
            beta_sweep = torch.as_tensor(beta, dtype=dt,
                                         device=dev).expand(num_sweeps)
        beta_rep = (torch.ones((R_loc, 1), dtype=dt, device=dev)
                    if beta_replica is None else
                    torch.as_tensor(beta_replica, dtype=dt, device=dev)
                    .reshape(R, 1)[r0:r0 + R_loc])
        upd = self.active.expand(R_loc, self.n_pad)
        if update_mask is not None:
            mask = torch.as_tensor(update_mask, dtype=torch.bool, device=dev)
            mask = mask.expand(R, self.n_pad)[r0:r0 + R_loc]
            upd = mask & self.active
        if uniforms is not None and tuple(uniforms.shape) != (
                num_sweeps, self.nB_real, R, B):
            raise ValueError(f"uniforms must be [{num_sweeps}, "
                             f"{self.nB_real}, {R}, {B}], got "
                             f"{tuple(uniforms.shape)}")
        m, phi = state.m.clone(), state.phi
        cols = self.cols_per_dev
        for t in range(num_sweeps):
            beta_t = beta_sweep[t] * beta_rep                    # [R_loc, 1]
            for b in range(self.nB_real):
                s = b * B
                u = (uniforms[t, b] if uniforms is not None else
                     torch.rand((R, B), generator=state.generator, dtype=dt,
                                device=dev))[r0:r0 + R_loc]
                mb = m[:, s:s + B]
                if s // cols == self.spin_index:
                    xb = phi[:, s - self.c0:s - self.c0 + B]
                    p_up = 0.5 * (1.0 + torch.tanh(beta_t * xb))
                    new = torch.where(u < p_up, 1.0, -1.0).to(dt)
                    dm = torch.where(upd[:, s:s + B], new, mb) - mb
                else:
                    dm = torch.zeros_like(mb)
                dm = distributed.sum_(dm, self.spin_group)
                phi = phi + torch.matmul(dm, self.J_rows[b])
                m[:, s:s + B] = mb + dm
        return state._replace(m=m, phi=phi,
                              step=state.step + num_sweeps), self._energy(m,
                                                                         phi)

    def _energy(self, m, phi):
        """-0.5 m.(phi + h) per replica: the rank's columns of the terms,
        gathered over the spin group, summed one row at a time when
        sharded."""
        terms = m[:, self.c0:self.c0 + self.cols_per_dev] * (phi + self.h)
        full = distributed.gather_rows(terms.T.contiguous(), self.c0,
                                       self.n_pad, self.spin_group).T
        return -0.5 * by_rows(lambda x: torch.sum(x, -1), full,
                              sharded=self.group is not None)

    # ------------------------------------------------------------------
    def swap_round(self, state: SpinShardedState, num_sweeps: int,
                   beta_list, *, num_swapping_pairs: int = 1,
                   uniforms=None, gumbels=None, swap_uniforms=None):
        """One NPT-style round at spin-sharded scale: sweeps with each
        slot's tempering beta, then a Metropolis label swap on the gathered
        energies, the same decision on every rank. beta_list: [R] sorted
        inverse temperatures. Returns (state, energies [R])."""
        R = state.beta_to_slot.shape[0]
        beta_list = torch.as_tensor(beta_list, dtype=self.dtype,
                                    device=self.device).reshape(R)
        state, e = self.sweeps(state, num_sweeps, 1.0,
                               beta_replica=beta_list[state.slot_to_beta],
                               uniforms=uniforms)
        e_all = distributed.gather_rows(
            e, self.replica_index * e.shape[0], R, self.replica_group)
        swap = metropolis_label_swap(
            state.beta_to_slot[None], beta_list.to(torch.float32),
            e_all[None].to(torch.float32), num_pairs=num_swapping_pairs,
            generator=state.generator, gumbels=gumbels,
            uniforms=swap_uniforms)
        return state._replace(beta_to_slot=swap.beta_to_slot[0],
                              slot_to_beta=swap.slot_to_beta[0]), e_all

    def states(self, state: SpinShardedState) -> np.ndarray:
        """[R, n] states in original spin order, numpy (gathered)."""
        m = distributed.gather_rows(
            state.m, self.replica_index * state.m.shape[0],
            state.beta_to_slot.shape[0], self.replica_group)
        return m[:, torch.as_tensor(self.blocked.inv_perm,
                                    device=m.device).long()].cpu().numpy()


def _pad_blocked(problem, block_size, groups, np_dtype, extra_blocks):
    """block_problem with extra empty padding blocks appended."""
    blocked = block_problem(problem, block_size=block_size, groups=groups,
                            dtype=np_dtype)
    if extra_blocks == 0:
        return blocked
    n_pad = blocked.n_pad + extra_blocks * block_size
    nb = n_pad // block_size

    def pad2(a, shape):
        out = np.zeros(shape, dtype=a.dtype)
        out[tuple(slice(0, s) for s in a.shape)] = a
        return out

    Jp = pad2(blocked.J_rows.reshape(blocked.n_pad, blocked.n_pad),
              (n_pad, n_pad))
    return BlockedProblem(
        J_rows=Jp.reshape(nb, block_size, n_pad),
        J_diag=np.stack([Jp[b * block_size:(b + 1) * block_size,
                            b * block_size:(b + 1) * block_size]
                         for b in range(nb)]),
        h=pad2(blocked.h, (n_pad,)),
        active=pad2(blocked.active, (n_pad,)),
        perm=np.concatenate([blocked.perm,
                             np.full(extra_blocks * block_size, -1,
                                     np.int32)]),
        inv_perm=blocked.inv_perm,
        n=blocked.n,
        block_size=block_size,
        colored=True,
    )
