"""SweepEngine: the one sweep entry point every algorithm driver calls.

Owns the device copies of a BlockedProblem and runs batched sweeps in
ORIGINAL spin order (permutation and padding handled internally); the
counterpart of ``nmc_tpu/ops/engine.py``.

Routing of a colored, block-Jacobi, fixed-order run, as in the JAX engine
(`sweep_kernel` names the choice, made once at setup from the layout):
  * n_pad <= 1536: `colored_sweeps` (K1, whose Pallas kernel holds dense J);
  * above, when every row block touches at most nB/2 column tiles of J:
    `colored_sweeps_sparse` (K3, the block-sparse tiles, built at setup);
  * else `colored_sweeps_streamed` (K2, dense J row blocks).
K1, K2 and K3 launch one kernel body over a neighbour layout
(`sweep_nbrs`, a `SweepNeighbors` whose steps are the colour classes),
built once at setup from J and passed on every call; K1 gets a scalar
beta_spin when nothing is heated and the active row as a one-row mask when
no update mask is given, so that it reads neither as [R, n_pad]. Each
wrapper launches its CUDA kernel on a CUDA device and runs its plain torch
version (from J or the tiles) on the CPU.

An uncoloured f32 layout with the sequential fixed-order sweep (the
drivers' default, which JAX ran through XLA) takes `sequential_sweeps`,
JAX's blocked algorithm in its own kernel, over the layout of J's couplings
in its row blocks (`sequential_neighbors`, built at setup as `sweep_nbrs`;
blocks above 128 spins run in sub-blocks) and the diagonal tiles J_diag.
On a CUDA device a layout past the kernel's limits
(`sequential_kernel_limit`: n_pad up to 32768) raises at setup; on the
CPU the wrapper runs `run_sweeps`. Recorded runs (`record_m`) stay on
these routes: the kernels write the state after every sweep. The other
uncoloured runs (f64, as the kernels are f32 like JAX's Pallas route;
random block order; block-Jacobi) and random block order on a coloured
layout run `ops/sweeps.run_sweeps` in plain torch, a route fixed at
setup.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..core.energy import local_fields
from ..core.problem import (BlockedProblem, IsingProblem, block_problem,
                            block_sparse_tiles)
from ..device import resolve_device, resolve_dtype
from .sweeps import SweepResult, anneal_schedule, run_sweeps
from .sweeps_cuda import (_cpu_uniforms, colored_sweeps,
                          colored_sweeps_sparse, colored_sweeps_streamed,
                          sequential_kernel_limit, sequential_neighbors,
                          sequential_sweeps, slice_axis,
                          steps_are_independent, sweep_neighbors_from_dense)

# Largest n_pad the dense colored kernel K1 serves; above it the JAX package
# streams J (K2, or K3 for block-sparse layouts), and so does the port.
K1_MAX_N_PAD = 1536


class EngineResult(NamedTuple):
    """Sweep outputs gathered back to original spin order."""
    m: torch.Tensor          # [R, n]
    m_best: torch.Tensor     # [R, n]
    e_best: torch.Tensor     # [R]
    energies: torch.Tensor   # [T, R]
    M: Optional[torch.Tensor]  # [T, R, n] if recorded


class SweepEngine:
    def __init__(
        self,
        problem: IsingProblem,
        *,
        block_size: int = 128,
        groups: Optional[list] = None,
        use_coloring: bool = False,
        within_block: str = "sequential",
        block_order: str = "fixed",
        dtype: Union[str, torch.dtype] = torch.float32,
        device: Union[str, torch.device, None] = None,
    ):
        if use_coloring and groups is None:
            from .coloring import color_groups
            groups = color_groups(problem.J)
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype, self.device)
        blocked = block_problem(problem, block_size=block_size, groups=groups,
                                dtype=np.dtype(str(self.dtype).split(".")[-1]))
        self._setup(problem, blocked, within_block, block_order)

    @classmethod
    def from_blocked_problem(
        cls, blocked: BlockedProblem, problem: IsingProblem, *,
        within_block: str = "sequential", block_order: str = "fixed",
        dtype: Union[str, torch.dtype] = torch.float32,
        device: Union[str, torch.device, None] = None,
    ) -> "SweepEngine":
        """An engine on a layout built elsewhere (e.g. carried over from
        the JAX package with `interop.blocked_from_numpy`), so both
        packages sweep identical J, h and permutation."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype, self.device)
        self._setup(problem, blocked, within_block, block_order)
        return self

    def _setup(self, problem, blocked, within_block, block_order):
        self.problem = problem
        self.blocked = blocked
        self.block_order = block_order
        # Colored layouts make the all-at-once block update exact Gibbs.
        self.within_block = "jacobi" if blocked.colored else within_block
        dev, dt = self.device, self.dtype
        self.J_rows = torch.as_tensor(blocked.J_rows, dtype=dt, device=dev)
        self.J_diag = torch.as_tensor(blocked.J_diag, dtype=dt, device=dev)
        self.h = torch.as_tensor(blocked.h, dtype=dt, device=dev)
        self.J_full = self.J_rows.reshape(blocked.n_pad, blocked.n_pad)
        self.active = torch.as_tensor(blocked.active, device=dev)
        self._inv_perm = torch.as_tensor(blocked.inv_perm, dtype=torch.long,
                                         device=dev)
        self.stream_tiles = self.sweep_nbrs = self.sweep_kernel = None
        if not blocked.colored:
            if (self.within_block == "sequential" and block_order == "fixed"
                    and dt == torch.float32):
                self.sweep_kernel = "sequential_sweeps"
                limit = sequential_kernel_limit(blocked.n_pad,
                                                blocked.block_size)
                if limit and dev.type == "cuda":
                    raise ValueError(f"the sequential kernel cannot take "
                                     f"this layout: {limit}")
                if not limit:
                    self.sweep_nbrs = sequential_neighbors(self.J_rows)
            return
        if blocked.n_pad <= K1_MAX_N_PAD:
            self.sweep_kernel = "colored_sweeps"
        else:
            col_idx, J_tiles = block_sparse_tiles(blocked)
            if col_idx.shape[1] <= blocked.num_blocks // 2:
                self.sweep_kernel = "colored_sweeps_sparse"
                # read by the plain version on the CPU
                self.stream_tiles = (
                    torch.as_tensor(col_idx, dtype=torch.int32, device=dev),
                    torch.as_tensor(J_tiles, dtype=dt, device=dev))
            else:
                self.sweep_kernel = "colored_sweeps_streamed"
        self.sweep_nbrs = sweep_neighbors_from_dense(self.J_rows)
        if not steps_are_independent(self.sweep_nbrs):
            raise ValueError("a sweep step of the colored layout holds a "
                             "coupled pair")

    # ---- layout helpers -------------------------------------------------
    @property
    def n(self) -> int:
        return self.blocked.n

    @property
    def n_pad(self) -> int:
        return self.blocked.n_pad

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype or self.dtype, device=self.device)

    def to_blocked(self, x, fill=0.0) -> torch.Tensor:
        """[..., n] original order -> [..., n_pad] blocked layout."""
        x = self._tensor(x)
        out = torch.full(x.shape[:-1] + (self.n_pad,), fill, dtype=self.dtype,
                         device=self.device)
        out[..., self._inv_perm] = x
        return out

    def to_blocked_mask(self, mask) -> torch.Tensor:
        mask = self._tensor(mask, torch.bool)
        out = torch.zeros(mask.shape[:-1] + (self.n_pad,), dtype=torch.bool,
                          device=self.device)
        out[..., self._inv_perm] = mask
        return out

    def from_blocked(self, x) -> torch.Tensor:
        """[..., n_pad] blocked layout -> [..., n] original order."""
        return torch.as_tensor(x, device=self.device)[..., self._inv_perm]

    def init_states(self, generator: torch.Generator,
                    num_replicas: int) -> torch.Tensor:
        """Random +-1 states, blocked layout [R, n_pad] (+1 on padding)."""
        u = torch.rand((num_replicas, self.n_pad), generator=generator,
                       dtype=self.dtype, device=self.device)
        m = torch.where(u < 0.5, -1.0, 1.0).to(self.dtype)
        return torch.where(self.active, m, 1.0).to(self.dtype)

    def fields(self, m_blocked) -> torch.Tensor:
        return local_fields(self.J_full, self.h, m_blocked)

    # ---- main entry ------------------------------------------------------
    def run(
        self,
        m_start,                 # [R, n] original order, or [R, n_pad] if blocked_input
        generator: Optional[torch.Generator],
        num_sweeps: int,
        beta,                    # scalar | [T] per-sweep schedule
        *,
        anneal: bool = False,
        sweeps_per_beta: int = 1,
        initial_beta: float = 0.0,
        beta_spin=None,          # [n] | [R, n] per-spin beta multiplier (heating)
        beta_replica=None,       # [R] per-replica beta multiplier (PT)
        update_mask=None,        # [n] | [R, n] bool; False = frozen
        record_m: bool = False,
        blocked_input: bool = False,
        blocked_output: bool = False,
        uniforms: Optional[torch.Tensor] = None,  # [T, R, n_pad] injected draws
        phi: Optional[torch.Tensor] = None,       # [R, n_pad] fields of a blocked m_start
        replica_offset: int = 0,                  # global index of row 0
        replicas_total: Optional[int] = None,     # the whole ladder's R
        seed: Optional[torch.Tensor] = None,      # int32 [2] (kernel routes)
    ) -> EngineResult | SweepResult:
        """`num_sweeps` sweeps of the replicas in `m_start`. A run of a
        slice of a larger ladder passes its first row's global index and
        the ladder's size: the kernels key their draws by global rows and
        the plain routes draw the whole ladder's uniforms and keep the
        slice's (`ops/sweeps_cuda.py`). `phi` (blocked input only) skips
        the fields' product."""
        m0 = self._tensor(m_start)
        if m0.ndim == 1:
            m0 = m0[None, :]
        if not blocked_input:
            m0 = torch.where(self.active, self.to_blocked(m0), 1.0).to(self.dtype)
        R = m0.shape[0]

        if anneal:
            beta_sweep = anneal_schedule(num_sweeps, float(beta),
                                         float(initial_beta), sweeps_per_beta,
                                         dtype=self.dtype, device=self.device)
        else:
            beta_sweep = self._tensor(beta)

        if beta_replica is not None:
            if beta_spin is not None:
                raise ValueError("pass beta_spin or beta_replica, not both")
            bs = self._tensor(beta_replica).reshape(R, 1)
        elif beta_spin is None:
            bs = torch.ones((), dtype=self.dtype, device=self.device)
        else:
            bs = self._tensor(beta_spin)
            if not blocked_input:
                bs = self.to_blocked(bs.expand(R, self.n), fill=1.0)

        if update_mask is None:
            mask = self.active.expand(R, self.n_pad)
        else:
            mask = self._tensor(update_mask, torch.bool)
            if not blocked_input:
                mask = self.to_blocked_mask(mask.expand(R, self.n))
            mask = mask & self.active

        if phi is None:
            phi = self.fields(m0)
        elif not blocked_input:
            raise ValueError("phi= needs blocked_input=True")
        shard = dict(replica_offset=replica_offset,
                     replicas_total=replicas_total, seed=seed)

        if self.sweep_kernel == "sequential_sweeps":
            res = sequential_sweeps(
                self.J_rows, self.J_diag, self.h, m0, phi, generator,
                beta_sweep, bs, mask, num_sweeps=num_sweeps,
                record_m=record_m, uniforms=uniforms, nbrs=self.sweep_nbrs,
                **shard)
        elif (self.sweep_kernel is not None
              and self.within_block == "jacobi"
              and self.block_order == "fixed"):
            res = self._run_kernel(m0, phi, generator, beta_sweep, bs, mask,
                                   beta_replica, beta_spin is not None,
                                   update_mask is not None, num_sweeps,
                                   uniforms, record_m, shard)
        else:
            if self.block_order == "random":
                if replica_offset or replicas_total not in (None, R):
                    raise ValueError("random block order runs whole "
                                     "ladders only")
            else:
                uniforms = _cpu_uniforms(
                    generator, uniforms, seed, (num_sweeps,),
                    (slice_axis("replicas", replica_offset, R,
                                replicas_total),),
                    self.n_pad, self.dtype, self.device)
            res = run_sweeps(
                self.J_rows, self.J_diag, self.h, m0, phi, generator,
                beta_sweep, bs, mask, num_sweeps=num_sweeps,
                within_block=self.within_block, block_order=self.block_order,
                record_m=record_m, uniforms=uniforms)
        if blocked_output:
            return res
        return EngineResult(
            m=self.from_blocked(res.m),
            m_best=self.from_blocked(res.m_best),
            e_best=res.e_best,
            energies=res.energies,
            M=self.from_blocked(res.M) if res.M is not None else None,
        )

    def _run_kernel(self, m0, phi, generator, beta_sweep, bs, mask,
                    beta_replica, has_bs, has_mask, num_sweeps, uniforms,
                    record_m, shard):
        """The colored sweep kernel chosen at setup (`sweep_kernel`)."""
        mask_arg = mask if has_mask else self.active.reshape(1, self.n_pad)
        if self.sweep_kernel == "colored_sweeps":
            cres = colored_sweeps(
                self.J_full, self.h, m0, phi, generator, beta_sweep, bs,
                mask_arg, num_sweeps=num_sweeps,
                block_size=self.blocked.block_size, uniforms=uniforms,
                nbrs=self.sweep_nbrs, record_m=record_m, **shard)
        else:
            # the streamed kernels' parameters, as the JAX engine passes them
            R = m0.shape[0]
            beta_row = (self._tensor(beta_replica).reshape(R)
                        if beta_replica is not None
                        else torch.ones((R,), dtype=self.dtype,
                                        device=self.device))
            bs_arg = bs.expand(R, self.n_pad) if has_bs else None
            if self.sweep_kernel == "colored_sweeps_sparse":
                col_idx, J_tiles = self.stream_tiles
                cres = colored_sweeps_sparse(
                    col_idx, J_tiles, self.h, m0, phi, generator, beta_sweep,
                    beta_row, mask_arg, bs_arg, num_sweeps=num_sweeps,
                    uniforms=uniforms, nbrs=self.sweep_nbrs,
                    record_m=record_m, **shard)
            else:
                cres = colored_sweeps_streamed(
                    self.J_rows, self.h, m0, phi, generator, beta_sweep,
                    beta_row, mask_arg, bs_arg, num_sweeps=num_sweeps,
                    uniforms=uniforms, nbrs=self.sweep_nbrs,
                    record_m=record_m, **shard)
        return SweepResult(m=cres.m, phi=cres.phi, m_best=cres.m_best,
                           e_best=cres.e_best, energies=cres.energies,
                           M=cres.M if record_m else None)
