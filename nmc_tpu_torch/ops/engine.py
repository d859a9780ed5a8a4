"""SweepEngine: the one sweep entry point every algorithm driver calls.

Owns the device copies of a BlockedProblem and runs batched sweeps in
ORIGINAL spin order (permutation and padding handled internally); the
counterpart of ``nmc_tpu/ops/engine.py``.

Routing:
  * a colored, block-Jacobi, fixed-order run without state recording goes
    to `colored_sweeps` — the CUDA kernel (K1) on a CUDA device, its plain
    torch version on the CPU. On CUDA the kernel covers n_pad <= 1536; the
    larger layouts belong to the streamed kernels K2/K3, which are not
    ported yet, so they raise rather than quietly run the plain path;
  * everything else (sequential within-block scans, recorded states) runs
    `ops/sweeps.run_sweeps` in plain torch, as JAX ran it through XLA.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..core.energy import local_fields
from ..core.problem import BlockedProblem, IsingProblem, block_problem
from ..device import resolve_device, resolve_dtype
from .sweeps import SweepResult, anneal_schedule, run_sweeps
from .sweeps_cuda import colored_sweeps

# Largest n_pad the resident-J colored kernel serves on CUDA; above it the
# JAX package streams J (K2, or K3 for block-sparse layouts).
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
        update_mask=None,        # [n] | [R, n] bool; False = frozen
        record_m: bool = False,
        blocked_input: bool = False,
        blocked_output: bool = False,
        uniforms: Optional[torch.Tensor] = None,  # [T, R, n_pad] injected draws
    ) -> EngineResult | SweepResult:
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

        if beta_spin is None:
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

        phi = self.fields(m0)

        kernel_path = (self.blocked.colored
                       and self.within_block == "jacobi"
                       and self.block_order == "fixed"
                       and not record_m)
        if kernel_path:
            if self.device.type == "cuda" and self.n_pad > K1_MAX_N_PAD:
                raise NotImplementedError(
                    f"colored sweeps at n_pad={self.n_pad} > {K1_MAX_N_PAD} "
                    "need the streamed kernels K2/K3 "
                    "(pallas_colored_sweeps_streamed/_sparse), which are not "
                    "ported yet (ROADMAP queue 2)")
            cres = colored_sweeps(
                self.J_full, self.h, m0, phi, generator, beta_sweep, bs, mask,
                num_sweeps=num_sweeps, block_size=self.blocked.block_size,
                uniforms=uniforms)
            res = SweepResult(m=cres.m, phi=cres.phi, m_best=cres.m_best,
                              e_best=cres.e_best, energies=cres.energies,
                              M=None)
        else:
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
