"""Replica-sharded NPT: replica exchange with NMC phases across ranks.

The counterpart of ``nmc_tpu/parallel/sharded_pt.py``. The replica ladder
is split over the ranks of a `torch.distributed` group: each rank owns
R / W consecutive chain slots (states, bests and backbone masks stay on its
card), runs a whole swap round on them, and the ranks exchange only the R
carried energies (`distributed.gather_rows`); the temperature labels
(beta_to_slot, slot_to_beta) are replicated and every rank takes the same
swap decision. With `group=None` the whole ladder runs on one card and
nothing is sharded; `distributed.global_group()` shards it over every
rank.

A round, in order:
  1. every `lbp_every` rounds, the backbone masks of the rank's slots that
     hold an NMC label: convexified LBP (slot planes, edge messages or
     dense messages by `lbp_mode`) and `backbone_mask_device`; the NMC-slot
     set freezes with them between refreshes. Only NMC slots are solved,
     one slot at a time (a batch's reduction order may follow its size);
     the other slots' masks stay empty, as no phase reads them;
  2. the phases, by the route fixed at setup (`round_path`, the rule of
     `EnsembleNMC`): "K4" / "K5", one whole-round kernel launch of the
     rank's slots at I = 1 with their global replica offset; or "phases",
     the C / NC / ALL phase cycle through `SweepEngine.run` (K1 / K2 / K3
     on a coloured layout, `sequential_sweeps` for the default uncoloured
     sequential sweep), NMC slots restarting from the phase best;
  3. the carried states' energies, gathered, and one Metropolis label swap
     round (`parallel/swaps.py`) on every rank alike.
NMC replicas sample at `global_beta` (the reference's quirk, kept). On a
card no phase reaches the plain `run_sweeps`: a layout with no kernel
route there (uncoloured block-Jacobi) raises.

Sharding invariance: the same generator seed gives the same states, bests
and labels, bit for bit, at any world size. Every rank keeps one generator
in the same state as the others and draws the round's seeds and swap
draws for the whole ladder; the kernels add the slots' global replica
index to their Philox counters, and the plain twins on the CPU draw the
whole ladder's uniforms and keep their rows. The JAX engine instead folds
the device index into its key, so its draws follow the mesh. Products of
the round (fields, energies) run one row at a time when sharded
(`core.energy.by_rows`), and LBP one NMC slot at a time. `RoundDraws`
inject a round's draws for the whole ladder ([P, T, 1, R, n_pad]
uniforms, [1, num_pairs, R - 1] Gumbels, [1, num_pairs] swap uniforms);
each rank keeps its rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.energy import by_rows, energy, local_fields
from ..core.problem import IsingProblem, block_problem, block_sparse_tiles
from ..device import resolve_dtype
from ..ops.clusters import backbone_mask_device
from ..ops.engine import SweepEngine
from ..ops.lbp import lambda_ladder
from ..ops.lbp_jit import (convexified_marginal_dense,
                           convexified_marginal_sparse)
from ..ops.round_cuda import (ensemble_round, ensemble_round_sparse,
                              phase_list)
from ..utils.metrics import RoundSpans, host_sync
from . import distributed
from .swaps import metropolis_label_swap


@dataclasses.dataclass
class ShardedNPTConfig:
    sweeps_per_phase: int = 32
    num_cycles: int = 2
    full_update_frequency: int = 1
    num_swapping_pairs: int = 1
    global_beta: float = 2.5
    temp_x: float = 20.0
    threshold_initial: float = 0.999999
    threshold_cutoff: float = 0.99999
    threshold_step: float = 0.01
    lambda_start: float = 3.0
    lambda_end: float = 0.01
    lambda_reduction_factor: float = 0.5
    lbp_max_iterations: int = 30
    lbp_tolerance: float = 1e-7
    lbp_every: int = 1       # recompute backbone clusters every K rounds
    lbp_mode: str = "auto"   # 'dense' | 'sparse' | 'planes' (slotted edges,
                             # raises past the degree cap) | 'auto': planes
                             # when the degree cap holds; else EnsembleNMC
                             # takes edge messages below 5% density or with
                             # 'sparse', and ShardedNPT above 1024 spins
                             # (the JAX engines' rules), else dense
    block_size: int = 128
    within_block: str = "sequential"
    use_coloring: bool = False   # graph-colored blocks -> exact Jacobi updates
    dtype: str = "float32"
    round_kernel: str = "auto"   # whole-round kernels K4/K5: 'auto'
                                 # (colored f32 layouts), 'on' (raise when
                                 # none fits), 'off' (the phase route)


class ShardedPTState(NamedTuple):
    m: torch.Tensor             # [R_local, n_pad] the rank's chain states
    beta_to_slot: torch.Tensor  # [R] int64, the same on every rank
    slot_to_beta: torch.Tensor  # [R] int64
    generator: torch.Generator  # in the same state on every rank
    round_index: int
    m_best: torch.Tensor        # [R_local, n_pad] best-ever state per slot
    e_best: torch.Tensor        # [R_local] its energy
    cl: torch.Tensor            # [R_local, n_pad] carried backbone masks
    do_nmc_slot: torch.Tensor   # [R_local] slots running NMC phases


class RoundMetrics(NamedTuple):
    slot_energies: torch.Tensor  # [R] energy of each slot after the round
    accepted: torch.Tensor       # [num_swapping_pairs] bool
    pairs: torch.Tensor          # [num_swapping_pairs]


class ShardedNPT:
    """Replica-sharded parallel tempering with optional NMC phases."""

    def __init__(
        self,
        problem: IsingProblem,
        beta_list: Sequence[float],
        doNMC: Sequence[bool],
        cfg: ShardedNPTConfig = ShardedNPTConfig(),
        *,
        group=None,
        device=None,
    ):
        beta_list = np.asarray(beta_list, dtype=np.float64)
        self.R = R = beta_list.shape[0]
        self.doNMC = np.asarray(doNMC, dtype=bool)
        if self.doNMC.shape[0] != R:
            raise ValueError("doNMC length must match beta_list")
        self.any_nmc = bool(self.doNMC.any())
        self.group = group
        self.sharded = group is not None
        self.n_ranks, k = distributed.group_shape(group)
        if R % self.n_ranks:
            raise ValueError(f"num replicas {R} must divide over "
                             f"{self.n_ranks} ranks")
        self.R_local = R // self.n_ranks
        self.r0 = k * self.R_local
        self.device = dev = (distributed.rank_device() if device is None
                             else torch.device(device))
        self.dtype = dtype = resolve_dtype(cfg.dtype, dev)
        if cfg.round_kernel not in ("auto", "on", "off"):
            raise ValueError(f"round_kernel must be auto|on|off, "
                             f"got {cfg.round_kernel!r}")

        groups = None
        if cfg.use_coloring:
            from ..ops.coloring import color_groups
            groups = color_groups(problem.J)
        b = block_problem(problem, block_size=cfg.block_size, groups=groups,
                          dtype=np.dtype(str(dtype).split(".")[-1]))
        if b.colored:
            # colored layout makes the all-at-once block update exact Gibbs
            cfg = dataclasses.replace(cfg, within_block="jacobi")
        self.cfg = cfg
        self.blocked = b
        self.n_pad = n_pad = b.n_pad
        self.engine = SweepEngine.from_blocked_problem(
            b, problem, within_block=cfg.within_block, dtype=dtype,
            device=dev)
        eng = self.engine
        self.J_full, self.h, self.active = eng.J_full, eng.h, eng.active

        def put(x, dt=dtype):
            return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

        self.beta_list = put(beta_list)
        self.do_nmc_by_beta = put(self.doNMC, torch.bool)
        J_np = b.J_rows.reshape(n_pad, n_pad)
        self.epsilon = put(np.abs(b.h) + np.abs(J_np).sum(axis=1))
        self.ladder = tuple(lambda_ladder(cfg.lambda_start, cfg.lambda_end,
                                          cfg.lambda_reduction_factor))
        self._lbp_setup(b, J_np, put)

        from .ensemble_nmc import round_route
        path, self.round_nbrs, self._stream_tiles = round_route(
            [b], self.J_full[None], cfg.round_kernel, dtype, dev, put)
        self.round_path = "phases" if path == "plain" else path
        self._spans = RoundSpans("ShardedNPT", dev)
        if (self.round_path == "phases" and dev.type == "cuda"
                and eng.sweep_kernel is None):
            raise ValueError(
                "ShardedNPT on cuda: this layout has no sweep kernel (an "
                "uncoloured block-Jacobi sweep); use use_coloring=True or "
                "within_block='sequential'")

    def _lbp_setup(self, b, J_np, put):
        """The LBP couplings of the JAX engine's rule: slot planes when the
        degree cap holds (mode planes or auto), else edge messages (mode
        sparse, or auto above 1024 spins), else dense messages."""
        cfg = self.cfg
        self.edge_slots = self.edge_graph = self._lbp_w = None
        if not self.any_nmc:
            return
        if cfg.lbp_mode in ("planes", "auto"):
            from ..ops.lbp_planes import (build_edge_slot_planes,
                                          w_slot_from_tiles)
            col_idx, J_tiles = block_sparse_tiles(b)
            try:
                self.edge_slots = build_edge_slot_planes(col_idx,
                                                         J_tiles != 0)
                self._lbp_w = put(w_slot_from_tiles(self.edge_slots,
                                                    J_tiles))
            except ValueError:
                if cfg.lbp_mode == "planes":
                    raise
        if self.edge_slots is None and (
                cfg.lbp_mode == "sparse"
                or (cfg.lbp_mode == "auto" and self.n_pad > 1024)):
            from ..ops.lbp_sparse import EdgeGraph
            self.edge_graph = EdgeGraph.from_dense(J_np)
            self._lbp_w = put(self.edge_graph.weight)

    # ------------------------------------------------------------------
    def _rows(self, x):
        """The rank's rows of a whole-ladder tensor [R, ...]."""
        return x[self.r0:self.r0 + self.R_local]

    def init_state(self, generator: torch.Generator) -> ShardedPTState:
        """Random +-1 states: every rank draws the whole ladder's and keeps
        its rows."""
        u = torch.rand((self.R, self.n_pad), generator=generator,
                       dtype=self.dtype, device=self.device)
        m = torch.where(u < 0.5, -1.0, 1.0).to(self.dtype)
        m = self._rows(torch.where(self.active, m, 1.0).to(self.dtype))
        ids = torch.arange(self.R, device=self.device)
        Rl = self.R_local
        return ShardedPTState(
            m=m.clone(), beta_to_slot=ids, slot_to_beta=ids.clone(),
            generator=generator, round_index=0, m_best=m.clone(),
            e_best=torch.full((Rl,), float("inf"), dtype=self.dtype,
                              device=self.device),
            cl=torch.zeros((Rl, self.n_pad), dtype=torch.bool,
                           device=self.device),
            do_nmc_slot=self._rows(self.do_nmc_by_beta).clone())

    # ------------------------------------------------------------------
    def _lbp(self, m_star):
        """Belief logits [1, n_pad] of one slot's state [1, n_pad]."""
        cfg = self.cfg
        kw = dict(beta=cfg.global_beta, ladder=self.ladder,
                  max_iterations=cfg.lbp_max_iterations,
                  tolerance=cfg.lbp_tolerance)
        h, eps = self.h[None], self.epsilon[None]
        if self.edge_slots is not None:
            from ..ops.lbp_planes import convexified_marginal_planes
            return convexified_marginal_planes(self.edge_slots, self._lbp_w,
                                               h, eps, m_star, **kw)
        if self.edge_graph is not None:
            return convexified_marginal_sparse(self.edge_graph, self._lbp_w,
                                               h, eps, m_star, **kw)
        return convexified_marginal_dense(self.J_full, h, eps, m_star, **kw)

    def _clusters(self, m, slot_to_beta):
        """Backbone masks of the rank's slots holding NMC labels, one slot
        at a time; the other slots' masks are empty."""
        cfg = self.cfg
        do_nmc = self.do_nmc_by_beta[self._rows(slot_to_beta)]
        cl = torch.zeros_like(m, dtype=torch.bool)
        J_abs = torch.abs(self.J_full)
        for r in host_sync(torch.Tensor.tolist,
                           torch.nonzero(do_nmc).flatten()):
            cl[r] = backbone_mask_device(
                self._lbp(m[r:r + 1]), J_abs, cfg.threshold_initial,
                cfg.threshold_cutoff, cfg.threshold_step,
                active=self.active, logits=True)[0]
        return cl, do_nmc

    def _kernel_round(self, state, cl, do_nmc, base, uniforms):
        """One K4 / K5 launch over the rank's slots (I = 1)."""
        cfg = self.cfg
        kw = dict(num_cycles=cfg.num_cycles,
                  sweeps_per_phase=cfg.sweeps_per_phase,
                  full_update_frequency=cfg.full_update_frequency,
                  temp_x_inv=1.0 / cfg.temp_x, nbrs=self.round_nbrs,
                  uniforms=uniforms, replica_offset=self.r0,
                  replicas_total=self.R)
        args = (self.h[None], self.active, state.m[None], cl[None],
                do_nmc[None], base[None], state.generator)
        if self.round_path == "K5":
            res = ensemble_round_sparse(*self._stream_tiles, *args, **kw)
        else:
            res = ensemble_round(self.J_full[None], *args,
                                 block_size=self.blocked.block_size, **kw)
        imp = res.e_best[0] < state.e_best
        return (res.m[0], torch.where(imp[:, None], res.m_best[0],
                                      state.m_best),
                torch.where(imp, res.e_best[0], state.e_best),
                res.e_carried[0])

    def _base(self, slot_to_beta, do_nmc):
        """[R_local] the rank's slot betas, global_beta on NMC slots."""
        return torch.where(do_nmc, self.cfg.global_beta,
                           self.beta_list[self._rows(slot_to_beta)])

    def _phase_args(self, kind, cl, do_nmc, base):
        """(beta_spin, update_mask) of a C / NC / ALL phase: NMC slots run
        C heated by 1 / temp_x on their backbone and NC off it; the other
        slots run every phase whole at their slot beta."""
        dn, base_row = do_nmc[:, None], base[:, None]
        act = self.active.expand_as(cl)
        if kind == "C":
            heat = host_sync(torch.tensor, 1.0 / self.cfg.temp_x,
                             dtype=self.dtype, device=self.device)
            one = torch.ones((), dtype=self.dtype, device=self.device)
            return (base_row * torch.where(dn & cl, heat, one),
                    torch.where(dn, cl & act, act))
        if kind == "NC":
            return base_row, torch.where(dn, ~cl & act, act)
        return base_row, act

    def _phase_round(self, state, cl, do_nmc, base, uniforms):
        """The C / NC / ALL phase cycle through the engine's sweep route;
        NMC slots restart from each phase's best state."""
        cfg = self.cfg
        T = cfg.sweeps_per_phase
        ones_t = torch.ones((T,), dtype=self.dtype, device=self.device)
        dn = do_nmc[:, None]
        m, mb, eb = state.m, state.m_best, state.e_best
        for p, kind in enumerate(phase_list(cfg.num_cycles,
                                            cfg.full_update_frequency)):
            bs, mask = self._phase_args(kind, cl, do_nmc, base)
            res = self.engine.run(
                m, state.generator, T, ones_t, beta_spin=bs,
                update_mask=mask, blocked_input=True, blocked_output=True,
                phi=self._by_rows(local_fields, m),
                uniforms=None if uniforms is None else uniforms[p],
                replica_offset=self.r0, replicas_total=self.R)
            m = torch.where(dn, res.m_best, res.m)
            imp = res.e_best < eb
            eb = torch.where(imp, res.e_best, eb)
            mb = torch.where(imp[:, None], res.m_best, mb)
        # swap energies belong to the CARRIED states (recomputed: after an
        # m_best restart the last sweep's energy is stale)
        return m, mb, eb, self._by_rows(energy, m)

    def _by_rows(self, fn, m):
        """fn(J, h, m) of the rank's states, per row when sharded."""
        return by_rows(lambda x: fn(self.J_full, self.h, x), m,
                       sharded=self.sharded)

    # ------------------------------------------------------------------
    def round(self, state: ShardedPTState, draws=None,
              timings: Optional[Dict[str, Any]] = None):
        """One swap round; returns (state, RoundMetrics). `draws` (a
        `RoundDraws` for the whole ladder) may inject its draws. With a
        `timings` dict the round records sync-free stage spans
        (`utils.metrics.RoundSpans`): the device seconds of "lbp", "round"
        and "swaps" (the all-reduce of the carried energies inside it),
        with "rounds", "host_s", "host_syncs", "compute_ms_by_round" (this
        rank's device ms from the previous round's all-reduce to this
        one's) and, once a round has refreshed, "lbp_refreshes" and
        "lbp_iterations"; it lands in the dict once the card has passed it,
        at the latest at `best` or `flush`."""
        from .ensemble_nmc import RoundDraws
        cfg = self.cfg
        d = draws if draws is not None else RoundDraws()
        spans = self._spans
        with spans.round(timings):
            with spans.stage("lbp"):
                if not self.any_nmc:
                    cl = self.active.expand_as(state.m).clone()
                    do_nmc = state.do_nmc_slot
                elif state.round_index % cfg.lbp_every == 0:
                    cl, do_nmc = self._clusters(state.m, state.slot_to_beta)
                else:
                    cl, do_nmc = state.cl, state.do_nmc_slot
            with spans.stage("round"):
                base = self._base(state.slot_to_beta, do_nmc)
                u = d.sweep_uniforms
                r0, r1 = self.r0, self.r0 + self.R_local
                if self.round_path == "phases":
                    u = None if u is None else u[:, :, 0, r0:r1].contiguous()
                    m, mb, eb, e_car = self._phase_round(state, cl, do_nmc,
                                                         base, u)
                else:
                    u = None if u is None else u[:, :, :, r0:r1].contiguous()
                    m, mb, eb, e_car = self._kernel_round(state, cl, do_nmc,
                                                          base, u)
            with spans.stage("swaps"):
                spans.mark("collective_in")
                e_all = distributed.gather_rows(e_car, self.r0, self.R,
                                                self.group)
                spans.mark("collective_out")
                swap = metropolis_label_swap(
                    state.beta_to_slot[None], self.beta_list.to(torch.float32),
                    e_all[None].to(torch.float32),
                    num_pairs=cfg.num_swapping_pairs,
                    generator=state.generator, gumbels=d.gumbels,
                    uniforms=d.swap_uniforms)
        new = ShardedPTState(
            m=m, beta_to_slot=swap.beta_to_slot[0],
            slot_to_beta=swap.slot_to_beta[0], generator=state.generator,
            round_index=state.round_index + 1, m_best=mb, e_best=eb, cl=cl,
            do_nmc_slot=do_nmc)
        return new, RoundMetrics(slot_energies=e_all,
                                 accepted=swap.accepted[0],
                                 pairs=swap.pairs[0])

    def run(self, state: ShardedPTState, num_rounds: int, *,
            draws: Optional[Callable[[int], object]] = None):
        """`num_rounds` rounds; returns (state, the last RoundMetrics)."""
        metrics = None
        for _ in range(num_rounds):
            state, metrics = self.round(
                state, None if draws is None else draws(state.round_index))
        return state, metrics

    def run_scanned(self, state: ShardedPTState, num_rounds: int, *,
                    draws: Optional[Callable[[int], object]] = None,
                    timings: Optional[Dict[str, Any]] = None):
        """`num_rounds` rounds; returns (state, RoundMetrics stacked over
        the rounds). JAX fuses them into one lax.scan dispatch; here they
        are a loop that syncs the host only in the LBP refreshes and the
        `host_sync` calls. `timings` as in `round`."""
        out = []
        for _ in range(num_rounds):
            state, met = self.round(
                state, None if draws is None else draws(state.round_index),
                timings=timings)
            out.append(met)
        return state, RoundMetrics(*(torch.stack(x) for x in zip(*out)))

    # ------------------------------------------------------------------
    def _gather(self, x):
        return distributed.gather_rows(x, self.r0, self.R, self.group)

    def best(self, state: ShardedPTState):
        """(best-ever energy, best state in ORIGINAL spin order), numpy, on
        every rank (gathered)."""
        eb = self._gather(state.e_best).cpu().numpy()
        i = int(eb.argmin())
        m = self._gather(state.m_best)[i].cpu().numpy()
        self._spans.collect()
        return float(eb[i]), m[np.asarray(self.blocked.inv_perm)]

    def flush(self) -> None:
        """Sum every round recorded with a `timings` dict into it, waiting
        for the card to pass them (`best` does so without waiting)."""
        self._spans.flush()

    def states_by_temperature(self, state: ShardedPTState) -> np.ndarray:
        """States ordered by temperature index [R, n], numpy (gathered)."""
        m = self._gather(state.m)[state.beta_to_slot].cpu().numpy()
        return m[:, np.asarray(self.blocked.inv_perm)]

    def save(self, state: ShardedPTState, path: str) -> None:
        """Snapshot the run (npz): the ranks' rows gathered, written by rank
        0, with the generator's state; every rank returns after the file
        is written."""
        from ..utils.checkpoint import save_checkpoint
        snap = {f: self._gather(getattr(state, f)).cpu().numpy()
                for f in ("m", "m_best", "e_best", "cl", "do_nmc_slot")}
        if distributed.group_shape(self.group)[1] == 0:
            save_checkpoint(path, ShardedPTState(
                beta_to_slot=state.beta_to_slot.cpu().numpy(),
                slot_to_beta=state.slot_to_beta.cpu().numpy(),
                generator=state.generator.get_state().numpy(),
                round_index=int(state.round_index), **snap),
                step=int(state.round_index))
        distributed.sum_(torch.zeros(1, device=self.device), self.group)

    def restore(self, path: str) -> ShardedPTState:
        """A snapshot of `save`, each rank keeping its rows; the generator
        is a new one on this rank's device in the saved state."""
        from ..utils.checkpoint import load_checkpoint
        snap, _, _ = load_checkpoint(path)
        gen = torch.Generator(device=self.device)
        gen.set_state(torch.as_tensor(snap["generator"]))

        def rows(f, dt):
            return self._rows(torch.as_tensor(snap[f], dtype=dt,
                                              device=self.device)).clone()

        return ShardedPTState(
            m=rows("m", self.dtype),
            beta_to_slot=torch.as_tensor(snap["beta_to_slot"],
                                         device=self.device),
            slot_to_beta=torch.as_tensor(snap["slot_to_beta"],
                                         device=self.device),
            generator=gen, round_index=int(snap["round_index"]),
            m_best=rows("m_best", self.dtype),
            e_best=rows("e_best", self.dtype), cl=rows("cl", torch.bool),
            do_nmc_slot=rows("do_nmc_slot", torch.bool))
