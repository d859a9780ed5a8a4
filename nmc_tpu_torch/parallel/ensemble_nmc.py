"""Instance-ensemble NMC-PT: many instances x a replica ladder x full NPT
swap rounds on one card (torch).

The counterpart of ``nmc_tpu/parallel/ensemble_nmc.py``, the campaign
engine. A family of instances that share a topology (chimera, DCL and
wishart folders) runs as one ensemble with a leading instance axis: per
round, every instance's replica slots run the NMC / PT phase cycle, the
NMC slots' backbone masks are refreshed by convexified LBP every
`lbp_every` rounds, and replicas exchange temperature LABELS (states never
move, `parallel/swaps.py`). The campaign checks per-instance ground-state
targets between chunks of rounds.

The family is padded to its largest spin count, coloured on the UNION of
its coupling graphs (valid for every member), and blocked with that
colouring; per-instance J rows, h, the convexification epsilon and the LBP
couplings (slot planes, edge list or dense) sit on the device.

Two round bodies, the route fixed at setup (`round_path`):
  * "K4" / "K5": one whole-round kernel launch over all instances
    (`ops/round_cuda.py`), then the fold of per-slot round bests into the
    per-instance best, then batched label swaps. Both kernels read the
    couplings through the union graph's neighbour layout (`round_nbrs`),
    built here once and passed to every launch, so any colored float32
    layout inside that layout's own limits (`round_kernel_limit`: n_pad
    <= 32768 for its int16 indices, one replica's state in a CTA's
    shared memory) takes one: K4 (dense J) up to n_pad 1536, the same
    limit as K1 in `SweepEngine`; above it K5 (the union block-sparse
    tiles, whose count K per row block is below nB on a colored layout:
    its diagonal tiles are zero);
  * "plain": the JAX engine's XLA round, one instance after another, each
    phase one sweep call of the instance's engine. It serves
    `round_kernel="off"` and uncoloured (wishart) or float64 layouts.
On a CUDA device `round_kernel="auto"` with a coloured float32 layout takes
K4/K5 or raises, naming the limit it passes; `"on"` raises whenever no
kernel fits. On CPU tensors the kernel wrappers run their plain torch
versions.

The two routes heat the backbone differently, each as its JAX counterpart
does: the kernels by beta_row * (1 + f32(temp_x_inv - 1)), the plain round
by base_row * f32(1 / temp_x).

`run_scanned` runs rounds with no host sync except the LBP convergence
tests of refresh rounds and the `utils.metrics.host_sync` calls; `best`
is the one sync per chunk. Randomness comes
from the state's `torch.Generator`; `RoundDraws` inject a round's draws so
tests can replay the JAX engine's keys.

With a `group=` (a `torch.distributed` process group) the instances are
sharded over its ranks, rank k holding instances [k I / W, (k + 1) I / W)
(the largest rank count dividing I; the ranks past it hold none). The
union colouring, tiles and LBP topology are the whole family's, so every
rank runs the layout a single card would. Each rank draws a round's
randomness for all I instances and keeps its rows: K4/K5 take the slice's
instance offset into their Philox counters; the plain route's phases
take, on a card, seed words from one [I, P, 2] draw per round, and on the
CPU the uniforms drawn instance after instance as the unsharded round
draws them, other ranks' instances drawn and dropped (`InstanceDraws`);
the label swaps' Gumbels and uniforms are drawn for all I. A
sharded round solves LBP per instance (`core.energy.by_rows`: a batch's
reduction order may follow its size), so the same seed gives the same
trajectory at every world size. There is no communication inside a
round; `best` gathers. Without a group the instance count is never cut.

On a card the plain route's phases run the sweep kernels through one
`SweepEngine` per instance (K1 / K2 / K3 on a coloured layout,
`sequential_sweeps` for the uncoloured sequential sweep); on the CPU the
same engines run their plain twins, which are `run_sweeps`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.energy import by_rows
from ..core.problem import IsingProblem, block_problem
from ..device import resolve_device, resolve_dtype
from ..ops.clusters import backbone_mask_device
from ..ops.engine import K1_MAX_N_PAD, SweepEngine
from ..ops.lbp import lambda_ladder
from ..ops.lbp_jit import (convexified_marginal_dense,
                           convexified_marginal_sparse)
from ..ops.round_cuda import (ensemble_round, ensemble_round_sparse,
                              neighbors_from_dense, neighbors_from_tiles,
                              phase_list, round_kernel_limit)
from ..ops.sweeps_cuda import draw_seeds
from ..utils.metrics import RoundSpans, host_sync
from . import distributed
from .sharded_pt import ShardedNPTConfig
from .swaps import metropolis_label_swap, swap_draws


class EnsembleNMCState(NamedTuple):
    m: torch.Tensor             # [I, R, n_pad]
    beta_to_slot: torch.Tensor  # [I, R] int64
    slot_to_beta: torch.Tensor  # [I, R] int64
    generator: torch.Generator  # every draw of the rounds (JAX: the key)
    round_index: int            # host-known, so the LBP cadence is a branch
    m_best: torch.Tensor        # [I, n_pad] best-ever state per instance
    e_best: torch.Tensor        # [I] best-ever energy per instance
    cl: torch.Tensor            # [I, R, n_pad] carried backbone masks
    do_nmc_slot: torch.Tensor   # [I, R] slots running NMC phases (frozen
                                # between cluster refreshes)


class RoundDraws(NamedTuple):
    """One round's injected draws; None draws from the state's generator."""
    sweep_uniforms: Optional[torch.Tensor] = None  # [P, T, I, R, n_pad]
    gumbels: Optional[torch.Tensor] = None         # [I, num_pairs, R - 1]
    swap_uniforms: Optional[torch.Tensor] = None   # [I, num_pairs]


class EnsembleNMC:
    """Batched-instance NPT with NMC phases on one device."""

    def __init__(
        self,
        problems: Sequence[IsingProblem],
        beta_list: Sequence[float],
        doNMC: Sequence[bool],
        cfg: ShardedNPTConfig = ShardedNPTConfig(),
        *,
        device=None,
        group=None,
    ):
        if len({p.n for p in problems}) != 1:
            # families like DCL ship instances whose max spin index varies:
            # pad to the family max with free spins (zero couplings and h)
            n_max = max(p.n for p in problems)
            problems = [p if p.n == n_max else _pad_problem(p, n_max)
                        for p in problems]
        self.device = dev = resolve_device(device)
        self.dtype = dtype = resolve_dtype(cfg.dtype, dev)
        np_dtype = np.dtype(str(dtype).split(".")[-1])
        self.group = group
        self.I_total = len(problems)
        self.i0, self.I = distributed.instance_shard(self.I_total, group)
        lo, hi = self.i0, self.i0 + self.I
        beta_list = np.asarray(beta_list, dtype=np.float64)
        self.R = beta_list.shape[0]
        self.doNMC = np.asarray(doNMC, dtype=bool)
        self.any_nmc = bool(self.doNMC.any())

        groups = None
        if cfg.use_coloring:
            from ..ops.coloring import color_groups
            # colour the UNION graph: valid for every member of the family
            J_union = np.zeros_like(np.asarray(problems[0].J))
            for p in problems:
                J_union += np.abs(np.asarray(p.J))
            groups = color_groups(J_union)
        all_blocked = [block_problem(p, block_size=cfg.block_size,
                                     groups=groups, dtype=np_dtype)
                       for p in problems]
        blocked = all_blocked[lo:hi]      # this rank's instances
        if all_blocked[0].colored:
            cfg = dataclasses.replace(cfg, within_block="jacobi")
        if cfg.round_kernel not in ("auto", "on", "off"):
            raise ValueError(f"round_kernel must be auto|on|off, "
                             f"got {cfg.round_kernel!r}")
        self.cfg = cfg
        self.blocked0 = all_blocked[0]
        self.n_pad = n_pad = all_blocked[0].n_pad

        def put(x, dt=dtype):
            return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

        def stack(xs, shape):
            return put(np.stack(xs) if xs else np.zeros((0,) + shape))

        self.J_rows = stack([b.J_rows for b in blocked],
                            self.blocked0.J_rows.shape)
        self.J_diag = stack([b.J_diag for b in blocked],
                            self.blocked0.J_diag.shape)
        self.J_full = self.J_rows.reshape(self.I, n_pad, n_pad)
        self.h = stack([b.h for b in blocked], (n_pad,))
        self.epsilon = stack(
            [np.abs(b.h) + np.abs(b.J_rows.reshape(n_pad, n_pad)).sum(1)
             for b in blocked], (n_pad,))
        self.active = put(self.blocked0.active, torch.bool)
        self._inv_perm = torch.as_tensor(self.blocked0.inv_perm,
                                         dtype=torch.int64, device=dev)
        self.beta_list = put(beta_list)
        self.do_nmc_by_beta = put(self.doNMC, torch.bool)
        self.ladder = tuple(lambda_ladder(cfg.lambda_start, cfg.lambda_end,
                                          cfg.lambda_reduction_factor))

        # LBP over the UNION topology with per-instance couplings: slotted
        # edges on bounded-degree families ('planes', the 'auto' default),
        # else edge messages (sparse) or dense messages
        self.edge_slots = self.edge_graph = self.edge_w = None
        union = None
        if (self.any_nmc and cfg.lbp_mode in ("planes", "auto")) or (
                group is not None and n_pad > K1_MAX_N_PAD):
            union = _union_tiles(all_blocked)
        if self.any_nmc and cfg.lbp_mode in ("planes", "auto"):
            from ..ops.lbp_planes import (build_edge_slot_planes,
                                          w_slot_from_tiles)
            col_idx_u, J_tiles_u = union
            try:
                esp = build_edge_slot_planes(
                    col_idx_u, np.any(J_tiles_u != 0, axis=0))
            except ValueError:
                if cfg.lbp_mode == "planes":
                    raise
                esp = None
            if esp is not None:
                self.edge_slots = esp
                self.edge_w = stack(
                    [w_slot_from_tiles(esp, J_tiles_u[i])
                     for i in range(lo, hi)], (n_pad, esp.degree))
        if (self.any_nmc and self.edge_slots is None
                and cfg.lbp_mode != "dense"):
            from ..ops.lbp_sparse import EdgeGraph
            J_sq = [b.J_rows.reshape(n_pad, n_pad) for b in all_blocked]
            J_un = np.zeros((n_pad, n_pad))
            for Ji in J_sq:
                J_un += np.abs(Ji)
            if cfg.lbp_mode == "sparse" or (J_un != 0).mean() < 0.05:
                g = EdgeGraph.from_dense(J_un)
                self.edge_graph = g
                si, di = np.asarray(g.src), np.asarray(g.dst)
                self.edge_w = stack([Ji[si, di] for Ji in J_sq[lo:hi]],
                                    (si.shape[0],))

        if union is not None:
            union = (union[0], union[1][lo:hi])
        self.round_path, self.round_nbrs, self._stream_tiles = (
            round_route(all_blocked, self.J_full, cfg.round_kernel, dtype,
                        dev, put, union) if self.I else ("idle", None, None))
        # the plain route's phases: one sweep engine per instance
        self._engines = []
        if self.round_path == "plain":
            self._engines = [SweepEngine.from_blocked_problem(
                b, problems[lo + i], within_block=cfg.within_block,
                dtype=dtype, device=dev) for i, b in enumerate(blocked)]
        self._on_kernels = all(e.sweep_kernel is not None
                               for e in self._engines)
        self._spans = RoundSpans("EnsembleNMC", dev)
        if group is not None and dev.type == "cuda" and not self._on_kernels:
            raise ValueError(
                "a sharded EnsembleNMC on cuda runs its phases on the sweep "
                "kernels; this layout has none (an uncoloured block-Jacobi "
                "sweep)")

    # ------------------------------------------------------------------
    def init_state(self, generator: torch.Generator,
                   m0=None) -> EnsembleNMCState:
        """Random +-1 start. `m0` (optional, [I, C, n] ORIGINAL spin order,
        ascending energy) seeds the C coldest chains."""
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
        return EnsembleNMCState(
            m=m, beta_to_slot=ids.clone(), slot_to_beta=ids.clone(),
            generator=generator, round_index=0,
            m_best=torch.ones((I, n_pad), dtype=self.dtype,
                              device=self.device),
            e_best=torch.full((I,), float("inf"), dtype=self.dtype,
                              device=self.device),
            cl=torch.zeros((I, R, n_pad), dtype=torch.bool,
                           device=self.device),
            do_nmc_slot=self.do_nmc_by_beta.expand(I, R).clone())

    # ------------------------------------------------------------------
    def _extract_clusters(self, m, slot_to_beta, ids):
        """Backbone masks for the slots holding NMC labels of the local
        instances `ids` (consecutive, on the host; those of `m`) at once:
        LBP for those I * k states only, masks scattered back by slot."""
        cfg = self.cfg
        I, R, n = m.shape
        first = int(ids[0])
        do_nmc = self.do_nmc_by_beta[slot_to_beta]                # [I, R]
        k = int(self.doNMC.sum())
        nmc_slots = torch.argsort(do_nmc.to(torch.int8), dim=1,
                                  stable=True)[:, R - k:]         # [I, k]
        idx = nmc_slots[..., None].expand(I, k, n)
        m_star = torch.gather(m, 1, idx).reshape(I * k, n)
        inst = first + torch.arange(I, device=self.device).repeat_interleave(k)
        lbp = dict(beta=cfg.global_beta, ladder=self.ladder,
                   max_iterations=cfg.lbp_max_iterations,
                   tolerance=cfg.lbp_tolerance)
        h, eps = self.h[inst], self.epsilon[inst]
        if self.edge_slots is not None:
            from ..ops.lbp_planes import convexified_marginal_planes
            marg = convexified_marginal_planes(
                self.edge_slots, self.edge_w[inst], h, eps, m_star, **lbp)
        elif self.edge_graph is not None:
            marg = convexified_marginal_sparse(
                self.edge_graph, self.edge_w[inst], h, eps, m_star, **lbp)
        else:
            marg = convexified_marginal_dense(
                self.J_full[inst], h, eps, m_star, **lbp)
        cl_k = backbone_mask_device(
            marg.reshape(I, k, n), torch.abs(self.J_full[first:first + I]),
            cfg.threshold_initial, cfg.threshold_cutoff, cfg.threshold_step,
            active=self.active, logits=True)
        cl = torch.zeros((I, R, n), dtype=torch.bool, device=self.device)
        cl.scatter_(1, idx, cl_k)
        return cl & self.active, do_nmc

    def _refresh(self, state: EnsembleNMCState):
        if self.any_nmc and state.round_index % self.cfg.lbp_every == 0:
            return by_rows(self._extract_clusters, state.m,
                           state.slot_to_beta, torch.arange(self.I),
                           sharded=self.group is not None)
        return state.cl, state.do_nmc_slot

    # ------------------------------------------------------------------
    def _kernel_round(self, state, cl, do_nmc, uniforms):
        """One K4/K5 launch over all instances; returns the carried states
        and energies and the per-slot round bests."""
        cfg = self.cfg
        base = torch.where(do_nmc, cfg.global_beta,
                           self.beta_list[state.slot_to_beta]).to(self.dtype)
        kw = dict(num_cycles=cfg.num_cycles,
                  sweeps_per_phase=cfg.sweeps_per_phase,
                  full_update_frequency=cfg.full_update_frequency,
                  temp_x_inv=1.0 / cfg.temp_x, uniforms=uniforms,
                  nbrs=self.round_nbrs, instance_offset=self.i0,
                  instances_total=self.I_total)
        if self.round_path == "K5":
            col_idx, J_tiles = self._stream_tiles
            return ensemble_round_sparse(
                col_idx, J_tiles, self.h, self.active, state.m, cl, do_nmc,
                base, state.generator, **kw)
        return ensemble_round(
            self.J_full, self.h, self.active, state.m, cl, do_nmc, base,
            state.generator, block_size=self.blocked0.block_size, **kw)

    def _fold(self, state, res):
        """(carried states, carried energies, bests) after a kernel round:
        the per-slot round bests folded into the per-instance best."""
        r = torch.argmin(res.e_best, dim=1, keepdim=True)            # [I, 1]
        e_r = torch.gather(res.e_best, 1, r)[:, 0]
        m_r = torch.gather(
            res.m_best, 1, r[..., None].expand(-1, 1, self.n_pad))[:, 0]
        imp = e_r < state.e_best
        return (res.m, res.e_carried,
                torch.where(imp[:, None], m_r, state.m_best),
                torch.where(imp, e_r, state.e_best))

    def _plain_round(self, state, cl, do_nmc, uniforms):
        """The JAX engine's XLA round, instance by instance: per phase a
        fresh phi and one sweep call of the instance's engine; returns
        (carried states, carried energies, per-instance bests)."""
        cfg = self.cfg
        R, n = self.R, self.n_pad
        T = cfg.sweeps_per_phase
        dt, dev = self.dtype, self.device
        heat = host_sync(torch.tensor, 1.0 / cfg.temp_x, dtype=dt, device=dev)
        one = torch.ones((), dtype=dt, device=dev)
        ones_t = torch.ones((T,), dtype=dt, device=dev)
        act = self.active.expand(R, n)
        phases = phase_list(cfg.num_cycles, cfg.full_update_frequency)
        draws = InstanceDraws(self, state.generator, len(phases), T, R,
                              uniforms, self._on_kernels)
        outs = []
        for i in range(self.I):
            dn = do_nmc[i][:, None]
            cli = cl[i]
            base_row = torch.where(
                do_nmc[i], host_sync(torch.tensor, cfg.global_beta, dtype=dt,
                                     device=dev),
                self.beta_list[state.slot_to_beta[i]])[:, None]
            m, mb, eb = state.m[i], state.m_best[i], state.e_best[i]
            h, J = self.h[i], self.J_full[i]
            for p, kind in enumerate(phases):
                if kind == "C":
                    bs = base_row * torch.where(dn & cli, heat, one)
                    mask = torch.where(dn, cli & act, act)
                elif kind == "NC":
                    bs, mask = base_row, torch.where(dn, ~cli & act, act)
                else:
                    bs, mask = base_row, act
                res = self._engines[i].run(
                    m, draws.generator, T, ones_t, beta_spin=bs,
                    update_mask=mask, blocked_input=True,
                    blocked_output=True, phi=m @ J + h, **draws.kw(i, p))
                m = torch.where(dn, res.m_best, res.m)
                r = torch.argmin(res.e_best)
                imp = res.e_best[r] < eb
                mb = torch.where(imp, res.m_best[r], mb)
                eb = torch.where(imp, res.e_best[r], eb)
            e_car = -(0.5 * torch.sum(m * (m @ J), dim=-1)
                      + torch.sum(m * h, dim=-1))
            outs.append((m, e_car, mb, eb))
        draws.finish()
        m, e_car, mb, eb = (torch.stack(x) for x in zip(*outs))
        return m, e_car, mb, eb

    # ------------------------------------------------------------------
    def run_scanned(
        self,
        state: EnsembleNMCState,
        num_rounds: int,
        *,
        draws: Optional[Callable[[int], RoundDraws]] = None,
        timings: Optional[Dict[str, Any]] = None,
    ) -> EnsembleNMCState:
        """`num_rounds` full ensemble rounds. `draws(round_index)` may
        inject a round's draws. With a `timings` dict each round records
        sync-free stage spans (`utils.metrics.RoundSpans`): the device
        seconds of "lbp" (backbone refresh), "round" (the sweep phases: one
        kernel launch, or the plain round) and "swaps" (best fold and label
        swaps), with "rounds", "host_s", "host_syncs" and, once a round
        has refreshed, "lbp_refreshes" and "lbp_iterations"; a round lands
        in the dict once the card has passed it, at the latest at `best` or
        `flush`. Nothing syncs the host but the LBP convergence tests and
        the `host_sync` calls."""
        cfg = self.cfg
        beta32 = self.beta_list.to(torch.float32)
        lo, hi = self.i0, self.i0 + self.I
        if self.I == 0:      # a rank past the instance shards holds none
            return state._replace(round_index=state.round_index + num_rounds)
        spans = self._spans
        for _ in range(num_rounds):
            d = draws(state.round_index) if draws is not None else RoundDraws()
            with spans.round(timings):
                with spans.stage("lbp"):
                    cl, do_nmc = self._refresh(state)
                with spans.stage("round"):
                    if self.round_path == "plain":
                        m, e_car, mb, eb = self._plain_round(
                            state, cl, do_nmc, d.sweep_uniforms)
                    else:
                        res = self._kernel_round(
                            state, cl, do_nmc, None if d.sweep_uniforms is None
                            else d.sweep_uniforms[:, :, lo:hi].contiguous())
                with spans.stage("swaps"):
                    if self.round_path != "plain":
                        m, e_car, mb, eb = self._fold(state, res)
                    if d.gumbels is None:
                        g, su = swap_draws(state.generator, self.I_total,
                                           cfg.num_swapping_pairs, self.R, lo,
                                           self.I)
                    else:
                        g, su = d.gumbels[lo:hi], d.swap_uniforms[lo:hi]
                    swap = metropolis_label_swap(
                        state.beta_to_slot, beta32, e_car.to(torch.float32),
                        num_pairs=cfg.num_swapping_pairs, gumbels=g,
                        uniforms=su)
            state = EnsembleNMCState(
                m=m, beta_to_slot=swap.beta_to_slot,
                slot_to_beta=swap.slot_to_beta, generator=state.generator,
                round_index=state.round_index + 1, m_best=mb, e_best=eb,
                cl=cl, do_nmc_slot=do_nmc)
        return state

    def flush(self) -> None:
        """Sum every round recorded with a `timings` dict into it, waiting
        for the card to pass them (`best` does so without waiting)."""
        self._spans.flush()

    def best(self, state: EnsembleNMCState):
        """([I] best energies, [I, n] best states in original order), numpy,
        every instance (gathered over the group); the one host sync of a
        chunk."""
        out = (distributed.host_gather(state.e_best, self.group),
               distributed.host_gather(state.m_best[:, self._inv_perm],
                                       self.group))
        self._spans.collect()
        return out


class InstanceDraws:
    """A round's sweep randomness for an ensemble's local instances (its
    `i0`, `I`, `I_total`), drawn as the unsharded round draws it for all
    I_total instances: injected uniforms [P, T, I_total, rows, n_pad] (the
    local instances' rows taken); on a card where every sweep call
    launches a kernel (`kernels`), seed words, one [I_total, P, 2] draw a
    round; else each sweep call draws its uniforms from the generator,
    instance after instance and phase after phase, and the draws of the
    instances other ranks hold are made and dropped before (`__init__`)
    and after (`finish`) the local ones."""

    def __init__(self, ens, generator, num_phases, sweeps, rows, uniforms,
                 kernels):
        self.lo, self.hi = ens.i0, ens.i0 + ens.I
        self.seeds = self.uniforms = None
        self.generator = generator
        self._skip = None
        if uniforms is not None:
            self.uniforms = uniforms[:, :, self.lo:self.hi]
            self.generator = None
        elif ens.device.type == "cuda" and kernels:
            self.seeds = draw_seeds(generator, (ens.I_total, num_phases))[
                self.lo:self.hi]
            self.generator = None
        else:
            self._skip = (num_phases * sweeps, (rows, ens.n_pad), ens.dtype,
                          ens.device, ens.I_total - self.hi)
            self._drop(self.lo)

    def _drop(self, instances):
        per, shape, dtype, device, _ = self._skip
        for _ in range(instances * per):
            torch.rand(shape, generator=self.generator, dtype=dtype,
                       device=device)

    def kw(self, i, p):
        """The sweep call's randomness for local instance i, phase p."""
        return dict(
            uniforms=(None if self.uniforms is None
                      else self.uniforms[p, :, i].contiguous()),
            seed=None if self.seeds is None else self.seeds[i, p])

    def batched_kw(self, p):
        """A batched sweep call's randomness for the local instances, phase
        p: uniforms [T, I, rows, n_pad] or seed words [I, 2] (or neither:
        the generator)."""
        return dict(
            uniforms=(None if self.uniforms is None
                      else self.uniforms[p].contiguous()),
            seeds=None if self.seeds is None else self.seeds[:, p].contiguous())

    def finish(self):
        if self._skip is not None:
            self._drop(self._skip[-1])


def round_route(blocked, J_full, round_kernel, dtype, device, put,
                union=None):
    """(round_path, round_nbrs, stream_tiles), fixed at setup. Both kernels
    run one body over a neighbour layout, so any colored f32 layout inside
    that body's own limits (`round_kernel_limit`) takes one: K4 over dense
    J [I, n_pad, n_pad] up to n_pad 1536, K5 over the union tiles above it;
    else "plain". On CUDA `round_kernel="auto"` with a colored f32 layout,
    and "on" anywhere, raise when no kernel fits."""
    n_pad = blocked[0].n_pad
    fails = []
    if not blocked[0].colored:
        fails.append("use_coloring=True (colored Jacobi layout)")
    if dtype != torch.float32:
        fails.append(f"dtype must be float32, got {dtype}")
    limit = round_kernel_limit(n_pad, blocked[0].block_size)
    if limit:
        fails.append(limit)
    path, nbrs, tiles = "plain", None, None
    if round_kernel != "off" and not fails:
        if n_pad <= K1_MAX_N_PAD:
            path = "K4"
            nbrs = neighbors_from_dense(J_full, blocked[0].block_size)
        else:
            col_idx, J_tiles = union or _union_tiles(blocked)
            # each row block is one colour class, so its diagonal tile is
            # zero in every instance and some column tile is empty
            K, nB = col_idx.shape[1], blocked[0].num_blocks
            assert K <= max(nB - 1, 1), (K, nB)
            path = "K5"
            tiles = (put(col_idx, torch.int32), put(J_tiles))
            nbrs = neighbors_from_tiles(*tiles)
        # the kernels hold dm over the layout's widest step
        limit = round_kernel_limit(n_pad, nbrs.step_spins)
        if limit:
            fails.append(limit)
            path, nbrs, tiles = "plain", None, None
    if path == "plain" and (
            round_kernel == "on"
            or (round_kernel == "auto" and device.type == "cuda"
                and blocked[0].colored and dtype == torch.float32)):
        raise ValueError(
            f"round_kernel={round_kernel!r} on {device.type}: no round "
            "kernel fits: " + "; ".join(fails))
    return path, nbrs, tiles


def _union_tiles(blocked):
    """Block-sparse tiles over the UNION sparsity pattern of a family: one
    [nB, K] column-tile index table valid for every instance (tiles an
    instance lacks are zero there) and per-instance [nB, K, B, B] tiles.
    Mirrors core.problem.block_sparse_tiles for a single instance."""
    nB, B = blocked[0].num_blocks, blocked[0].block_size
    nz_sets = [set() for _ in range(nB)]
    for bl in blocked:
        for b in range(nB):
            tiles = bl.J_rows[b].reshape(B, nB, B)
            nz = np.flatnonzero(np.any(tiles != 0, axis=(0, 2)))
            nz_sets[b].update(nz.tolist())
    K = max((len(s) for s in nz_sets), default=1) or 1
    col_idx = np.zeros((nB, K), np.int32)
    J_tiles = np.zeros((len(blocked), nB, K, B, B),
                       blocked[0].J_rows.dtype)
    for b, sset in enumerate(nz_sets):
        for k, j in enumerate(sorted(sset)):
            col_idx[b, k] = j
            for i, bl in enumerate(blocked):
                J_tiles[i, b, k] = bl.J_rows[b][:, j * B:(j + 1) * B]
    return col_idx, J_tiles


def _pad_problem(p: IsingProblem, n: int) -> IsingProblem:
    J = np.zeros((n, n))
    J[:p.n, :p.n] = np.asarray(p.J)
    h = np.zeros(n)
    h[:p.n] = np.asarray(p.h).reshape(-1)
    return IsingProblem(J, h, name=p.name)
