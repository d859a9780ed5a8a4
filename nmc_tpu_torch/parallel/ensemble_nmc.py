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
    phase a call of `ops/sweeps.run_sweeps`. It serves `round_kernel="off"`
    and uncoloured (wishart) or float64 layouts.
On a CUDA device `round_kernel="auto"` with a coloured float32 layout takes
K4/K5 or raises, naming the limit it passes; `"on"` raises whenever no
kernel fits. On CPU tensors the kernel wrappers run their plain torch
versions.

The two routes heat the backbone differently, each as its JAX counterpart
does: the kernels by beta_row * (1 + f32(temp_x_inv - 1)), the plain round
by base_row * f32(1 / temp_x).

`run_scanned` runs rounds with no host sync except the LBP convergence
tests of refresh rounds; `best` is the one sync per chunk. Randomness comes
from the state's `torch.Generator`; `RoundDraws` inject a round's draws so
tests can replay the JAX engine's keys.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.problem import IsingProblem, block_problem
from ..device import resolve_device, resolve_dtype
from ..ops.clusters import backbone_mask_device
from ..ops.engine import K1_MAX_N_PAD
from ..ops.lbp import lambda_ladder
from ..ops.lbp_jit import (convexified_marginal_dense,
                           convexified_marginal_sparse)
from ..ops.round_cuda import (ensemble_round, ensemble_round_sparse,
                              neighbors_from_dense, neighbors_from_tiles,
                              phase_list, round_kernel_limit)
from ..ops.sweeps import run_sweeps
from .sharded_pt import ShardedNPTConfig
from .swaps import metropolis_label_swap


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
        self.I = len(problems)
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
        blocked = [block_problem(p, block_size=cfg.block_size, groups=groups,
                                 dtype=np_dtype) for p in problems]
        if blocked[0].colored:
            cfg = dataclasses.replace(cfg, within_block="jacobi")
        if cfg.round_kernel not in ("auto", "on", "off"):
            raise ValueError(f"round_kernel must be auto|on|off, "
                             f"got {cfg.round_kernel!r}")
        self.cfg = cfg
        self.blocked0 = blocked[0]
        self.n_pad = n_pad = blocked[0].n_pad

        def put(x, dt=dtype):
            return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

        self.J_rows = put(np.stack([b.J_rows for b in blocked]))
        self.J_diag = put(np.stack([b.J_diag for b in blocked]))
        self.J_full = self.J_rows.reshape(self.I, n_pad, n_pad)
        self.h = put(np.stack([b.h for b in blocked]))
        self.epsilon = put(np.stack(
            [np.abs(b.h) + np.abs(b.J_rows.reshape(n_pad, n_pad)).sum(1)
             for b in blocked]))
        self.active = put(blocked[0].active, torch.bool)
        self._inv_perm = torch.as_tensor(blocked[0].inv_perm,
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
        if self.any_nmc and cfg.lbp_mode in ("planes", "auto"):
            from ..ops.lbp_planes import (build_edge_slot_planes,
                                          w_slot_from_tiles)
            union = _union_tiles(blocked)
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
                self.edge_w = put(np.stack(
                    [w_slot_from_tiles(esp, J_tiles_u[i])
                     for i in range(self.I)]))
        if (self.any_nmc and self.edge_slots is None
                and cfg.lbp_mode != "dense"):
            from ..ops.lbp_sparse import EdgeGraph
            J_sq = [b.J_rows.reshape(n_pad, n_pad) for b in blocked]
            J_un = np.zeros((n_pad, n_pad))
            for Ji in J_sq:
                J_un += np.abs(Ji)
            if cfg.lbp_mode == "sparse" or (J_un != 0).mean() < 0.05:
                g = EdgeGraph.from_dense(J_un)
                self.edge_graph = g
                si, di = np.asarray(g.src), np.asarray(g.dst)
                self.edge_w = put(np.stack([Ji[si, di] for Ji in J_sq]))

        # the round route, fixed here. Both kernels run one body over a
        # neighbour layout, so any colored f32 layout inside that body's own
        # limits (`round_kernel_limit`) takes one: K4 over dense J up to
        # n_pad 1536, K5 over the union tiles above it.
        fails = []
        if not blocked[0].colored:
            fails.append("use_coloring=True (colored Jacobi layout)")
        if dtype != torch.float32:
            fails.append(f"dtype must be float32, got {dtype}")
        limit = round_kernel_limit(n_pad, blocked[0].block_size)
        if limit:
            fails.append(limit)
        self.round_path = "plain"
        self._stream_tiles = self.round_nbrs = None
        if cfg.round_kernel != "off" and not fails:
            if n_pad <= K1_MAX_N_PAD:
                self.round_path = "K4"
                self.round_nbrs = neighbors_from_dense(
                    self.J_full, blocked[0].block_size)
            else:
                col_idx, J_tiles = union or _union_tiles(blocked)
                # each row block is one colour class, so its diagonal tile
                # is zero in every instance and some column tile is empty
                K, nB = col_idx.shape[1], blocked[0].num_blocks
                assert K <= max(nB - 1, 1), (K, nB)
                self.round_path = "K5"
                self._stream_tiles = (put(col_idx, torch.int32),
                                      put(J_tiles))
                self.round_nbrs = neighbors_from_tiles(*self._stream_tiles)
        if self.round_path == "plain" and (
                cfg.round_kernel == "on"
                or (cfg.round_kernel == "auto" and dev.type == "cuda"
                    and blocked[0].colored and dtype == torch.float32)):
            raise ValueError(
                f"round_kernel={cfg.round_kernel!r} on {dev.type}: no round "
                "kernel fits: " + "; ".join(fails))

    # ------------------------------------------------------------------
    def init_state(self, generator: torch.Generator,
                   m0=None) -> EnsembleNMCState:
        """Random +-1 start. `m0` (optional, [I, C, n] ORIGINAL spin order,
        ascending energy) seeds the C coldest chains."""
        I, R, n_pad = self.I, self.R, self.n_pad
        u = torch.rand((I, R, n_pad), generator=generator, dtype=self.dtype,
                       device=self.device)
        m = torch.where(u < 0.5, -1.0, 1.0).to(self.dtype)
        if m0 is not None:
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
    def _extract_clusters(self, m, slot_to_beta):
        """Backbone masks for the slots holding NMC labels, every instance
        at once: LBP for those I * k states only, masks scattered back by
        slot."""
        cfg = self.cfg
        I, R, n = m.shape
        do_nmc = self.do_nmc_by_beta[slot_to_beta]                # [I, R]
        k = int(self.doNMC.sum())
        nmc_slots = torch.argsort(do_nmc.to(torch.int8), dim=1,
                                  stable=True)[:, R - k:]         # [I, k]
        idx = nmc_slots[..., None].expand(I, k, n)
        m_star = torch.gather(m, 1, idx).reshape(I * k, n)
        inst = torch.arange(I, device=self.device).repeat_interleave(k)
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
            marg.reshape(I, k, n), torch.abs(self.J_full),
            cfg.threshold_initial, cfg.threshold_cutoff, cfg.threshold_step,
            active=self.active, logits=True)
        cl = torch.zeros((I, R, n), dtype=torch.bool, device=self.device)
        cl.scatter_(1, idx, cl_k)
        return cl & self.active, do_nmc

    def _refresh(self, state: EnsembleNMCState):
        if self.any_nmc and state.round_index % self.cfg.lbp_every == 0:
            return self._extract_clusters(state.m, state.slot_to_beta)
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
                  nbrs=self.round_nbrs)
        if self.round_path == "K5":
            col_idx, J_tiles = self._stream_tiles
            return ensemble_round_sparse(
                col_idx, J_tiles, self.h, self.active, state.m, cl, do_nmc,
                base, state.generator, **kw)
        return ensemble_round(
            self.J_full, self.h, self.active, state.m, cl, do_nmc, base,
            state.generator, block_size=self.blocked0.block_size, **kw)

    def _plain_round(self, state, cl, do_nmc, uniforms):
        """The JAX engine's XLA round, instance by instance: per phase a
        fresh phi and one `run_sweeps` call; returns (carried states,
        carried energies, per-instance bests)."""
        cfg = self.cfg
        R, n = self.R, self.n_pad
        T = cfg.sweeps_per_phase
        dt, dev = self.dtype, self.device
        heat = torch.tensor(1.0 / cfg.temp_x, dtype=dt, device=dev)
        one = torch.ones((), dtype=dt, device=dev)
        ones_t = torch.ones((T,), dtype=dt, device=dev)
        act = self.active.expand(R, n)
        outs = []
        for i in range(self.I):
            dn = do_nmc[i][:, None]
            cli = cl[i]
            base_row = torch.where(
                do_nmc[i], torch.tensor(cfg.global_beta, dtype=dt,
                                        device=dev),
                self.beta_list[state.slot_to_beta[i]])[:, None]
            m, mb, eb = state.m[i], state.m_best[i], state.e_best[i]
            h, J = self.h[i], self.J_full[i]
            for p, kind in enumerate(phase_list(cfg.num_cycles,
                                                cfg.full_update_frequency)):
                if kind == "C":
                    bs = base_row * torch.where(dn & cli, heat, one)
                    mask = torch.where(dn, cli & act, act)
                elif kind == "NC":
                    bs, mask = base_row, torch.where(dn, ~cli & act, act)
                else:
                    bs, mask = base_row, act
                res = run_sweeps(
                    self.J_rows[i], self.J_diag[i], h, m, m @ J + h,
                    state.generator, ones_t, bs, mask, num_sweeps=T,
                    within_block=cfg.within_block,
                    uniforms=None if uniforms is None else uniforms[p, :, i])
                m = torch.where(dn, res.m_best, res.m)
                r = torch.argmin(res.e_best)
                imp = res.e_best[r] < eb
                mb = torch.where(imp, res.m_best[r], mb)
                eb = torch.where(imp, res.e_best[r], eb)
            e_car = -(0.5 * torch.sum(m * (m @ J), dim=-1)
                      + torch.sum(m * h, dim=-1))
            outs.append((m, e_car, mb, eb))
        m, e_car, mb, eb = (torch.stack(x) for x in zip(*outs))
        return m, e_car, mb, eb

    # ------------------------------------------------------------------
    def run_scanned(
        self,
        state: EnsembleNMCState,
        num_rounds: int,
        *,
        draws: Optional[Callable[[int], RoundDraws]] = None,
        timings: Optional[Dict[str, float]] = None,
    ) -> EnsembleNMCState:
        """`num_rounds` full ensemble rounds. `draws(round_index)` may
        inject a round's draws. With a `timings` dict, the device is
        synchronised between the stages and their host seconds are added
        under "lbp" (backbone refresh), "round" (the sweep phases: one
        kernel launch, or the plain round) and "swaps" (best fold and label
        swaps); without it nothing syncs outside the LBP refreshes."""
        cfg = self.cfg
        beta32 = self.beta_list.to(torch.float32)
        for _ in range(num_rounds):
            d = draws(state.round_index) if draws is not None else RoundDraws()
            t = _clock(timings, self.device)
            cl, do_nmc = self._refresh(state)
            t = _clock(timings, self.device, "lbp", t)
            if self.round_path == "plain":
                m, e_car, mb, eb = self._plain_round(state, cl, do_nmc,
                                                     d.sweep_uniforms)
                t = _clock(timings, self.device, "round", t)
            else:
                res = self._kernel_round(state, cl, do_nmc, d.sweep_uniforms)
                t = _clock(timings, self.device, "round", t)
                # fold the per-slot round bests into the per-instance best
                r = torch.argmin(res.e_best, dim=1, keepdim=True)    # [I, 1]
                e_r = torch.gather(res.e_best, 1, r)[:, 0]
                m_r = torch.gather(
                    res.m_best, 1, r[..., None].expand(-1, 1, self.n_pad))[:, 0]
                imp = e_r < state.e_best
                mb = torch.where(imp[:, None], m_r, state.m_best)
                eb = torch.where(imp, e_r, state.e_best)
                m, e_car = res.m, res.e_carried
            swap = metropolis_label_swap(
                state.beta_to_slot, beta32, e_car.to(torch.float32),
                num_pairs=cfg.num_swapping_pairs, generator=state.generator,
                gumbels=d.gumbels, uniforms=d.swap_uniforms)
            _clock(timings, self.device, "swaps", t)
            state = EnsembleNMCState(
                m=m, beta_to_slot=swap.beta_to_slot,
                slot_to_beta=swap.slot_to_beta, generator=state.generator,
                round_index=state.round_index + 1, m_best=mb, e_best=eb,
                cl=cl, do_nmc_slot=do_nmc)
        return state

    def best(self, state: EnsembleNMCState):
        """([I] best energies, [I, n] best states in original order), numpy;
        the one host sync of a chunk."""
        eb = state.e_best.cpu().numpy()
        mb = state.m_best[:, self._inv_perm].cpu().numpy()
        return eb, mb


def _clock(timings, device, key=None, t0=None):
    """Timing marks for `run_scanned`: with a dict, synchronise the device
    and add the seconds since `t0` under `key`."""
    if timings is None:
        return None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    now = time.perf_counter()
    if key is not None:
        timings[key] = timings.get(key, 0.0) + now - t0
    return now


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
