"""Instance-ensemble APT+ICM on one card (torch): the Houdayer baseline at
campaign scale.

The counterpart of ``nmc_tpu/parallel/ensemble_icm.py``, the campaign's
`icm` and `hybrid` arms. Every (instance, sub-replica, replica) chain is one
slot of a leading [I, S, R] batch, and each round runs, for all instances
at once:
  1. the sweep stage: every chain at its label's temperature;
  2. the Houdayer stage: per instance one random pairing of the S
     sub-replicas, and for each pair and each temperature the two chains
     holding that temperature exchange one disagreement cluster (or, past
     n_pad // 2 spins, the first is flipped whole: Katzgraber), all
     I x S // 2 x R pairs in one batched call (`ops/clusters.py`);
  3. the energies of the carried states, the fold into each instance's
     best, and one Metropolis label swap round per (instance, sub-replica)
     over the temperature ladder (`parallel/swaps.py`).

The family is padded to its largest spin count, coloured on the UNION of
its coupling graphs and blocked with that colouring, as in `EnsembleNMC`.
Built once at setup: per-instance edge lists in the blocked layout, padded
to a common length with dummy edges on the last padded spin; the union
block-sparse tiles; the Houdayer operand of the chosen backend (`houdayer`:
"matmul", the neighbour index table, when the family's max degree is at
most 16, else "sparse", the edge lists, under "auto"; "blocked", the
union tiles' adjacency, only when asked); the round kernels' neighbour
layout `round_nbrs`. All four backends reach the same labels, so they give
one trajectory.

The sweep stage's route is fixed at setup (`round_path`), with the rule of
`EnsembleNMC`:
  * "K4" / "K5": one whole-round kernel launch over [I, S * R, n_pad]
    chains (`ops/round_cuda.py`), base beta = the slot's label
    temperature; pure ICM passes empty backbone masks (three plain phases
    of sweeps_per_round / 3 sweeps), the hybrid arm the carried
    disagreement masks and the heated factor of 1 / temp_x. K4 up to
    n_pad 1536, K5 above; a coloured float32 layout whose
    `sweeps_per_round` is not a multiple of 3 * num_cycles raises;
  * "plain": one instance after another through its sweep engine, pure
    ICM as one unsplit call of sweeps_per_round sweeps, the hybrid arm as
    the heat / refreeze / full cycle. It serves `round_kernel="off"` and
    uncoloured or float64 layouts.
The two routes heat the disagreement set differently, each as its JAX
counterpart does: the kernels by beta_row * (1 + f32(temp_x_inv - 1)), the
plain route by base * f32(1 / temp_x).

Hybrid (`hybrid_cold` > 0): the post-move disagreement set of each pair
(s1 != s2 on active spins) becomes, on the `hybrid_cold` coldest
temperatures and when it holds at most `max_heat_frac` of the active spins,
both chains' cluster mask for the next round's heated phases; pure ICM
carries no masks (`cl` and `dn` are None).

`run_scanned` syncs with the host only in the fixed-point loops' convergence
tests. Randomness comes from the state's `torch.Generator`; `ICMDraws`
inject a round's draws (for the whole ensemble) so tests can replay the
JAX engine's keys.

With a `group=` the instances are sharded over its ranks as in
`EnsembleNMC`: the layout (colouring, union tiles, edge lists, degree
gate) is the whole family's; each rank draws every round's randomness for
all I instances (the kernels' seed words with its instance offset, the
plain phases' seeds or uniforms, the sub-replica pairings, the cluster
uniforms, the swap draws) and keeps its own; the carried energies run per
instance (`core.energy.by_rows`). The same seed gives the same
trajectory at every world size; `best` gathers. Without a group the
instance count is never cut. On a card the plain route's phases run the
sweep kernels through one `SweepEngine` per instance.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.energy import by_rows, energy
from ..core.problem import IsingProblem, block_problem
from ..device import resolve_device, resolve_dtype
from ..ops.clusters import (NeighborPlanes, build_neighbor_planes,
                            houdayer_move_blocked, houdayer_move_matmul,
                            houdayer_move_sparse)
from ..ops.engine import K1_MAX_N_PAD, SweepEngine
from ..ops.round_cuda import (ensemble_round, ensemble_round_sparse,
                              neighbors_from_dense, neighbors_from_tiles,
                              round_kernel_limit)
from ..utils.metrics import RoundSpans, count, host_sync
from . import distributed
from .ensemble_nmc import InstanceDraws, _pad_problem, _union_tiles
from .swaps import metropolis_label_swap, swap_draws


@dataclasses.dataclass
class EnsembleICMConfig:
    """The JAX package's EnsembleICMConfig: the same fields and defaults.
    `precision` is accepted and has no effect (the port keeps every float32
    product in full precision, `device.py`)."""
    sweeps_per_round: int = 32
    num_subreplicas: int = 10
    use_katzgraber: bool = True
    num_swapping_pairs: int = 1
    block_size: int = 128
    use_coloring: bool = False
    within_block: str = "sequential"
    precision: str = "highest"
    dtype: str = "float32"
    round_kernel: str = "auto"   # 'auto' | 'on' | 'off', as EnsembleNMC
    houdayer: str = "auto"       # 'auto' | 'matmul' | 'blocked' | 'sparse'
    hybrid_cold: int = 0         # > 0: heated phases on the disagreement
                                 # sets of the hybrid_cold coldest rungs
    temp_x: float = 20.0
    num_cycles: int = 1          # cycles per round when hybrid is on
    max_heat_frac: float = 0.5   # skip heating past this share of spins


class EnsembleICMState(NamedTuple):
    m: torch.Tensor             # [I, S, R, n_pad] chains by slot per sub
    beta_to_slot: torch.Tensor  # [I, S, R] int64 label permutation
    slot_to_beta: torch.Tensor  # [I, S, R] int64
    generator: torch.Generator  # every draw of the rounds (JAX: the key)
    round_index: int
    m_best: torch.Tensor        # [I, n_pad]
    e_best: torch.Tensor        # [I]
    icm_moves: torch.Tensor     # [I] int64 cumulative cluster exchanges
    icm_flips: torch.Tensor     # [I] int64 cumulative Katzgraber flips
    cl: Optional[torch.Tensor]  # [I, S, R, n_pad] disagreement masks (hybrid)
    dn: Optional[torch.Tensor]  # [I, S, R] chains with heated phases (hybrid)


class ICMDraws(NamedTuple):
    """One round's injected draws; None draws from the state's generator."""
    sweep_uniforms: Optional[torch.Tensor] = None    # [P, T, I, S*R, n_pad]
    perms: Optional[torch.Tensor] = None             # [I, S] sub-replica order
    cluster_uniforms: Optional[torch.Tensor] = None  # [I, S // 2, R, n_pad]
    gumbels: Optional[torch.Tensor] = None           # [I, S, num_pairs, R - 1]
    swap_uniforms: Optional[torch.Tensor] = None     # [I, S, num_pairs]


class EnsembleICM:
    """Batched-instance APT + Houdayer ICM (and the ICM+NMC hybrid) on one
    device."""

    def __init__(
        self,
        problems: Sequence[IsingProblem],
        beta_list: Sequence[float],
        cfg: EnsembleICMConfig = EnsembleICMConfig(),
        *,
        device=None,
        group=None,
    ):
        if len({p.n for p in problems}) != 1:
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
        self.R = R = beta_list.shape[0]
        self.S = S = cfg.num_subreplicas
        if cfg.round_kernel not in ("auto", "on", "off"):
            raise ValueError(f"round_kernel must be auto|on|off, "
                             f"got {cfg.round_kernel!r}")
        if cfg.houdayer not in ("auto", "matmul", "blocked", "sparse"):
            raise ValueError(f"houdayer must be auto|matmul|blocked|"
                             f"sparse, got {cfg.houdayer!r}")

        groups = None
        if cfg.use_coloring:
            from ..ops.coloring import color_groups
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
        self.cfg = cfg
        self.blocked0 = all_blocked[0]
        self.n_pad = n_pad = all_blocked[0].n_pad
        if not 0 <= cfg.hybrid_cold <= R:
            raise ValueError(f"hybrid_cold={cfg.hybrid_cold} must be in "
                             f"[0, R={R}]")
        self.hybrid = cfg.hybrid_cold > 0
        self._cycles = cfg.num_cycles if self.hybrid else 1
        if self.hybrid and cfg.sweeps_per_round % (3 * self._cycles):
            # both routes split a hybrid round into 3 phases per cycle
            raise ValueError(
                f"sweeps_per_round={cfg.sweeps_per_round} must be a "
                f"multiple of 3*num_cycles={3 * self._cycles} when "
                f"hybrid_cold > 0")
        # the hybrid_cold COLDEST temperatures (largest beta) heat
        cold_t = np.zeros(R, bool)
        if self.hybrid:
            cold_t[np.argsort(beta_list)[-cfg.hybrid_cold:]] = True

        def put(x, dt=dtype):
            return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

        def stack(xs, shape):
            return put(np.stack(xs) if xs else np.zeros((0,) + shape))

        b0 = self.blocked0
        self.cold_t = put(cold_t, torch.bool)
        self.J_rows = stack([b.J_rows for b in blocked], b0.J_rows.shape)
        self.J_diag = stack([b.J_diag for b in blocked], b0.J_diag.shape)
        self.J_full = self.J_rows.reshape(self.I, n_pad, n_pad)
        self.h = stack([b.h for b in blocked], (n_pad,))
        self.active = put(b0.active, torch.bool)
        self._inv_perm = torch.as_tensor(b0.inv_perm,
                                         dtype=torch.int64, device=dev)
        self.beta_list = put(beta_list)

        # per-instance edge lists in the blocked layout, padded to a common
        # length with dummy self-edges on the last (padded) spin
        srcs, dsts = [], []
        for b in all_blocked:
            iu, ju = np.nonzero(np.triu(b.J_rows.reshape(n_pad, n_pad), 1))
            srcs.append(np.concatenate([iu, ju]))
            dsts.append(np.concatenate([ju, iu]))
        E_max = max(s.shape[0] for s in srcs)
        src = np.full((self.I_total, E_max), n_pad - 1, np.int64)
        dst = np.full((self.I_total, E_max), n_pad - 1, np.int64)
        for i, (s_, d_) in enumerate(zip(srcs, dsts)):
            src[i, :s_.shape[0]] = s_
            dst[i, :d_.shape[0]] = d_
        src, dst = src[lo:hi], dst[lo:hi]
        # max node degree over the real edges: the matmul backend's gate
        deg_max = max((int(np.bincount(d_, minlength=n_pad).max())
                       for d_ in dsts if d_.shape[0]), default=0)
        matmul_ok = 0 < deg_max <= 16 and n_pad <= 65536
        if cfg.houdayer == "matmul" and not matmul_ok:
            raise ValueError(
                f"houdayer='matmul' needs max node degree <= 16 and "
                f"n_pad <= 65536 (got degree {deg_max}, n_pad "
                f"{n_pad}); use 'sparse' for dense instances")
        self.houdayer = ("matmul" if cfg.houdayer == "auto" and matmul_ok
                         else "sparse" if cfg.houdayer == "auto"
                         else cfg.houdayer)

        # the sweep stage's route, fixed here (EnsembleNMC's rule)
        fails = []
        if not b0.colored:
            fails.append("use_coloring=True (colored Jacobi layout)")
        if dtype != torch.float32:
            fails.append(f"dtype must be float32, got {dtype}")
        limit = round_kernel_limit(n_pad, b0.block_size)
        if limit:
            fails.append(limit)
        kernel = cfg.round_kernel != "off" and not fails
        if kernel and cfg.sweeps_per_round % (3 * self._cycles):
            raise ValueError(
                f"round_kernel={cfg.round_kernel!r}: sweeps_per_round="
                f"{cfg.sweeps_per_round} must be a multiple of "
                f"3*num_cycles={3 * self._cycles} (the round kernels run 3 "
                f"phases per cycle); pass round_kernel='off' for the plain "
                f"route")
        union = None
        if (kernel and n_pad > K1_MAX_N_PAD) or self.houdayer != "sparse":
            col_idx_u, J_tiles_u = _union_tiles(all_blocked)
            union = (col_idx_u, J_tiles_u[lo:hi])
        self.round_path = "plain"
        self._stream_tiles = self.round_nbrs = None
        if kernel and self.I:
            if n_pad <= K1_MAX_N_PAD:
                self.round_path = "K4"
                self.round_nbrs = neighbors_from_dense(
                    self.J_full, b0.block_size)
            else:
                col_idx, J_tiles = union
                K, nB = col_idx.shape[1], b0.num_blocks
                assert K <= max(nB - 1, 1), (K, nB)
                self.round_path = "K5"
                self._stream_tiles = (put(col_idx, torch.int32),
                                      put(J_tiles))
                self.round_nbrs = neighbors_from_tiles(*self._stream_tiles)
            # the kernels hold dm over the layout's widest step
            limit = round_kernel_limit(n_pad, self.round_nbrs.step_spins)
            if limit:
                fails.append(limit)
                self.round_path = "plain"
                self._stream_tiles = self.round_nbrs = None
        if self.round_path == "plain" and (
                cfg.round_kernel == "on"
                or (cfg.round_kernel == "auto" and dev.type == "cuda"
                    and b0.colored and dtype == torch.float32)):
            raise ValueError(
                f"round_kernel={cfg.round_kernel!r} on {dev.type}: no round "
                "kernel fits: " + "; ".join(fails))
        # the plain route's sweeps: one sweep engine per instance
        self._engines = []
        if self.round_path == "plain":
            self._engines = [SweepEngine.from_blocked_problem(
                b, problems[lo + i], within_block=cfg.within_block,
                dtype=dtype, device=dev) for i, b in enumerate(blocked)]
        self._on_kernels = all(e.sweep_kernel is not None
                               for e in self._engines)
        if group is not None and dev.type == "cuda" and not self._on_kernels:
            raise ValueError(
                "a sharded EnsembleICM on cuda runs its sweeps on the sweep "
                "kernels; this layout has none (an uncoloured block-Jacobi "
                "sweep)")

        # the Houdayer operand of the chosen backend
        self._houd = None
        if self.houdayer == "sparse":
            self._houd = (put(src, torch.int64), put(dst, torch.int64))
        elif self.houdayer == "blocked":
            col_idx, J_tiles = union
            self._houd = (put(col_idx, torch.int64),
                          put(J_tiles != 0, torch.bool))
        else:
            col_idx, J_tiles = union
            index = stack([build_neighbor_planes(
                col_idx, J_tiles[i], degree=deg_max).index
                for i in range(self.I)], (0,))
            self._houd = NeighborPlanes(put(col_idx, torch.int64),
                                        index.to(torch.int64), n_pad,
                                        b0.block_size)
        self._spans = RoundSpans("EnsembleICM", dev)

    # ------------------------------------------------------------------
    def init_state(self, generator: torch.Generator,
                   m0=None) -> EnsembleICMState:
        """Random +-1 start. `m0` (optional, [I, C, n] ORIGINAL spin order,
        ascending energy) seeds the C coldest chains of SUB-REPLICA 0 only,
        so the Houdayer pairs start with disagreement sets."""
        I, S, R, n_pad = self.I, self.S, self.R, self.n_pad
        dev = self.device
        u = torch.rand((self.I_total, S, R, n_pad), generator=generator,
                       dtype=self.dtype, device=dev)
        m = torch.where(u < 0.5, -1.0, 1.0).to(self.dtype)
        m = m[self.i0:self.i0 + I]
        if m0 is not None:
            m0 = np.asarray(m0)[self.i0:self.i0 + I]
            m0 = torch.as_tensor(self.blocked0.to_blocked(np.asarray(m0),
                                                          fill=1.0),
                                 dtype=self.dtype, device=dev)
            C = m0.shape[1]
            if C > R:
                raise ValueError(f"m0 has {C} seeds > {R} replicas")
            m[:, 0, R - C:, :] = m0.flip(1)
        m = torch.where(self.active, m, 1.0).to(self.dtype)
        ids = torch.arange(R, device=dev).expand(I, S, R)
        zeros = torch.zeros((I,), dtype=torch.int64, device=dev)
        return EnsembleICMState(
            m=m, beta_to_slot=ids.clone(), slot_to_beta=ids.clone(),
            generator=generator, round_index=0,
            m_best=torch.ones((I, n_pad), dtype=self.dtype, device=dev),
            e_best=torch.full((I,), float("inf"), dtype=self.dtype,
                              device=dev),
            icm_moves=zeros, icm_flips=zeros.clone(),
            cl=(torch.zeros((I, S, R, n_pad), dtype=torch.bool, device=dev)
                if self.hybrid else None),
            dn=(torch.zeros((I, S, R), dtype=torch.bool, device=dev)
                if self.hybrid else None))

    # ------------------------------------------------------------------
    def _kernel_sweeps(self, state, uniforms):
        """The sweep stage of every instance in one K4/K5 launch over the
        flattened [I, S * R] slots, then the fold of the per-slot round
        bests into each instance's best."""
        cfg = self.cfg
        I, S, R, n = state.m.shape
        Rk = S * R
        base = self.beta_list[state.slot_to_beta].reshape(I, Rk)
        if self.hybrid:
            cl = state.cl.reshape(I, Rk, n)
            dn = state.dn.reshape(I, Rk)
        else:
            cl = torch.zeros((), dtype=torch.bool,
                             device=self.device).expand(I, Rk, n)
            dn = torch.zeros((I, Rk), dtype=torch.bool, device=self.device)
        kw = dict(num_cycles=self._cycles,
                  sweeps_per_phase=cfg.sweeps_per_round // (3 * self._cycles),
                  temp_x_inv=1.0 / cfg.temp_x if self.hybrid else 1.0,
                  uniforms=uniforms, nbrs=self.round_nbrs,
                  instance_offset=self.i0, instances_total=self.I_total)
        m0 = state.m.reshape(I, Rk, n)
        if self.round_path == "K5":
            col_idx, J_tiles = self._stream_tiles
            res = ensemble_round_sparse(col_idx, J_tiles, self.h, self.active,
                                        m0, cl, dn, base, state.generator,
                                        **kw)
        else:
            res = ensemble_round(self.J_full, self.h, self.active, m0, cl, dn,
                                 base, state.generator,
                                 block_size=self.blocked0.block_size, **kw)
        r = torch.argmin(res.e_best, dim=1, keepdim=True)          # [I, 1]
        e_r = torch.gather(res.e_best, 1, r)[:, 0]
        m_r = torch.gather(res.m_best, 1, r[..., None].expand(-1, 1, n))[:, 0]
        imp = e_r < state.e_best
        return (res.m.reshape(I, S, R, n),
                torch.where(imp[:, None], m_r, state.m_best),
                torch.where(imp, e_r, state.e_best))

    def _plain_sweeps(self, state, uniforms):
        """The JAX engine's XLA sweep stage, instance by instance: pure ICM
        one `run_sweeps` call of sweeps_per_round sweeps, the hybrid arm
        the heat / refreeze / full cycle on the carried masks."""
        cfg = self.cfg
        I, S, R, n = state.m.shape
        Rk = S * R
        dt, dev = self.dtype, self.device
        act = self.active.expand(Rk, n)
        T = (cfg.sweeps_per_round if not self.hybrid
             else cfg.sweeps_per_round // (3 * self._cycles))
        ones_t = torch.ones((T,), dtype=dt, device=dev)
        heat = host_sync(torch.tensor, 1.0 / cfg.temp_x, dtype=dt, device=dev)
        one = torch.ones((), dtype=dt, device=dev)
        draws = InstanceDraws(self, state.generator,
                              3 * self._cycles if self.hybrid else 1, T, Rk,
                              uniforms, self._on_kernels)
        outs = []
        for i in range(I):
            h, J = self.h[i], self.J_full[i]
            base = self.beta_list[state.slot_to_beta[i]].reshape(Rk, 1)
            flat = state.m[i].reshape(Rk, n)
            mb, eb = state.m_best[i], state.e_best[i]

            def phase(mm, p, beta_spin, mask):
                return self._engines[i].run(
                    mm, draws.generator, T, ones_t, beta_spin=beta_spin,
                    update_mask=mask, blocked_input=True,
                    blocked_output=True, phi=mm @ J + h, **draws.kw(i, p))

            def track(res, mb, eb):
                r = torch.argmin(res.e_best)
                imp = res.e_best[r] < eb
                return (torch.where(imp, res.m_best[r], mb),
                        torch.where(imp, res.e_best[r], eb))

            if not self.hybrid:
                res = phase(flat, 0, base, act)
                mb, eb = track(res, mb, eb)
                flat = res.m
            else:
                clf = state.cl[i].reshape(Rk, n)
                dnf = state.dn[i].reshape(Rk, 1)
                hot = base * torch.where(dnf & clf, heat, one)
                p = 0
                for _ in range(self._cycles):
                    for beta_spin, mask in (
                            (hot, torch.where(dnf, clf & act, act)),
                            (base, torch.where(dnf, ~clf & act, act)),
                            (base, act)):
                        res = phase(flat, p, beta_spin, mask)
                        flat = torch.where(dnf, res.m_best, res.m)
                        mb, eb = track(res, mb, eb)
                        p += 1
            outs.append((flat.reshape(S, R, n), mb, eb))
        draws.finish()
        m, mb, eb = (torch.stack(x) for x in zip(*outs))
        return m, mb, eb

    def _move(self, s1, s2, group, generator, g, stats):
        """The Houdayer moves of all pairs [P, n_pad] through the backend
        chosen at setup; `group` [P] is each pair's instance."""
        kw = dict(g=g, use_katzgraber=self.cfg.use_katzgraber, group=group,
                  stats=stats)
        if self.houdayer == "matmul":
            return houdayer_move_matmul(self._houd, s1, s2, generator, **kw)
        if self.houdayer == "blocked":
            return houdayer_move_blocked(*self._houd, s1, s2, generator, **kw)
        return houdayer_move_sparse(*self._houd, s1, s2, generator, **kw)

    def _houdayer(self, state, m, d: ICMDraws, stats):
        """One same-temperature pairing of the sub-replicas per instance,
        the moves of all I x S // 2 x R pairs in one call, scattered back
        into m (in place); padded spins re-pinned to +1 (a Katzgraber flip
        flips them). Returns (m, moves [I], flips [I], cl, dn)."""
        I, S, R, n = m.shape
        Pn = S // 2
        dev = self.device
        cl = dn = None
        if self.hybrid:
            cl = torch.zeros((I, S, R, n), dtype=torch.bool, device=dev)
            dn = torch.zeros((I, S, R), dtype=torch.bool, device=dev)
        if Pn == 0:
            return m, state.icm_moves, state.icm_flips, cl, dn
        lo, hi = self.i0, self.i0 + I
        perm = d.perms
        if perm is None:
            perm = torch.argsort(torch.rand(
                (self.I_total, S), generator=state.generator,
                device=state.generator.device), dim=1)
        perm = torch.as_tensor(perm, device=dev).long()[lo:hi]
        sj = perm[:, 0:2 * Pn:2, None]                      # [I, Pn, 1]
        sk = perm[:, 1:2 * Pn:2, None]
        # temperature t's chain in sub s is slot beta_to_slot[s, t]
        b2s = state.beta_to_slot
        slot_j = torch.gather(b2s, 1, sj.expand(I, Pn, R))  # [I, Pn, R]
        slot_k = torch.gather(b2s, 1, sk.expand(I, Pn, R))
        ii = torch.arange(I, device=dev)[:, None, None]
        s1 = m[ii, sj, slot_j].reshape(I * Pn * R, n)
        s2 = m[ii, sk, slot_k].reshape(I * Pn * R, n)
        g = d.cluster_uniforms
        if g is None:
            # the moves' cluster choices, drawn for every instance
            g = torch.rand((self.I_total * Pn * R, n), generator=state.generator,
                           dtype=s1.dtype, device=dev)[lo * Pn * R:hi * Pn * R]
        else:
            g = torch.as_tensor(g, device=dev)[lo:hi].reshape(I * Pn * R, n)
        group = torch.arange(I, device=dev).repeat_interleave(Pn * R)
        count("houdayer_pairs", I * Pn * R)
        s1n, s2n, moved, flipped = self._move(s1, s2, group,
                                              state.generator, g, stats)
        s1n = s1n.reshape(I, Pn, R, n)
        s2n = s2n.reshape(I, Pn, R, n)
        m[ii, sj, slot_j] = s1n
        m[ii, sk, slot_k] = s2n
        m = torch.where(self.active, m, 1.0).to(self.dtype)
        moves = state.icm_moves + moved.reshape(I, -1).sum(dim=1)
        flips = state.icm_flips + flipped.reshape(I, -1).sum(dim=1)
        if self.hybrid:
            # the POST-move disagreement set: after a Katzgraber flip the
            # pair disagrees on the complement of the pre-move set
            diff = (s1n != s2n) & self.active               # [I, Pn, R, n]
            frac = (diff.sum(dim=-1).to(self.dtype)
                    / self.active.sum().to(self.dtype))
            ok = ((frac > 0) & (frac <= self.cfg.max_heat_frac)
                  & self.cold_t)                             # [I, Pn, R]
            mask = diff & ok[..., None]
            cl[ii, sj, slot_j] = mask
            cl[ii, sk, slot_k] = mask
            dn[ii, sj, slot_j] = ok
            dn[ii, sk, slot_k] = ok
        return m, moves, flips, cl, dn

    # ------------------------------------------------------------------
    def run_scanned(
        self,
        state: EnsembleICMState,
        num_rounds: int,
        *,
        draws: Optional[Callable[[int], ICMDraws]] = None,
        timings: Optional[Dict[str, Any]] = None,
        houdayer_stats: Optional[Dict[str, int]] = None,
    ) -> EnsembleICMState:
        """`num_rounds` full ensemble rounds. `draws(round_index)` may
        inject a round's draws. With a `timings` dict each round records
        sync-free stage spans (`utils.metrics.RoundSpans`): the device
        seconds of "round" (the sweep stage), "houdayer" (pairing, moves,
        masks) and "swaps" (carried energies, best fold, label swaps), with
        "rounds", "host_s" and "host_syncs", and the counters
        "houdayer_pairs" (the pairs moved) and "houdayer_steps" (the
        fixed-point loops' steps), host integers that add no sync; a round
        lands in the dict once the card has passed it, at the latest at
        `best` or `flush`. `houdayer_stats` receives the fixed-point loops'
        most "steps" and "iterations" (`ops/clusters._label_fixpoint`;
        "iterations" reads the card once more a loop)."""
        cfg = self.cfg
        I, S, R, n = self.I, self.S, self.R, self.n_pad
        lo, hi = self.i0, self.i0 + I
        beta32 = self.beta_list.to(torch.float32)
        ii = torch.arange(I, device=self.device)
        if I == 0:       # a rank past the instance shards holds none
            return state._replace(round_index=state.round_index + num_rounds)
        spans = self._spans
        for _ in range(num_rounds):
            d = draws(state.round_index) if draws is not None else ICMDraws()
            with spans.round(timings):
                with spans.stage("round"):
                    if self.round_path == "plain":
                        m, mb, eb = self._plain_sweeps(state, d.sweep_uniforms)
                    else:
                        m, mb, eb = self._kernel_sweeps(
                            state, None if d.sweep_uniforms is None
                            else d.sweep_uniforms[:, :, lo:hi].contiguous())
                with spans.stage("houdayer"):
                    m, moves, flips, cl, dn = self._houdayer(state, m, d,
                                                             houdayer_stats)
                with spans.stage("swaps"):
                    flat = m.reshape(I, S * R, n)
                    e = by_rows(energy, self.J_full, self.h[:, None, :], flat,
                                sharded=self.group is not None)  # [I, S*R]
                    r = torch.argmin(e, dim=1)
                    e_min = e[ii, r]
                    imp = e_min < eb
                    mb = torch.where(imp[:, None], flat[ii, r], mb)
                    eb = torch.where(imp, e_min, eb)
                    npairs = cfg.num_swapping_pairs
                    if d.gumbels is None:
                        g, su = swap_draws(state.generator, self.I_total * S,
                                           npairs, R, lo * S, I * S)
                    else:
                        g = d.gumbels[lo:hi].reshape(I * S, npairs, R - 1)
                        su = d.swap_uniforms[lo:hi].reshape(I * S, npairs)
                    swap = metropolis_label_swap(
                        state.beta_to_slot.reshape(I * S, R), beta32,
                        e.reshape(I * S, R).to(torch.float32),
                        num_pairs=npairs, gumbels=g, uniforms=su)
            state = EnsembleICMState(
                m=m, beta_to_slot=swap.beta_to_slot.reshape(I, S, R),
                slot_to_beta=swap.slot_to_beta.reshape(I, S, R),
                generator=state.generator,
                round_index=state.round_index + 1, m_best=mb, e_best=eb,
                icm_moves=moves, icm_flips=flips, cl=cl, dn=dn)
        return state

    def flush(self) -> None:
        """Sum every round recorded with a `timings` dict into it, waiting
        for the card to pass them (`best` does so without waiting)."""
        self._spans.flush()

    def best(self, state: EnsembleICMState):
        """([I] best energies, [I, n] best states in original order), numpy,
        every instance (gathered over the group); the one host sync of a
        chunk."""
        out = (distributed.host_gather(state.e_best, self.group),
               distributed.host_gather(state.m_best[:, self._inv_perm],
                                       self.group))
        self._spans.collect()
        return out
