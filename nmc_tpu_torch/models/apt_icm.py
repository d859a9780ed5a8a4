"""APT + ICM: parallel tempering with Houdayer isoenergetic cluster moves
(torch).

The counterpart of ``nmc_tpu/models/apt_icm.py``. Per swap round all R * S
chains (R temperatures x S sub-replicas) run as one batch of the sweep
engine; then, per temperature, the sub-replicas are paired at random and
each pair exchanges one random cluster of its disagreement graph (spins
with s1_i * s2_i = -1 over J-edges), or, with Katzgraber's modification,
state 1 is flipped whole when the cluster exceeds n / 2 spins; then
randomly chosen non-overlapping adjacent temperature pairs are Metropolis
tested once per sub-replica.

Two Houdayer paths, `device_icm` (None: the device above 2048 spins):
  * host: `ops/clusters.disagreement_clusters_adj` (the native C++
    union-find) over a `CSRAdjacency` built once, the cluster drawn by
    `host_rng`;
  * device: one batched `houdayer_move_sparse` call over the problem's
    edge list (`EdgeGraph`) for all R * S // 2 pairs.

Reference quirks kept by default (faithful_quirks=True), as in the JAX
package: the move operates on each chain's FIRST sweep of the round and is
written only into the recorded energies / history, not into the chain's
continuation; the final per-replica energy reads sub-replica 0's first
read_per_swap sweeps of the last round; normalization is the caller's job
(normalize=False). With faithful_quirks=False the move uses the final
states and feeds back into the chains.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.problem import IsingProblem
from ..device import resolve_device
from ..ops.clusters import (CSRAdjacency, disagreement_clusters_adj,
                            houdayer_move_sparse)
from ..ops.engine import SweepEngine
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.metrics import MetricsLogger
from .npt import select_non_overlapping_pairs


@dataclasses.dataclass
class APTICMConfig:
    """The JAX package's APTICMConfig: the same fields and defaults. The
    reference's constants num_subreplicas = 10 and useKatzgraber are
    exposed; `use_hash_table` is accepted and has no effect; `precision`
    has none either (full float32 products, `device.py`)."""
    num_sweeps_MCMC: int = 1000
    num_sweeps_read: int = 1000
    num_swap_attempts: int = 100
    num_swapping_pairs: int = 1
    num_subreplicas: int = 10
    use_katzgraber: bool = True
    use_hash_table: bool = False
    faithful_quirks: bool = True
    normalize: bool = False        # the reference expects normalized J, h
    device_icm: Optional[bool] = None  # None: device above 2048 spins
    icm_label_iters: Optional[int] = None  # cap of the device fixed point
    record_last_round_m: bool = False  # keep the last round's history
    block_size: int = 128
    use_coloring: bool = False
    dtype: str = "float32"
    precision: str = "highest"
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0      # snapshot every K swap rounds (0 = off)
    resume: bool = False
    # time to solution (NORMALIZED units), as NPTConfig
    target_energy: Optional[float] = None
    target_atol: float = 0.0


class APTICMResult(NamedTuple):
    Energy: np.ndarray          # [R] reference-semantics replica energies
    energy_trace: np.ndarray    # [R, read_per_swap] sub-replica 0, last round
    final_states: np.ndarray    # [R, S, n]
    M_history: Optional[np.ndarray]  # [R, S, per_swap, n] last round (the
                                     # move's column Houdayer-modified)
    min_energy: float
    best_state: np.ndarray      # [n]
    swap_counts: np.ndarray     # [num_swap_attempts]
    icm_moves: int              # Houdayer exchanges performed
    icm_flips: int              # Katzgraber full flips performed
    beta_list: np.ndarray
    rounds_completed: int = 0
    hit_round: Optional[int] = None
    hit_seconds: Optional[float] = None


def apt_icm_run(
    problem: IsingProblem,
    beta_list: Sequence[float],
    cfg: APTICMConfig = APTICMConfig(),
    generator: Optional[torch.Generator] = None,
    metrics: Optional[MetricsLogger] = None,
    device=None,
    *,
    m_init: Optional[np.ndarray] = None,
    host_rng: Optional[np.random.Generator] = None,
    uniforms: Optional[Iterable[tuple]] = None,
) -> APTICMResult:
    """APT + ICM over `beta_list`, `cfg.num_subreplicas` chains each.

    `generator` (default: seed 0 on `device`) drives every device draw and
    seeds `host_rng`, which draws the pairings, the host path's cluster
    choice, the pair selection and the Metropolis tests. `m_init`
    ([R, S, n]), `host_rng` and `uniforms` (per round a triple: the first
    sweep's uniforms [1, R * S, n_pad], the other sweeps' [per_swap - 1,
    R * S, n_pad] and the device path's cluster uniforms [R * (S // 2), n],
    each None to draw) replace those draws, so tests can replay another
    implementation's.
    """
    t_entry = time.perf_counter()
    if device is None and generator is not None:
        device = generator.device
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    beta_list = np.asarray(beta_list, dtype=np.float64).reshape(-1)
    R = beta_list.shape[0]
    S = cfg.num_subreplicas
    norm_prob = problem.normalized()[0] if cfg.normalize else problem
    n = norm_prob.n
    engine = SweepEngine(norm_prob, block_size=cfg.block_size,
                         use_coloring=cfg.use_coloring, dtype=cfg.dtype,
                         device=device)

    per_swap = cfg.num_sweeps_MCMC // cfg.num_swap_attempts
    read_per_swap = max(cfg.num_sweeps_read // cfg.num_swap_attempts, 1)
    if per_swap < 1:
        raise ValueError("num_sweeps_MCMC // num_swap_attempts must be >= 1")

    if m_init is None:
        m_init = engine.from_blocked(engine.init_states(generator, R * S))
        m_init = m_init.cpu().numpy()
    m_start = np.array(m_init, dtype=np.float64).reshape(R, S, n)
    device_icm = (cfg.device_icm if cfg.device_icm is not None
                  else norm_prob.n > 2048)
    if device_icm:
        from ..ops.lbp_sparse import EdgeGraph
        graph = EdgeGraph.from_dense(norm_prob.J)            # built once
        src = torch.as_tensor(graph.src, dtype=torch.int64, device=device)
        dst = torch.as_tensor(graph.dst, dtype=torch.int64, device=device)
    else:
        adjacency = CSRAdjacency(norm_prob.J)                # built once
    if host_rng is None:
        host_rng = np.random.default_rng(int(torch.randint(
            0, 2 ** 62, (1,), generator=generator, device=generator.device)))
    round_uniforms = iter(uniforms) if uniforms is not None else None

    # all R*S chains share one batched call; chain (r, s) runs at beta[r]
    beta_chain = np.repeat(beta_list, S)
    all_pairs = [(i, i + 1) for i in range(1, R)]
    swap_counts = np.zeros(cfg.num_swap_attempts)
    icm_moves = icm_flips = 0
    best_e, best_state = np.inf, m_start[0, 0].copy()
    energies_round = np.zeros((R, S, per_swap))

    M_history = None
    start_round = 0
    if (cfg.resume and cfg.checkpoint_path
            and os.path.exists(cfg.checkpoint_path)):
        snap, step, extra = load_checkpoint(cfg.checkpoint_path)
        m_start = snap["m_start"]
        energies_round = snap["energies_round"]
        swap_counts = snap["swap_counts"]
        best_e = float(snap["best_e"])
        best_state = snap["best_state"]
        generator.set_state(torch.as_tensor(snap["generator"]))
        icm_moves = int(snap["icm_moves"])
        icm_flips = int(snap["icm_flips"])
        host_rng.bit_generator.state = extra["rng_state"]
        start_round = int(step)

    rounds_completed = start_round
    hit_round: Optional[int] = None
    hit_seconds: Optional[float] = None

    for round_i in range(start_round, cfg.num_swap_attempts):
        round_t0 = time.perf_counter()
        u_a, u_b, u_icm = (next(round_uniforms) if round_uniforms
                           else (None, None, None))
        flat = m_start.reshape(R * S, n)
        record = (cfg.record_last_round_m
                  and round_i == cfg.num_swap_attempts - 1)

        # --- sweeps: 1 sweep (the 'first column' state), then the rest
        res_a = engine.run(flat, generator, num_sweeps=1, beta=1.0,
                           beta_replica=beta_chain, uniforms=u_a)
        first_states = res_a.m.cpu().numpy().astype(np.float64).reshape(
            R, S, n)
        e_first = res_a.energies.cpu().numpy()[0].reshape(R, S)
        if per_swap > 1:
            res_b = engine.run(res_a.m, generator, num_sweeps=per_swap - 1,
                               beta=1.0, beta_replica=beta_chain,
                               record_m=record, uniforms=u_b)
            final_states = res_b.m.cpu().numpy().astype(np.float64).reshape(
                R, S, n)
            e_rest = res_b.energies.cpu().numpy().T.reshape(
                R, S, per_swap - 1)
            eb = res_b.e_best.cpu().numpy()
            if record:
                # [T-1, R*S, n] -> [R, S, T-1, n]
                hist_b = res_b.M.cpu().numpy().transpose(1, 0, 2).reshape(
                    R, S, per_swap - 1, n)
                M_history = np.concatenate(
                    [first_states[:, :, None, :], hist_b], axis=2)
        else:
            final_states = first_states.copy()
            e_rest = np.zeros((R, S, 0))
            eb = res_a.e_best.cpu().numpy()
            if record:
                M_history = first_states[:, :, None, :].copy()
        energies_round[:, :, 0] = e_first
        energies_round[:, :, 1:] = e_rest

        if eb.min() < best_e:
            ridx = int(eb.argmin())
            best_e = float(eb.min())
            best_state = (res_b if per_swap > 1 else res_a).m_best[
                ridx].cpu().numpy().astype(np.float64)

        # --- Houdayer move per temperature ---------------------------------
        icm_states = first_states if cfg.faithful_quirks else final_states
        touched = []
        pairings = [host_rng.permutation(S) for _ in range(R)]
        if device_icm:
            # one batched call over every (temperature, pair)
            ridx, jidx, kidx = [], [], []
            for r in range(R):
                for p in range(S // 2):
                    ridx.append(r)
                    jidx.append(int(pairings[r][2 * p]))
                    kidx.append(int(pairings[r][2 * p + 1]))
            dt = engine.dtype
            s1b = torch.as_tensor(icm_states[ridx, jidx], dtype=dt,
                                  device=device)
            s2b = torch.as_tensor(icm_states[ridx, kidx], dtype=dt,
                                  device=device)
            s1n, s2n, moved, flipped = houdayer_move_sparse(
                src, dst, s1b, s2b, generator, g=u_icm,
                num_iters=cfg.icm_label_iters,
                use_katzgraber=cfg.use_katzgraber)
            icm_states[ridx, jidx] = s1n.cpu().numpy()
            icm_states[ridx, kidx] = s2n.cpu().numpy()
            icm_moves += int(moved.sum())
            icm_flips += int(flipped.sum())
            touched = list(zip(ridx, jidx)) + list(zip(ridx, kidx))
        else:
            for r in range(R):
                shuffled = pairings[r]
                for p in range(S // 2):
                    j, k_sub = int(shuffled[2 * p]), int(shuffled[2 * p + 1])
                    s1 = icm_states[r, j].copy()
                    s2 = icm_states[r, k_sub].copy()
                    clusters = disagreement_clusters_adj(adjacency, s1, s2)
                    if not clusters:
                        continue
                    cl = clusters[int(host_rng.integers(len(clusters)))]
                    if cfg.use_katzgraber and cl.size > n // 2:
                        s1 = -s1
                        icm_flips += 1
                    else:
                        s1[cl], s2[cl] = s2[cl].copy(), s1[cl].copy()
                        icm_moves += 1
                    icm_states[r, j] = s1
                    icm_states[r, k_sub] = s2
                    touched.append((r, j))
                    touched.append((r, k_sub))

        if touched:
            idx = np.array(touched)
            new_e = np.asarray(norm_prob.energy(icm_states[idx[:, 0],
                                                           idx[:, 1]]))
            col = 0 if cfg.faithful_quirks else per_swap - 1
            energies_round[idx[:, 0], idx[:, 1], col] = new_e
            if M_history is not None:
                # the record's column gets the Houdayer-modified states
                M_history[idx[:, 0], idx[:, 1], col] = \
                    icm_states[idx[:, 0], idx[:, 1]]
            if cfg.faithful_quirks and per_swap == 1:
                # the first column IS the last: the record feeds the swaps
                final_states = icm_states

        if not cfg.faithful_quirks:
            final_states = icm_states

        m_start = final_states.copy()
        last_e = energies_round[:, :, -1].copy()

        # --- PT swaps, one Metropolis test per sub-replica per pair ---------
        selected = select_non_overlapping_pairs(
            all_pairs, cfg.num_swapping_pairs, host_rng)
        for s in range(S):
            for (sel, nxt) in selected:
                E_sel, E_nxt = last_e[sel - 1, s], last_e[nxt - 1, s]
                dB = beta_list[nxt - 1] - beta_list[sel - 1]
                if host_rng.random() < min(1.0, np.exp(dB * (E_nxt - E_sel))):
                    swap_counts[round_i] += 1
                    ab, ba = [sel - 1, nxt - 1], [nxt - 1, sel - 1]
                    m_start[ab, s] = m_start[ba, s]
                    last_e[ab, s] = last_e[ba, s]

        rounds_completed = round_i + 1
        if metrics is not None:
            metrics.swap_stats(round_index=round_i,
                               pairs=[list(p) for p in selected],
                               accepted=int(swap_counts[round_i]),
                               energies=last_e[:, 0])
            metrics.sweep_stats(phase="icm_round", num_sweeps=per_swap,
                                num_chains=R * S, num_spins=n,
                                seconds=time.perf_counter() - round_t0,
                                min_energy=best_e)
        if cfg.target_energy is not None and np.isfinite(best_e):
            slack = 1e-3 * max(abs(cfg.target_energy), 1.0)
            if best_e <= cfg.target_energy + cfg.target_atol + slack:
                e64 = float(norm_prob.energy(best_state))
                if e64 <= cfg.target_energy + cfg.target_atol:
                    hit_round = round_i
                    hit_seconds = time.perf_counter() - t_entry
                    break
        if (cfg.checkpoint_path and cfg.checkpoint_every
                and (round_i + 1) % cfg.checkpoint_every == 0):
            save_checkpoint(
                cfg.checkpoint_path,
                {"m_start": m_start, "energies_round": energies_round,
                 "swap_counts": swap_counts, "best_e": best_e,
                 "best_state": best_state,
                 "generator": generator.get_state().numpy(),
                 "icm_moves": icm_moves, "icm_flips": icm_flips},
                step=round_i + 1,
                extra={"rng_state": host_rng.bit_generator.state,
                       "beta_list": beta_list},
            )

    trace = energies_round[:, 0, :read_per_swap]
    Energy = trace.min(axis=1)
    # exact float64 energy of the best state (device energies are float32)
    best_e = float(norm_prob.energy(best_state))
    return APTICMResult(
        Energy=Energy, energy_trace=trace, final_states=m_start,
        M_history=M_history,
        min_energy=best_e, best_state=best_state, swap_counts=swap_counts,
        icm_moves=icm_moves, icm_flips=icm_flips, beta_list=beta_list,
        rounds_completed=rounds_completed,
        hit_round=hit_round, hit_seconds=hit_seconds,
    )
