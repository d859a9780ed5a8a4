"""NPT — replica exchange with NMC on selected replicas (torch).

The counterpart of ``nmc_tpu/models/npt.py``. Per swap round every plain
replica runs Gibbs at its own beta and every NMC replica runs an NMC cycle
at `global_beta` — NOT the replica's beta, a quirk of the reference kept
here as in the JAX package — then randomly chosen non-overlapping adjacent
pairs are Metropolis-swapped one after another.

All plain replicas run as ONE sweep-engine call with a per-replica beta
vector (`beta_replica`, the streamed kernels' beta_row on large colored
layouts); all NMC replicas run as ONE batched `nmc_subroutine` call; swap
energies come from the energy traces; the state exchange and the pair
selection are a tiny host-side permutation of the replica axis.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Iterable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.problem import IsingProblem
from ..device import resolve_device
from ..ops.engine import SweepEngine
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.metrics import MetricsLogger
from .nmc import NMCConfig, nmc_subroutine


@dataclasses.dataclass
class NPTConfig:
    """Hyperparameters; names and defaults mirror the JAX package's NPTConfig."""
    num_sweeps_MCMC: int = 1000
    num_sweeps_read: int = 1000
    num_swap_attempts: int = 100
    num_swapping_pairs: int = 1
    num_cycles: int = 10
    full_update_frequency: int = 1
    M_skip: int = 1
    temp_x: float = 20.0
    global_beta: float = 2.5
    lambda_start: float = 0.5
    lambda_end: float = 0.01
    lambda_reduction_factor: float = 0.9
    threshold_initial: float = 0.999999
    threshold_cutoff: float = 0.99999
    max_iterations: int = 100
    tolerance: float = float(np.finfo(np.float64).eps)
    normalize: bool = True
    record_last_round_m: bool = True
    # execution knobs
    block_size: int = 128
    use_coloring: bool = False
    dtype: str = "float32"
    # fault tolerance / observability
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0      # snapshot every K swap rounds (0 = off)
    resume: bool = False           # restore from checkpoint_path if present
    # time to solution: with `target_energy` (NORMALIZED units) the run stops
    # once a float64 re-evaluation of the best state reaches
    # target_energy + target_atol, and NPTResult carries hit_round and
    # hit_seconds
    target_energy: Optional[float] = None
    target_atol: float = 0.0

    def derived_budgets(self):
        """Per-swap sweep budgets: (per_swap, read_per_swap, nmc_phase)."""
        per_swap = self.num_sweeps_MCMC // self.num_swap_attempts
        read_per_swap = self.num_sweeps_read // self.num_swap_attempts
        nmc_phase = int(math.ceil(
            self.num_sweeps_MCMC / self.num_swap_attempts / 3 / self.num_cycles))
        return per_swap, read_per_swap, nmc_phase


class NPTResult(NamedTuple):
    M: Optional[np.ndarray]      # [R, n, per_swap] last-round states
    Energy: np.ndarray           # [R] reference-semantics replica energies
    energy_trace: np.ndarray     # [R, read_per_swap] last-round energy traces
    min_energy: float            # best energy seen anywhere in the run
    best_state: np.ndarray       # [n] state attaining min_energy
    swap_counts: np.ndarray      # [num_swap_attempts] accepted swaps per round
    swap_attempted: np.ndarray   # [rounds*pairs, 2] 1-indexed replica pairs
    swap_accepted: np.ndarray    # [rounds*pairs, 2]
    beta_list: np.ndarray
    norm_factor: float
    rounds_completed: int = 0           # swap rounds actually executed
    hit_round: Optional[int] = None     # round index reaching target_energy
    hit_seconds: Optional[float] = None  # wall-clock to target (from entry)

    @property
    def acceptance_rate(self) -> float:
        """Fraction of rounds with >=1 accepted swap — the reference's
        reported metric, not a per-pair rate."""
        return float(np.count_nonzero(self.swap_counts) / self.swap_counts.size)


def select_non_overlapping_pairs(
    all_pairs: List[tuple], num_swapping_pairs: int, rng: np.random.Generator
) -> List[tuple]:
    """Random non-overlapping adjacent pairs, drawn one after another."""
    available = list(all_pairs)
    selected = []
    for _ in range(num_swapping_pairs):
        if not available:
            raise ValueError("Cannot find non-overlapping pairs.")
        pair = available[int(rng.integers(0, len(available)))]
        selected.append(pair)
        available = [p for p in available
                     if pair[0] not in p and pair[1] not in p]
    return selected


def _last_rows(x: np.ndarray, k: int) -> np.ndarray:
    """The last k rows of x, padded in front by repeating its first row."""
    tail = x[-k:]
    if tail.shape[0] < k:
        pad = np.repeat(tail[:1], k - tail.shape[0], axis=0)
        tail = np.concatenate([pad, tail], axis=0)
    return tail


def npt_run(
    problem: IsingProblem,
    beta_list: Sequence[float],
    doNMC: Sequence[bool],
    cfg: NPTConfig = NPTConfig(),
    generator: Optional[torch.Generator] = None,
    metrics: Optional[MetricsLogger] = None,
    device=None,
    *,
    m_init: Optional[np.ndarray] = None,
    host_rng: Optional[np.random.Generator] = None,
    uniforms: Optional[Iterable[tuple]] = None,
) -> NPTResult:
    """Replica exchange over `beta_list`; replicas with doNMC run NMC.

    `generator` (default: seed 0 on `device`) drives every draw, and seeds
    the host rng of the pair selection and the Metropolis tests. `m_init`
    ([R, n]), `host_rng` and `uniforms` (per round a pair: the plain
    replicas' [per_swap, R_mcmc, n_pad] draws and the list of the NMC
    replicas' per-phase draws, either None) replace those draws, so tests
    can replay another implementation's.
    """
    t_entry = time.perf_counter()
    if device is None and generator is not None:
        device = generator.device
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    beta_list = np.asarray(beta_list, dtype=np.float64).reshape(-1)
    R = beta_list.shape[0]
    doNMC = np.asarray(doNMC, dtype=bool).reshape(-1)
    if doNMC.shape[0] != R:
        raise ValueError("The length of doNMC does not match the number of replicas.")

    norm_prob, norm_factor = (problem.normalized() if cfg.normalize
                              else (problem, 1.0))
    n = norm_prob.n
    engine = SweepEngine(norm_prob, block_size=cfg.block_size,
                         use_coloring=cfg.use_coloring, dtype=cfg.dtype,
                         device=device)

    per_swap, read_per_swap, nmc_phase_sweeps = cfg.derived_budgets()
    if per_swap < 1:
        raise ValueError("num_sweeps_MCMC // num_swap_attempts must be >= 1")
    if read_per_swap > per_swap:
        raise ValueError(
            f"num_sweeps_read ({cfg.num_sweeps_read}) must be <= "
            f"num_sweeps_MCMC ({cfg.num_sweeps_MCMC}): the per-round energy "
            f"trace holds num_sweeps_MCMC // num_swap_attempts sweeps")

    nmc_cfg = NMCConfig(
        num_sweeps_per_NMC_phase=nmc_phase_sweeps,
        num_NMC_cycles=cfg.num_cycles,
        full_update_frequency=cfg.full_update_frequency,
        M_skip=1, temp_x=cfg.temp_x, global_beta=cfg.global_beta,
        lambda_start=cfg.lambda_start, lambda_end=cfg.lambda_end,
        lambda_reduction_factor=cfg.lambda_reduction_factor,
        threshold_initial=cfg.threshold_initial,
        threshold_cutoff=cfg.threshold_cutoff,
        max_iterations=cfg.max_iterations, tolerance=cfg.tolerance,
        clusters_once=True,   # the NPT variant: LBP once per NMC call
        normalize=False, record_m=False,
        block_size=cfg.block_size, dtype=cfg.dtype,
    )

    mcmc_idx = np.flatnonzero(~doNMC)
    nmc_idx = np.flatnonzero(doNMC)

    if m_init is None:
        m_init = engine.from_blocked(engine.init_states(generator, R))
        m_init = m_init.cpu().numpy()
    m_start = np.array(m_init, dtype=np.float64)
    if host_rng is None:
        host_rng = np.random.default_rng(int(torch.randint(
            0, 2 ** 62, (1,), generator=generator, device=generator.device)))
    round_uniforms = iter(uniforms) if uniforms is not None else None

    all_pairs = [(i, i + 1) for i in range(1, R)]
    swap_counts = np.zeros(cfg.num_swap_attempts)
    swap_attempted = np.zeros((cfg.num_swap_attempts * cfg.num_swapping_pairs, 2))
    swap_accepted = np.zeros_like(swap_attempted)
    swap_index = 0

    best_e = np.inf
    best_state = m_start[0].copy()
    last_energy = np.zeros(R)
    energy_rounds = np.zeros((R, per_swap))
    M_last = None
    start_round = 0

    if cfg.resume and cfg.checkpoint_path and os.path.exists(cfg.checkpoint_path):
        snap, step, extra = load_checkpoint(cfg.checkpoint_path)
        m_start = snap["m_start"]
        last_energy = snap["last_energy"]
        energy_rounds = snap["energy_rounds"]
        swap_counts = snap["swap_counts"]
        swap_attempted = snap["swap_attempted"]
        swap_accepted = snap["swap_accepted"]
        best_e = float(snap["best_e"])
        best_state = snap["best_state"]
        generator.set_state(torch.as_tensor(snap["generator"]))
        swap_index = int(snap["swap_index"])
        host_rng.bit_generator.state = extra["rng_state"]
        start_round = int(step)

    rounds_completed = start_round
    hit_round: Optional[int] = None
    hit_seconds: Optional[float] = None

    for round_i in range(start_round, cfg.num_swap_attempts):
        round_t0 = time.perf_counter()
        mcmc_u, nmc_u = (next(round_uniforms) if round_uniforms
                         else (None, None))
        record = cfg.record_last_round_m and round_i == cfg.num_swap_attempts - 1
        if record:
            M_last = np.zeros((R, n, per_swap))

        if mcmc_idx.size:
            res = engine.run(
                m_start[mcmc_idx], generator, num_sweeps=per_swap, beta=1.0,
                beta_replica=beta_list[mcmc_idx], record_m=record,
                uniforms=mcmc_u,
            )
            m_start[mcmc_idx] = res.m.cpu().numpy()
            e = res.energies.cpu().numpy()    # [per_swap, R_mcmc]
            energy_rounds[mcmc_idx] = e.T
            last_energy[mcmc_idx] = e[-1]
            eb = res.e_best.cpu().numpy()
            if eb.min() < best_e:
                r = int(eb.argmin())
                best_e = float(eb.min())
                best_state = res.m_best[r].cpu().numpy().astype(np.float64)
            if record:
                M_last[mcmc_idx] = np.transpose(res.M.cpu().numpy(), (1, 2, 0))

        if nmc_idx.size:
            if record:
                nmc_cfg = dataclasses.replace(nmc_cfg, record_m=True)
            sub = nmc_subroutine(engine, norm_prob, m_start[nmc_idx],
                                 generator, nmc_cfg, uniforms=nmc_u)
            m_start[nmc_idx] = sub.m_final
            e = sub.energy_overall                # [T_nmc, R_nmc]
            # the reference keeps the LAST per_swap sweeps
            energy_rounds[nmc_idx] = _last_rows(e, per_swap).T
            last_energy[nmc_idx] = e[-1]
            if sub.min_energy.min() < best_e:
                r = int(sub.min_energy.argmin())
                best_e = float(sub.min_energy.min())
                best_state = sub.m_best[r].copy()
            if record:
                # last per_swap recorded sweeps [T_rec, R_nmc, n]
                M_last[nmc_idx] = _last_rows(sub.M_overall,
                                             per_swap).transpose(1, 2, 0)

        # ---- swap attempts (host; tiny) --------------------------------
        selected = select_non_overlapping_pairs(
            all_pairs, cfg.num_swapping_pairs, host_rng)
        for (sel, nxt) in selected:  # 1-indexed, like the reference
            E_sel = last_energy[sel - 1]
            E_nxt = last_energy[nxt - 1]
            swap_attempted[swap_index] = [sel, nxt]
            dE = E_nxt - E_sel
            dB = beta_list[nxt - 1] - beta_list[sel - 1]
            if host_rng.random() < min(1.0, np.exp(dB * dE)):
                swap_counts[round_i] += 1
                swap_accepted[swap_index] = [sel, nxt]
                m_start[[sel - 1, nxt - 1]] = m_start[[nxt - 1, sel - 1]]
                last_energy[[sel - 1, nxt - 1]] = last_energy[[nxt - 1, sel - 1]]
            swap_index += 1

        rounds_completed = round_i + 1
        if cfg.target_energy is not None and np.isfinite(best_e):
            # device energies are f32; re-verify in f64 before declaring a
            # hit (slack absorbs the f32 rounding of the trigger)
            slack = 1e-3 * max(abs(cfg.target_energy), 1.0)
            if best_e <= cfg.target_energy + cfg.target_atol + slack:
                e64 = float(norm_prob.energy(best_state))
                if e64 <= cfg.target_energy + cfg.target_atol:
                    hit_round = round_i
                    hit_seconds = time.perf_counter() - t_entry
                    if metrics is not None:
                        metrics.sweep_stats(
                            phase="npt_target_hit", num_sweeps=per_swap,
                            num_chains=R, num_spins=n, seconds=hit_seconds,
                            min_energy=e64)
                    break

        if metrics is not None:
            metrics.swap_stats(round_index=round_i,
                               pairs=[list(p) for p in selected],
                               accepted=int(swap_counts[round_i]),
                               energies=last_energy)
            metrics.sweep_stats(phase="npt_round", num_sweeps=per_swap,
                                num_chains=R, num_spins=n,
                                seconds=time.perf_counter() - round_t0,
                                min_energy=best_e)
        if (cfg.checkpoint_path and cfg.checkpoint_every
                and (round_i + 1) % cfg.checkpoint_every == 0):
            save_checkpoint(
                cfg.checkpoint_path,
                {"m_start": m_start, "last_energy": last_energy,
                 "energy_rounds": energy_rounds,
                 "swap_counts": swap_counts,
                 "swap_attempted": swap_attempted,
                 "swap_accepted": swap_accepted,
                 "best_e": best_e, "best_state": best_state,
                 "generator": generator.get_state().numpy(),
                 "swap_index": swap_index},
                step=round_i + 1,
                extra={"rng_state": host_rng.bit_generator.state,
                       "beta_list": beta_list},
            )

    # Reference-semantics replica energies: min over the FIRST
    # read_per_swap sweeps of the last round (a quirk of the reference,
    # kept as in the JAX package).
    trace = energy_rounds[:, :max(read_per_swap, 1)]
    Energy = trace.min(axis=1)
    # exact float64 energy of the best state (device energies are float32)
    best_e = float(norm_prob.energy(best_state))

    return NPTResult(
        M=M_last, Energy=Energy, energy_trace=trace,
        min_energy=best_e, best_state=best_state,
        swap_counts=swap_counts, swap_attempted=swap_attempted,
        swap_accepted=swap_accepted, beta_list=beta_list,
        norm_factor=norm_factor,
        rounds_completed=rounds_completed,
        hit_round=hit_round, hit_seconds=hit_seconds,
    )
