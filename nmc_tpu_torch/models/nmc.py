"""NMC — Nonlocal Monte Carlo driver (torch).

The counterpart of ``nmc_tpu/models/nmc.py``: an annealed Gibbs warm-up
finds a good state m*, then cycles of
  (C)  heated-cluster sweeps  — backbone spins sample at beta/temp_x,
       everything else frozen,
  (NC) non-cluster sweeps     — backbone frozen, rest at beta,
  (ALL) full sweeps every `full_update_frequency` cycles,
with backbone clusters extracted from lambda-annealed convexified LBP
marginals. After each phase the chain restarts from its argmin-energy sweep.
Phases are mask/beta parametrizations of one sweep engine call, so on a
colored layout every phase runs the colored sweep kernel.

Both cluster policies are supported: recompute LBP every cycle, or once up
front via `clusters_once`. LBP runs on dense [N, N] messages up to
`sparse_lbp_threshold` spins and on directed-edge messages above it
(ops/lbp_sparse.py), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, List, NamedTuple, Optional

import numpy as np
import torch

from ..core.problem import IsingProblem
from ..device import resolve_device
from ..ops.clusters import cluster_mask, find_clusters, flatten_clusters
from ..ops.engine import SweepEngine
from ..ops.lbp import (convexification_epsilon, lbp_convexified,
                       lbp_convexified_batch)
from ..ops.lbp_sparse import (EdgeGraph, sparse_lbp_convexified,
                              sparse_lbp_convexified_batch)
from ..utils.metrics import MetricsLogger


@dataclasses.dataclass
class NMCConfig:
    """Hyperparameters; names and defaults mirror the JAX package's NMCConfig."""
    num_sweeps_initial: int = 10_000
    num_sweeps_per_NMC_phase: int = 10_000
    num_NMC_cycles: int = 10
    full_update_frequency: int = 1
    M_skip: int = 1
    temp_x: float = 20.0
    global_beta: float = 2.5
    lambda_start: float = 0.5
    lambda_end: float = 0.01
    lambda_reduction_factor: float = 0.9
    threshold_initial: float = 0.999999
    threshold_cutoff: float = 0.99999
    threshold_step: float = 0.01
    max_iterations: int = 100
    tolerance: float = float(np.finfo(np.float64).eps)
    clusters_once: bool = False           # False = recompute LBP every cycle
    sparse_lbp_threshold: int = 2048      # above this N, LBP runs on edge
                                          # messages (ops/lbp_sparse) instead
                                          # of dense [N,N] message matrices
    normalize: bool = True
    record_m: bool = True
    # execution knobs
    num_chains: int = 1
    block_size: int = 128
    use_coloring: bool = False
    dtype: str = "float32"


class NMCResult(NamedTuple):
    M_overall: Optional[np.ndarray]   # [T_rec, R, n] recorded states (M_skip applied)
    energy_overall: np.ndarray        # [T_total, R] per-sweep energies (full res)
    min_energy: np.ndarray            # [R]
    m_best: np.ndarray                # [R, n]
    m_final: np.ndarray               # [R, n] state after the last phase's last sweep
    all_clusters: np.ndarray          # flat cluster indices from the last extraction
    phase_labels: List[str]           # one label per phase segment ('C'/'NC'/'ALL')
    phase_lengths: List[int]          # sweeps per segment
    norm_factor: float


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def _ladder(cfg: NMCConfig) -> dict:
    return dict(lambda_start=cfg.lambda_start, lambda_end=cfg.lambda_end,
                lambda_reduction_factor=cfg.lambda_reduction_factor,
                tolerance=cfg.tolerance, max_iterations=cfg.max_iterations)


def _clusters_from_beliefs(problem, beliefs, cfg) -> list:
    # threshold a float64 reconstruction of the marginal: the reference
    # discriminates 7-nines thresholds on f64 marginals, but an f32 device
    # tanh saturates to 1.0 — tanh in f64 of the pre-tanh belief restores
    # the discrimination band
    marginals = np.tanh(cfg.global_beta * np.asarray(beliefs, np.float64))
    return [flatten_clusters(find_clusters(
        problem.J, m, cfg.threshold_initial, cfg.threshold_cutoff,
        cfg.threshold_step)) for m in marginals.reshape(-1, problem.n)]


def _extract_clusters(problem: IsingProblem, m_star: np.ndarray,
                      cfg: NMCConfig, device, dtype) -> np.ndarray:
    """Convexified LBP -> backbone clusters -> flat index array, one chain.

    Large instances (N > cfg.sparse_lbp_threshold) use edge-message LBP
    (O(nnz) per iteration) instead of dense [N, N] message matrices."""
    eps = convexification_epsilon(problem.J, problem.h)
    h = torch.as_tensor(problem.h, dtype=dtype, device=device)
    if problem.n > cfg.sparse_lbp_threshold:
        _, belief = sparse_lbp_convexified(
            EdgeGraph.from_dense(problem.J), h, cfg.global_beta, m_star, eps,
            return_belief=True, **_ladder(cfg))
    else:
        belief = lbp_convexified(
            torch.as_tensor(problem.J, dtype=dtype, device=device), h,
            cfg.global_beta, m_star, eps, **_ladder(cfg)).belief
    return _clusters_from_beliefs(problem, belief, cfg)[0]


def _per_chain_clusters(problem, m_star, cfg, device=None,
                        dtype=torch.float64) -> list:
    """Clusters per chain (list of flat index arrays, length R).

    The lambda-annealed LBP runs batched over chains (one call per rung),
    on dense or edge messages by `sparse_lbp_threshold`; the irregular
    threshold/growth pass stays on the host per chain.
    """
    device = resolve_device(device)
    R = m_star.shape[0]
    if R == 1:
        return [_extract_clusters(problem, m_star[0], cfg, device, dtype)]
    eps = convexification_epsilon(problem.J, problem.h)
    h = torch.as_tensor(problem.h, dtype=dtype, device=device)
    m_star = np.asarray(m_star, dtype=np.float64)
    if problem.n > cfg.sparse_lbp_threshold:
        _, beliefs = sparse_lbp_convexified_batch(
            EdgeGraph.from_dense(problem.J), h, cfg.global_beta, m_star, eps,
            return_belief=True, **_ladder(cfg))
    else:
        _, beliefs = lbp_convexified_batch(
            torch.as_tensor(problem.J, dtype=dtype, device=device), h,
            cfg.global_beta, m_star, eps, return_belief=True, **_ladder(cfg))
    return _clusters_from_beliefs(problem, beliefs, cfg)


def _stack_masks(n, R, all_clusters) -> np.ndarray:
    if isinstance(all_clusters, list):
        return np.stack([cluster_mask(n, c) for c in all_clusters])
    return np.broadcast_to(cluster_mask(n, np.asarray(all_clusters)), (R, n)).copy()


def nmc_subroutine(
    engine: SweepEngine,
    problem: IsingProblem,       # normalized problem (engine built on it)
    m_star: np.ndarray,          # [R, n] current best states
    generator: Optional[torch.Generator],
    cfg: NMCConfig,
    all_clusters: Optional[np.ndarray] = None,
    metrics: Optional[MetricsLogger] = None,
    uniforms: Optional[Iterable[torch.Tensor]] = None,
) -> NMCResult:
    """The 3-phase NMC cycle loop.

    `uniforms`, when given, supplies each phase's injected draws
    [T, R, n_pad] in run order (C, NC, ALL per cycle) in place of
    `generator`; tests use it to replay another implementation's draws.
    """
    n = problem.n
    R = m_star.shape[0]
    clusters_provided = all_clusters is not None
    m_init = np.asarray(m_star, dtype=np.float64).reshape(R, n)
    m_star = m_init.copy()
    phase_uniforms = iter(uniforms) if uniforms is not None else None

    energy_segs, m_segs = [], []
    phase_labels: List[str] = []
    phase_lengths: List[int] = []
    best_m = m_init.copy()
    best_e = np.full(R, np.inf)
    m_final = m_init.copy()

    def run_phase(m_from, label, beta_spin=None, update_mask=None):
        nonlocal m_final
        t0 = time.perf_counter()
        res = engine.run(
            m_from, generator, num_sweeps=cfg.num_sweeps_per_NMC_phase,
            beta=cfg.global_beta, beta_spin=beta_spin, update_mask=update_mask,
            record_m=cfg.record_m,
            uniforms=next(phase_uniforms) if phase_uniforms else None,
        )
        e = _to_numpy(res.energies)             # [T, R]; waits for the device
        seconds = time.perf_counter() - t0
        energy_segs.append(e)
        if cfg.record_m:
            m_segs.append(_to_numpy(res.M)[::cfg.M_skip])
        phase_labels.append(label)
        phase_lengths.append(cfg.num_sweeps_per_NMC_phase)
        m_final = _to_numpy(res.m)
        mb, eb = _to_numpy(res.m_best), _to_numpy(res.e_best)
        improved = eb < best_e
        best_m[improved] = mb[improved]
        best_e[improved] = eb[improved]
        if metrics is not None:
            metrics.sweep_stats(phase=label,
                                num_sweeps=cfg.num_sweeps_per_NMC_phase,
                                num_chains=R, num_spins=n, seconds=seconds,
                                min_energy=float(eb.min()))
        return mb  # argmin-of-phase restart state

    def clusters_now():
        t0 = time.perf_counter()
        out = _per_chain_clusters(problem, m_star, cfg, engine.device,
                                  engine.dtype)
        return out, time.perf_counter() - t0

    lbp_seconds = 0.0
    if clusters_provided or cfg.clusters_once:
        if not clusters_provided:
            all_clusters, lbp_seconds = clusters_now()
        cl_mask = _stack_masks(n, R, all_clusters)

    for cycle in range(cfg.num_NMC_cycles):
        if not (clusters_provided or cfg.clusters_once):
            all_clusters, lbp_seconds = clusters_now()
            cl_mask = _stack_masks(n, R, all_clusters)
        if metrics is not None:
            metrics.cluster_stats(
                cycle=cycle,
                sizes=[int(c.size) for c in all_clusters]
                if isinstance(all_clusters, list)
                else [int(np.asarray(all_clusters).size)],
                seconds=lbp_seconds)
            lbp_seconds = 0.0

        # (C) heated clusters, frozen non-clusters
        beta_spin = np.where(cl_mask, 1.0 / cfg.temp_x, 1.0)
        m_init = run_phase(m_init, "C", beta_spin=beta_spin,
                           update_mask=cl_mask)

        # (NC) frozen clusters, normal temperature elsewhere
        m_init = run_phase(m_init, "NC", update_mask=~cl_mask)

        # (ALL) full update
        if cycle % cfg.full_update_frequency == 0:
            m_init = run_phase(m_init, "ALL")
            m_star = np.asarray(m_init, dtype=np.float64).copy()

    energy_overall = np.concatenate(energy_segs, axis=0)
    M_overall = np.concatenate(m_segs, axis=0) if cfg.record_m else None
    # exact float64 energies of the best states (device energies are f32)
    best_e = np.asarray(problem.energy(best_m))
    flat_last = (all_clusters[0] if isinstance(all_clusters, list)
                 else np.asarray(all_clusters))
    return NMCResult(
        M_overall=M_overall,
        energy_overall=energy_overall,
        min_energy=best_e,
        m_best=best_m,
        m_final=m_final,
        all_clusters=flat_last,
        phase_labels=phase_labels,
        phase_lengths=phase_lengths,
        norm_factor=1.0,
    )


def nmc_run(
    problem: IsingProblem,
    cfg: NMCConfig = NMCConfig(),
    generator: Optional[torch.Generator] = None,
    metrics: Optional[MetricsLogger] = None,
    device=None,
) -> NMCResult:
    """Full NMC solve: normalize, annealed warm-up to find m*, then the NMC
    cycle loop. `generator` (default: seed 0 on `device`) drives every draw."""
    if device is None and generator is not None:
        device = generator.device
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    norm_prob, norm_factor = (problem.normalized() if cfg.normalize
                              else (problem, 1.0))
    engine = SweepEngine(norm_prob, block_size=cfg.block_size,
                         use_coloring=cfg.use_coloring, dtype=cfg.dtype,
                         device=device)
    m0 = engine.from_blocked(engine.init_states(generator, cfg.num_chains))

    t0 = time.perf_counter()
    warm = engine.run(m0, generator, num_sweeps=cfg.num_sweeps_initial,
                      beta=cfg.global_beta, anneal=True, sweeps_per_beta=1,
                      initial_beta=0.0)
    m_star = _to_numpy(warm.m_best)
    if metrics is not None:
        metrics.sweep_stats(phase="warmup", num_sweeps=cfg.num_sweeps_initial,
                            num_chains=cfg.num_chains, num_spins=problem.n,
                            seconds=time.perf_counter() - t0,
                            min_energy=float(_to_numpy(warm.e_best).min()))
    res = nmc_subroutine(engine, norm_prob, m_star, generator, cfg,
                         metrics=metrics)
    return res._replace(norm_factor=norm_factor)
