"""One-command portfolio solver: presolve -> spectral / difference-map ->
seeded MCMC -> induced-tree refinement.

The counterpart of ``nmc_tpu/portfolio.py`` (the `solve` subcommand), with
the same knobs, stage order, stage names and "auto" rules. Stages:

1. **Presolve**: exact leaf peeling (`ops/presolve.py`); everything
   downstream runs on the 2-core and results are back-substituted.
2. **Spectral search**: eigendecomposition + sign rounding + batched
   1-flip descent + difference-map rounding in the degenerate top
   eigenspace (`ops/spectral.py`, host numpy); "auto" runs it only on
   dense cores (max degree > 16), and never on cores above
   `max_spectral_n`.
3. **Seeded MCMC**: the campaign's batched engines
   (`campaign.solve_ensemble_batch`: `EnsembleICM` / `EnsembleNMC`, on a
   coloured layout through the round kernels K4/K5) on `device`, the
   spectral candidates seeding the coldest chains, chunked with early
   stop at the target energy.
4. **Tree**: the induced-tree descent (`refine.tree_refine_state`) on the
   best state while the target is unmet; "auto" probes the chimera/DCL
   grid and skips other instances.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import List, Optional

import numpy as np

__all__ = ["SolveStage", "SolveResult", "portfolio_solve"]


@dataclasses.dataclass
class SolveStage:
    stage: str               # "presolve" | "spectral" | "mcmc:<arm>" | "tree"
    energy_raw: Optional[float]   # best raw energy after this stage
    wall_seconds: float
    hit: bool                # target reached at/by this stage
    detail: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SolveResult:
    name: str
    n: int
    energy_raw: float        # f64-verified on the ORIGINAL problem
    state: np.ndarray        # [n] +-1 f64, full (back-substituted) space
    target_raw: Optional[float]
    hit: bool
    wall_seconds: float
    stages: List[SolveStage]


def _hit(energy, target):
    if target is None or not np.isfinite(target):
        return False
    return energy <= target + max(1e-6 * abs(target), 1e-9)


def _mcmc_args(arm, sweeps, seed, presolve, dm_starts, dm_iters,
               overrides=None, device=None):
    """Campaign-arm namespace with the campaign CLI's own defaults
    (add_campaign_args is the single source of the knobs' defaults), on
    `device` (None: the CUDA card)."""
    from .campaign import add_campaign_args
    p = argparse.ArgumentParser()
    add_campaign_args(p)
    ns = p.parse_args([])
    ns.arm = arm
    ns.sweeps = int(sweeps)
    ns.seed = int(seed)
    ns.presolve = bool(presolve)
    ns.init = "spectral"
    ns.spectral_dm = int(dm_starts)
    ns.spectral_dm_iters = int(dm_iters)
    if device is not None:
        ns.device = str(device)
    for k, v in (overrides or {}).items():
        if not hasattr(ns, k):
            raise ValueError(f"unknown campaign knob {k!r}")
        setattr(ns, k, v)
    return ns


def portfolio_solve(prob, target_raw: Optional[float] = None, *,
                    name: str = "instance", arm: str = "icm",
                    sweeps: int = 200_000, seed: int = 0,
                    presolve: bool = True, spectral="auto",
                    dm_starts: int = 2048, dm_iters: int = 3000,
                    spectral_polish: int = 8, max_spectral_n: int = 4096,
                    coloring: bool = False, out_jsonl: Optional[str] = None,
                    mcmc_overrides: Optional[dict] = None,
                    tree="auto", tree_ils: float = 30.0,
                    device=None) -> SolveResult:
    """Solve one Ising instance through the staged portfolio.

    `prob`: IsingProblem in raw units. `target_raw`: optional known
    ground/target energy (raw units); stages stop early once it is
    reached, and without it the full `sweeps` budget is spent and the
    best found is returned. `arm`: MCMC arm (icm | nmc | pt | hybrid).
    `coloring`: greedy-colour the sweep (bounded-degree graphs: chimera,
    DCL; their MCMC stage runs through K4/K5). `sweeps=0` skips the MCMC
    stage. `spectral`: True | False | "auto" (dense cores only, max
    degree > 16). `tree`: True | False | "auto" (grid instances only);
    `tree_ils`: its ILS kick budget in seconds. `device`: where the MCMC
    stage runs (default: the CUDA card, which raises without one); the
    other stages are host code.
    """
    t_all = time.perf_counter()
    stages: List[SolveStage] = []

    best_e = np.inf
    best_s = None

    core = prob
    ps = None
    if presolve:
        from .core.problem import IsingProblem
        from .ops.presolve import peel_leaves
        t0 = time.perf_counter()
        ps = peel_leaves(np.asarray(prob.J, np.float64),
                         np.asarray(prob.h, np.float64))
        core = IsingProblem(ps.J_core, ps.h_core, name=name + ":core")
        stages.append(SolveStage(
            "presolve", None, time.perf_counter() - t0, False,
            dict(n=prob.n, core_n=core.n, constant=ps.constant)))

    if spectral == "auto":
        max_deg = int((np.asarray(core.J) != 0).sum(axis=1).max())
        spectral = max_deg > 16
    if spectral and core.n <= max_spectral_n:
        from .ops.spectral import spectral_search
        t0 = time.perf_counter()
        r = spectral_search(core, dm_starts=dm_starts, dm_iters=dm_iters,
                            dm_dim=None, polish=spectral_polish, seed=seed)
        s_core = np.where(np.asarray(r.best_state, np.float64) >= 0, 1., -1.)
        s_full = ps.back_substitute(s_core) if ps is not None else s_core
        e_full = float(prob.energy(s_full))      # f64, original space
        if e_full < best_e:
            best_e, best_s = e_full, s_full
        stages.append(SolveStage(
            "spectral", best_e, time.perf_counter() - t0,
            _hit(best_e, target_raw), dict(dm_starts=dm_starts)))

    if sweeps > 0 and not _hit(best_e, target_raw):
        ns = _mcmc_args(arm, sweeps, seed, presolve, dm_starts, dm_iters,
                        mcmc_overrides, device)
        spec = dict(kind="custom", coloring=bool(coloring))
        meta = dict(arm=arm, portfolio=True, seed=seed, sweeps=int(sweeps))
        t0 = time.perf_counter()
        from .campaign import solve_ensemble_batch
        path = out_jsonl
        tmp = None
        if path is None:
            fd, tmp = tempfile.mkstemp(suffix=".jsonl")
            os.close(fd)
            path = tmp
        try:
            gs = float("nan") if target_raw is None else float(target_raw)
            recs = solve_ensemble_batch([(name, prob, gs)], ns, spec, meta,
                                        path)
        finally:
            if tmp is not None and os.path.exists(tmp):
                os.remove(tmp)
        rec = recs[0]
        if rec["state"] is not None:
            e_full = float(prob.energy(rec["state"]))   # f64 re-verify
            if e_full < best_e:
                best_e, best_s = e_full, np.asarray(rec["state"], np.float64)
        stages.append(SolveStage(
            f"mcmc:{arm}", best_e, time.perf_counter() - t0,
            _hit(best_e, target_raw),
            dict(hit_sweeps=rec.get("hit_sweeps"),
                 rounds=rec.get("rounds_completed"))))

    if best_s is None:   # every search stage disabled or skipped: the
        best_s = np.ones(prob.n)      # all-up state seeds what follows
        best_e = float(prob.energy(best_s))

    if tree and not _hit(best_e, target_raw):
        # the induced-tree descent needs the chimera/DCL cell structure;
        # "auto" probes the layout and skips non-grid instances
        from .refine import tree_refine_state
        t0 = time.perf_counter()
        try:
            e_t, s_t, info = tree_refine_state(
                prob, best_s, target_raw=target_raw,
                ils_seconds=tree_ils, seed=seed)
        except ValueError:
            if tree != "auto":
                raise
        else:
            if e_t < best_e:
                best_e, best_s = e_t, s_t
            stages.append(SolveStage(
                "tree", best_e, time.perf_counter() - t0,
                _hit(best_e, target_raw),
                dict(moves=info["moves"], ils_iters=info["ils_iters"])))

    return SolveResult(
        name=name, n=prob.n, energy_raw=best_e, state=best_s,
        target_raw=None if target_raw is None else float(target_raw),
        hit=_hit(best_e, target_raw),
        wall_seconds=time.perf_counter() - t_all, stages=stages)
