"""Solution-quality evaluation against shipped ground truths.

The counterpart of ``nmc_tpu/evaluation.py``. The folder iterators are
host copies: each yields (name, problem, ground-state energy in RAW units)
for a folder of the reference's instances, which the campaign, the
`exact` command and `evaluate` run against. `evaluate_solver` runs a
solver over such a folder and reports hit rate, residual energies and
seconds (the `evaluate` command); `make_pt_solver` builds its standard
NPT solver, `npt_run` on a torch device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from .core.problem import IsingProblem
from .io.loaders import (load_chimera, load_contrived_tree, load_dcl,
                         load_wishart, read_dcl_solution, read_gs_energies,
                         read_otn2d_groundstates)


@dataclasses.dataclass
class InstanceEval:
    name: str
    gs_energy: float          # ground truth, in RAW (unnormalized) units
    found_energy: float       # best energy found, raw units
    hit: bool                 # found within tolerance of ground truth
    seconds: float
    sweeps_used: int


@dataclasses.dataclass
class EvalReport:
    instances: List[InstanceEval]

    @property
    def hit_rate(self) -> float:
        return float(np.mean([e.hit for e in self.instances]))

    @property
    def mean_residual(self) -> float:
        return float(np.mean([e.found_energy - e.gs_energy
                              for e in self.instances]))

    def summary(self) -> Dict:
        return {
            "num_instances": len(self.instances),
            "hit_rate": self.hit_rate,
            "mean_residual": self.mean_residual,
            "total_seconds": float(sum(e.seconds for e in self.instances)),
        }

    def to_json(self) -> str:
        return json.dumps({
            "summary": self.summary(),
            "instances": [dataclasses.asdict(e) for e in self.instances],
        })


def wishart_folder_instances(folder: str, limit: Optional[int] = None):
    """(name, problem, gs_energy) for a reference wishart_* folder."""
    gs = read_gs_energies(os.path.join(folder, "gs_energies.txt"))
    names = sorted(gs.keys())[:limit]
    for name in names:
        path = os.path.join(folder, name)
        if os.path.exists(path):
            yield name, load_wishart(path), gs[name]


def chimera_folder_instances(folder: str, limit: Optional[int] = None):
    """(name, problem, gs_energy) for a chimera*_spinglass_power folder."""
    gs = read_otn2d_groundstates(
        os.path.join(folder, "groundstates_otn2d.txt"))
    names = sorted(gs.keys())[:limit]
    for name in names:
        path = os.path.join(folder, name)
        if os.path.exists(path):
            yield name, load_chimera(path), gs[name][0]


def dcl_folder_instances(folder: str, limit: Optional[int] = None):
    """(name, problem, gs_energy) for a DCL C8/C16 folder (NN.txt +
    NN_sol.txt pairs, planted min_energy in the sol metadata)."""
    names = sorted(f for f in os.listdir(folder)
                   if f.endswith(".txt") and not f.endswith("_sol.txt"))
    for name in names[:limit]:
        sol = os.path.join(folder, name.replace(".txt", "_sol.txt"))
        if not os.path.exists(sol):
            continue
        meta = read_dcl_solution(sol)
        if "min_energy" not in meta:
            continue
        yield name, load_dcl(os.path.join(folder, name)), float(meta["min_energy"])


def contrived_folder_instances(folder: str, limit: Optional[int] = None,
                               best_known: Optional[str] = None):
    """(name, problem, target) for a wishart_contrived_trees folder.

    The reference ships no exact ground truths for the contrived tree
    instances; `target` comes from an optional best-known JSON file mapping
    instance name -> raw energy (default `best_known.json` in the folder),
    else NaN.
    """
    targets: Dict[str, float] = {}
    if best_known is None:
        best_known = os.path.join(folder, "best_known.json")
    if best_known and os.path.exists(best_known):
        with open(best_known) as f:
            targets = {k: float(v) for k, v in json.load(f).items()}

    def instnum(s):
        m = re.search(r"inst_(\d+)", s)
        return int(m.group(1)) if m else 0

    names = sorted((f for f in os.listdir(folder) if f.endswith(".txt")),
                   key=instnum)
    for name in names[:limit]:
        yield (name, load_contrived_tree(os.path.join(folder, name)),
               targets.get(name, float("nan")))


def evaluate_solver(
    instances,                      # iterable of (name, problem, gs_energy)
    solve: Callable[[IsingProblem], float],
    *,
    tolerance: float = 1e-6,
    sweeps_used: int = 0,
) -> EvalReport:
    """Run `solve` (returns NORMALIZED best energy; the harness rescales by
    the instance's norm factor) over instances; gs energies are raw."""
    out = []
    for name, problem, gs_energy in instances:
        norm_factor = float(np.max(np.abs(problem.J))) or 1.0
        t0 = time.perf_counter()
        e_norm = solve(problem)
        dt = time.perf_counter() - t0
        e_raw = e_norm * norm_factor
        rel_tol = max(tolerance * abs(gs_energy), 1e-9)
        out.append(InstanceEval(
            name=name, gs_energy=float(gs_energy),
            found_energy=float(e_raw),
            hit=bool(e_raw <= gs_energy + rel_tol),
            seconds=dt, sweeps_used=sweeps_used,
        ))
    return EvalReport(instances=out)


def make_pt_solver(num_replicas=24, beta_min=0.3, beta_max=8.0,
                   sweeps=40_000, swap_attempts=100, key_seed=0,
                   block_size=128, use_coloring=False,
                   nmc_coldest=0, lambda_start=3.0, tolerance=1e-8,
                   max_iterations=300, num_cycles=2, device=None,
                   **npt_kwargs):
    """A standard NPT-based solve() for evaluation runs: `npt_run` on
    `device` (default: the CUDA card) with a `torch.Generator` seeded by
    `key_seed` for every instance, as JAX's takes `PRNGKey(key_seed)`."""
    import torch

    from .device import resolve_device
    from .models.npt import NPTConfig, npt_run

    dev = resolve_device(device)

    def solve(problem: IsingProblem) -> float:
        beta_list = np.geomspace(beta_min, beta_max, num_replicas)
        doNMC = [False] * (num_replicas - nmc_coldest) + [True] * nmc_coldest
        cfg = NPTConfig(
            num_sweeps_MCMC=sweeps, num_sweeps_read=sweeps,
            num_swap_attempts=swap_attempts,
            num_swapping_pairs=max(num_replicas // 4, 1),
            num_cycles=num_cycles, record_last_round_m=False,
            block_size=block_size, use_coloring=use_coloring,
            lambda_start=lambda_start, tolerance=tolerance,
            max_iterations=max_iterations,
            **npt_kwargs,
        )
        generator = torch.Generator(device=dev).manual_seed(key_seed)
        res = npt_run(problem, beta_list, doNMC, cfg, generator, device=dev)
        return res.min_energy

    return solve
