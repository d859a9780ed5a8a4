"""Benchmark folders with their shipped ground truths (host side).

Copies of the folder iterators of ``nmc_tpu/evaluation.py``: each yields
(name, problem, ground-state energy in RAW units) for a folder of the
reference's instances, which the campaign and the `exact` command run
against.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional

from .io.loaders import (load_chimera, load_contrived_tree, load_dcl,
                         load_wishart, read_dcl_solution, read_gs_energies,
                         read_otn2d_groundstates)


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
