"""Structured run records (JSONL), the subset the NMC driver writes.

A trimmed counterpart of ``nmc_tpu/utils/metrics.py``: `MetricsLogger`
appends one JSON record per event to an optional file and keeps them in
memory. The NMC driver logs one `sweeps` record per phase (with its wall
time) and one `clusters` record per cycle; APT logs one `apt_rung` record
per rung and NPT one `swap` and one `sweeps` record per swap round.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np

logger = logging.getLogger("nmc_tpu_torch")


def _to_jsonable(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


@dataclasses.dataclass
class MetricsLogger:
    """Append-only JSONL metrics sink + in-memory records."""

    path: Optional[str] = None
    echo: bool = False
    records: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def log(self, kind: str, **fields):
        rec = {"kind": kind, "t": time.time()}
        rec.update({k: _to_jsonable(v) for k, v in fields.items()})
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self.echo:
            logger.info("%s %s", kind, {k: v for k, v in rec.items()
                                        if k not in ("kind", "t")})
        return rec

    def of_kind(self, kind: str) -> List[Dict[str, Any]]:
        return [r for r in self.records if r["kind"] == kind]

    def sweep_stats(self, *, phase: str, num_sweeps: int, num_chains: int,
                    num_spins: int, seconds: float, min_energy: float):
        attempts = num_sweeps * num_chains * num_spins
        return self.log("sweeps", phase=phase, num_sweeps=num_sweeps,
                        num_chains=num_chains, num_spins=num_spins,
                        seconds=seconds,
                        attempts_per_sec=attempts / max(seconds, 1e-12),
                        min_energy=min_energy)

    def swap_stats(self, *, round_index: int, pairs, accepted,
                   energies=None):
        return self.log("swap", round_index=round_index, pairs=pairs,
                        accepted=accepted, energies=energies)

    def apt_rung(self, *, rung: int, beta: float, sigma_E: float,
                 seconds: float):
        return self.log("apt_rung", rung=rung, beta=beta, sigma_E=sigma_E,
                        seconds=seconds)

    def cluster_stats(self, *, cycle: int, sizes, seconds: float = 0.0):
        return self.log("clusters", cycle=cycle, sizes=sizes,
                        total=int(np.sum(sizes)) if len(sizes) else 0,
                        seconds=seconds)
