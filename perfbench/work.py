"""The work a round does, counted from the cell's shapes, and the least
time the chip could take for it.

An attempt is one spin visited by one sweep of one chain of one instance:
instances x chains x spins x sweeps a round, over the real spins (padding
excluded) and every phase of the round. An instance holds replicas x
subreplicas chains: `subreplicas` (default 1) is the configuration's
count of independent chains at each temperature, as in EnsembleICM. The
bound model (PERF.md): per attempt one Philox-4x32-10 and its draw, 110 operations;
per spin and sweep 3 operations for the energy; against every input and
output byte once (couplings as the nonzero entries of J, 4 bytes each; the
states in, the states and bests out, 4 bytes a spin, and the backbone
masks, 1 byte a spin). The per-flip phi update is left out because it
depends on the data, so a share of this bound is a floor.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

OPS_PER_ATTEMPT = 110
OPS_PER_SPIN_SWEEP = 3
HERE = os.path.dirname(os.path.abspath(__file__))


def sweeps_per_round(config: Dict) -> int:
    if "sweeps_per_round" in config:
        return config["sweeps_per_round"]
    c, f = config["num_cycles"], config["full_update_frequency"]
    phases = sum(3 if cycle % f == 0 else 2 for cycle in range(c))
    return phases * config["sweeps_per_phase"]


def round_work(config: Dict, J: np.ndarray, world: int = 1) -> Dict:
    """One rank's work a round: attempts, operations and bytes. J [I, n, n]
    is the family; a rank holds 1 / world of its chains (of one instance)
    or of its instances."""
    I, n = J.shape[0], J.shape[-1]
    chains = config["replicas"] * config.get("subreplicas", 1)
    if I == 1:
        chains //= world
    else:
        I //= world
    T = sweeps_per_round(config)
    visits = I * chains * n * T
    nnz = int(np.count_nonzero(np.any(J != 0, axis=0)))
    return dict(attempts=visits,
                ops=visits * (OPS_PER_ATTEMPT + OPS_PER_SPIN_SWEEP),
                bytes=4 * I * nnz + 4 * I * n + I * chains * n * (4 + 1 + 4 + 4))


def load_peaks(kind: str) -> Optional[Dict]:
    """The peaks of the card named `kind` (torch.cuda.get_device_name), or
    None when the table has no entry for it."""
    with open(os.path.join(HERE, "peaks.json")) as f:
        table = json.load(f)
    return next((p for p in table.values() if p["match"] in kind), None)


def bound_seconds(work: Dict, peaks: Dict) -> float:
    return max(work["ops"] / peaks["f32_flops"],
               work["bytes"] / peaks["hbm_bytes_per_s"])
