"""The output check: the numbers compared with the reference, and `correct`.

What the timed path produced is held against the plain reference in two
ways:

  * states: the program's initial state against the reference's own from
    the same generator state; the program's state after its first round
    against the reference's round from that start; and the program's
    states after two consecutive rounds of the window (the first a
    backbone refresh where the traffic has NMC labels) against the
    reference's rounds from the program's state before them, drawing from
    the generator at the same point. Each compared state gives chain
    states and best states (`spin_diff`), temperature labels
    (`label_diff`), best energies and, on several ranks, the gathered
    carried energies (`energy_gap`), and backbone masks (`mask_diff`).
  * answers: every best the window's periodic best calls returned,
    energy against the float64 energy of its state (`best_gap`).

Shares are (differing, compared) counts, so ranks add them; gaps are the
largest relative gap |a - b| / max(1, |b|). A check file per cell
(`checks/<workload>.json`) holds each number's limit and the readings it
was set from.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List

import numpy as np
import torch

from .instances import energies64

HERE = os.path.dirname(os.path.abspath(__file__))
SHARES = ("spin_diff", "label_diff", "mask_diff")
GAPS = ("energy_gap", "best_gap")


def empty_tally() -> Dict:
    t = {k: [0, 0] for k in SHARES}
    t.update({k: 0.0 for k in GAPS})
    return t


def _share(t, key, a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b).to(a.device)
    t[key][0] += int((a != b).sum())
    t[key][1] += a.numel()


def _gap(a, b) -> float:
    a = torch.as_tensor(a, dtype=torch.float64)
    b = torch.as_tensor(b, dtype=torch.float64).to(a.device)
    if a.shape != b.shape:
        return float("inf")
    fin = torch.isfinite(b)
    if not bool((torch.isfinite(a) == fin).all()):
        return float("inf")
    if not bool(fin.any()):
        return 0.0
    d = (a[fin] - b[fin]).abs() / b[fin].abs().clamp(min=1.0)
    return float(d.max())


def compare_state(t: Dict, prog: Dict, ref: Dict) -> None:
    """Add one compared state (program export against reference) to the
    tally. The labels are compared where the state has them."""
    _share(t, "spin_diff", prog["m"], ref["m"])
    _share(t, "spin_diff", prog["m_best"], ref["m_best"])
    if "beta_to_slot" in ref and "round_index" in ref and ref["round_index"]:
        _share(t, "label_diff", prog["beta_to_slot"], ref["beta_to_slot"])
    if "cl" in ref and ref.get("refreshed"):
        _share(t, "mask_diff", prog["cl"], ref["cl"])
    t["energy_gap"] = max(t["energy_gap"], _gap(prog["e_best"], ref["e_best"]))
    if "slot_energies" in ref and "slot_energies" in prog:
        t["energy_gap"] = max(t["energy_gap"], _gap(prog["slot_energies"],
                                                     ref["slot_energies"]))


def best_gap(t: Dict, J: np.ndarray, h: np.ndarray, energies, states) -> None:
    """Each best answer's energy against the float64 energy of its state:
    energies [I], states [I, n] in the original spin order."""
    states = np.asarray(states)
    if J.shape[0] == 1 < states.shape[0]:
        J = np.broadcast_to(J, (states.shape[0],) + J.shape[1:])
        h = np.broadcast_to(h, (states.shape[0],) + h.shape[1:])
    e64 = energies64(J, h, states)
    e = np.asarray(energies, dtype=np.float64)
    gap = np.abs(e - e64) / np.maximum(np.abs(e64), 1.0)
    t["best_gap"] = max(t["best_gap"], float(np.max(gap)) if gap.size else 0.0)


def merge(tallies: List[Dict]) -> Dict:
    out = empty_tally()
    for t in tallies:
        for k in SHARES:
            out[k][0] += t[k][0]
            out[k][1] += t[k][1]
        for k in GAPS:
            out[k] = max(out[k], t[k])
    return out


def numbers(t: Dict) -> Dict[str, float]:
    """The compared numbers of a tally; a share that compared nothing is
    left out."""
    out = {k: t[k][0] / t[k][1] for k in SHARES if t[k][1]}
    out.update({k: t[k] for k in GAPS})
    return out


def load_check(workload: str, root: str = HERE) -> Dict:
    """checks/<workload>.json: "limits" (each number's limit and the
    readings it was set from) and "replayed", the window rounds the check
    follows (2 unless it says otherwise)."""
    with open(os.path.join(root, "checks", f"{workload}.json")) as f:
        return json.load(f)


def load_limits(workload: str, root: str = HERE) -> Dict[str, float]:
    return {k: v["limit"] for k, v in load_check(workload, root)["limits"].items()}


def control_precision(workload: str, root: str = HERE) -> str:
    """The precision of the cell's control: the first word of its limits'
    "upper_from", which every limit of the cell has to share."""
    words = {re.split(r"[\s,]", v["upper_from"], maxsplit=1)[0]
             for v in load_check(workload, root)["limits"].values()}
    if len(words) != 1:
        raise ValueError(f"checks/{workload}.json names the controls "
                         f"{sorted(words)}; a cell has one")
    return words.pop()


def verdict(nums: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit, or a limit without its number, fails."""
    checks = {k: {"value": nums.get(k, float("nan")),
                  "limit": limits.get(k, float("nan"))}
              for k in sorted(set(nums) | set(limits))}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
