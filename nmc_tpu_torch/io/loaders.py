"""Instance loaders for the reference's edge-list dialects and its
ground-truth files (host side).

Copies of the edge-list loaders and ground-truth readers of
``nmc_tpu/io/loaders.py``:
  * wishart / DCL: 0-indexed `i j J_ij`, no fields, diagonal lines skipped;
  * chimera droplet: 1-indexed, diagonal lines carry h_i;
  * contrived tree: 0-indexed, diagonal lines carry h_i.
The reference negates (J = -J, h = -h) to match the Hamiltonian sign;
`negate=True` does that here so loaders return ready-to-solve problems.
Ground truths: gs_energies.txt (`file<TAB>energy`),
groundstates_otn2d.txt (`name : energy <0/1 spins>`) and the DCL
`NN_sol.txt` metadata (`key value` lines). chimera512's MATLAB sidecars
(`JJ.mat`, `h.mat`, `ground_energies.mat`) load through scipy.io.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.problem import IsingProblem


def _parse_edge_lines(path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            yield int(float(parts[0])), int(float(parts[1])), float(parts[2])


def load_edgelist(
    path: str,
    *,
    index_base: int = 0,
    diagonal_is_field: bool = False,
    negate: bool = True,
    n: Optional[int] = None,
    name: Optional[str] = None,
) -> IsingProblem:
    """Generic edge-list -> IsingProblem."""
    edges, fields = [], {}
    max_idx = -1
    for i, j, w in _parse_edge_lines(path):
        i -= index_base
        j -= index_base
        max_idx = max(max_idx, i, j)
        if i == j:
            if diagonal_is_field:
                fields[i] = w
            continue
        edges.append((i, j, w))
    N = n if n is not None else max_idx + 1
    J = np.zeros((N, N))
    h = np.zeros(N)
    for i, j, w in edges:
        J[i, j] = w
        J[j, i] = w
    for i, w in fields.items():
        h[i] = w
    if negate:
        J = -J
        h = -h
    return IsingProblem(J, h, name=name or os.path.basename(path))


def load_wishart(path: str, negate: bool = True) -> IsingProblem:
    """0-indexed couplings-only dialect (wishart + DCL instances)."""
    return load_edgelist(path, index_base=0, diagonal_is_field=False,
                         negate=negate)


load_dcl = load_wishart


def load_chimera(path: str, negate: bool = True) -> IsingProblem:
    """1-indexed dialect with diagonal h lines (Chimera droplet instances)."""
    return load_edgelist(path, index_base=1, diagonal_is_field=True,
                         negate=negate)


def load_contrived_tree(path: str, negate: bool = True) -> IsingProblem:
    """0-indexed dialect with diagonal h lines (contrived wishart-backbone)."""
    return load_edgelist(path, index_base=0, diagonal_is_field=True,
                         negate=negate)


def read_gs_energies(path: str) -> Dict[str, float]:
    """`gs_energies.txt`: lines of `instance-file<TAB>gs_energy`."""
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out[parts[0]] = float(parts[1])
    return out


def read_otn2d_groundstates(path: str) -> Dict[str, Tuple[float, np.ndarray]]:
    """`groundstates_otn2d.txt`: `name : energy <0/1 spins...>` per line.

    Returns name -> (energy, bipolar state).
    """
    out = {}
    with open(path) as f:
        for line in f:
            m = re.match(r"\s*(\S+)\s*:\s*(-?\d+\.?\d*)\s*(.*)", line)
            if not m:
                continue
            name, e, rest = m.group(1), float(m.group(2)), m.group(3).split()
            spins = np.array([int(s) for s in rest], dtype=np.int8)
            out[name] = (e, (2 * spins - 1).astype(np.int8))
    return out


def load_chimera_mat(folder: str, rescale: bool = True) -> IsingProblem:
    """chimera512's MATLAB sidecar files `JJ.mat` (csc J) + `h.mat`: they
    hold instance 001 in the ALREADY NEGATED convention of
    load_chimera(negate=True), uniformly scaled by 1/5. With rescale=True
    (default) the couplings are multiplied back by 5 so the problem equals
    load_chimera('001.txt') exactly and its raw energies match
    `groundstates_otn2d.txt` / `ground_energies.mat`."""
    import scipy.io as sio

    J = np.asarray(sio.loadmat(os.path.join(folder, "JJ.mat"))["J"].todense(),
                   dtype=np.float64)
    h = np.asarray(sio.loadmat(os.path.join(folder, "h.mat"))["h"],
                   dtype=np.float64).ravel()
    if rescale:
        J = 5.0 * J
        h = 5.0 * h
    return IsingProblem(J, h, name="001.mat")


def read_ground_energies_mat(path: str) -> np.ndarray:
    """`ground_energies.mat`: [num_instances] raw ground-state energies in
    instance order; equals the energies in `groundstates_otn2d.txt`."""
    import scipy.io as sio

    return np.asarray(sio.loadmat(path)["ground_energies"],
                      dtype=np.float64).ravel()


def read_dcl_solution(path: str) -> Dict[str, float]:
    """`NN_sol.txt` metadata for DCL instances: whitespace-separated
    key/value lines; `min_energy` is the planted ground-state energy (raw
    units of the NN.txt edge list)."""
    out: Dict[str, float] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 2:
                try:
                    out[parts[0]] = float(parts[1])
                except ValueError:
                    out[parts[0]] = parts[1]
    return out
