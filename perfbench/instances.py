"""The benchmark's inputs, made from the seed: instance families, the
temperature ladder and the NMC labels.

Couplings are drawn on the run's device with a `torch.Generator` in a few
large calls, then handed to the program and to the reference alike as host
arrays (the program's engines take host instances). The families are those
of the program's generators (`chimera_graph`, `random_sk`), drawn in bulk:

  * chimera C_{m,m,t} (N = 2 t m^2): K_{t,t} cells, vertical couplings
    between left partitions, horizontal ones between right partitions,
    +-1 couplings, no fields;
  * Sherrington-Kirkpatrick: J = (G + G^T) / 2 with G ~ N(0, 1) / sqrt(n),
    zero diagonal, no fields.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass
class Inputs:
    J: np.ndarray        # [I, n, n] float64, original spin order
    h: np.ndarray        # [I, n] float64
    beta: np.ndarray     # [R] float64 ladder, warm to cold
    do_nmc: np.ndarray   # [R] bool, by temperature index
    config: Dict
    traffic: Dict


def chimera_edges(m: int, t: int) -> np.ndarray:
    """[E, 2] spin pairs of C_{m,m,t} in the generator's order."""
    def left(i, j, k):
        return ((i * m + j) * 2) * t + k

    def right(i, j, k):
        return ((i * m + j) * 2 + 1) * t + k

    edges = []
    for i in range(m):
        for j in range(m):
            edges += [(left(i, j, a), right(i, j, b))
                      for a in range(t) for b in range(t)]
            if i + 1 < m:
                edges += [(left(i, j, k), left(i + 1, j, k)) for k in range(t)]
            if j + 1 < m:
                edges += [(right(i, j, k), right(i, j + 1, k))
                          for k in range(t)]
    return np.asarray(edges, dtype=np.int64)


def chimera_family(m: int, t: int, count: int, generator) -> np.ndarray:
    e = chimera_edges(m, t)
    n = 2 * t * m * m
    signs = torch.randint(0, 2, (count, e.shape[0]), generator=generator,
                          device=generator.device)
    w = (2.0 * signs - 1.0).double().cpu().numpy()
    J = np.zeros((count, n, n))
    J[:, e[:, 0], e[:, 1]] = w
    J[:, e[:, 1], e[:, 0]] = w
    return J


def sk_family(n: int, count: int, generator) -> np.ndarray:
    G = torch.randn((count, n, n), generator=generator, dtype=torch.float64,
                    device=generator.device) / np.sqrt(n)
    G = 0.5 * (G + G.transpose(1, 2))
    G.diagonal(dim1=1, dim2=2).zero_()
    return G.cpu().numpy()


def ladder(spec: Dict, replicas: int) -> np.ndarray:
    """"geometric": beta_min .. beta_max; "two_halves": the campaign's
    ladder, a geometric warm half below 3 and a cold half from 3."""
    lo, hi = spec["beta_min"], spec["beta_max"]
    if spec["kind"] == "geometric":
        return np.geomspace(lo, hi, replicas)
    if spec["kind"] == "two_halves":
        half = replicas // 2
        return np.concatenate([np.geomspace(lo, 3.0, half, endpoint=False),
                               np.geomspace(3.0, hi, replicas - half)])
    raise ValueError(f"unknown ladder kind {spec['kind']!r}")


def data_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % 2 ** 63)


def chain_generator(seed: int, device) -> torch.Generator:
    """The generator the program's rounds draw from: a stream apart from
    the data's."""
    return torch.Generator(device=device).manual_seed((seed + 2 ** 62) % 2 ** 63)


def make_inputs(config: Dict, traffic: Dict, seed: int, device) -> Inputs:
    fam = config["instances"]
    gen = data_generator(seed, device)
    if fam["family"] == "chimera":
        J = chimera_family(fam["m"], fam["t"], fam["count"], gen)
    elif fam["family"] == "sk":
        J = sk_family(fam["n"], fam["count"], gen)
    else:
        raise ValueError(f"unknown family {fam['family']!r}")
    h = np.zeros(J.shape[:2])
    R = config["replicas"]
    k = traffic["nmc_coldest"]
    do_nmc = np.array([False] * (R - k) + [True] * k)
    return Inputs(J, h, ladder(config["ladder"], R), do_nmc, config, traffic)


def energies64(J: np.ndarray, h: np.ndarray, m: np.ndarray) -> np.ndarray:
    """E(m) = -(m J m / 2 + h m) in float64, per instance: J [I, n, n], h
    [I, n], m [I, n]."""
    m = np.asarray(m, dtype=np.float64)
    Jm = np.einsum("inj,ij->in", J, m)
    return -(0.5 * np.sum(m * Jm, axis=-1) + np.sum(m * h, axis=-1))
