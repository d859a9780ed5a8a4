"""Spectral ground-state search for planted / low-rank-structured Ising
instances.

Wishart-planted ensembles have a golf-course landscape: every 1-flip-stable
state a random start descends into sits ~1.5 % above the planted state,
which local moves cannot see. Because W's columns are orthogonal to the
planted state t, t lies in the top eigenspace of J, so sign-rounding
eigenvectors of J and greedy-descending recovers it almost always.

* host search (copies of ``nmc_tpu/ops/spectral.py``, numpy f64, held
  array-equal to the originals by the tests): `greedy_descent`,
  `two_flip_descent`, `batched_descent_host`, `auto_subspace_dim`,
  `difference_map_rounding`, `spectral_candidates`, `spectral_search`.
  They draw from `np.random.default_rng(seed)`, so the same seed gives the
  JAX package's arrays. `solve`, the campaign and the enumeration tier run
  these.
* device search in torch, on an explicit device: `batched_descent_device`
  (steepest 1-flip steps on [C, n], one convergence read every few steps),
  `difference_map_rounding_device` and `spectral_candidates_device`
  (`torch.linalg.eigh`). f32 on CUDA (TF32 stays off, `device.py`): the
  descent only needs the signs of dE; re-verify winners in f64 on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device, resolve_dtype


# ----------------------------------------------------------------------
# Host (numpy, f64) implementation
# ----------------------------------------------------------------------

def greedy_descent(J: np.ndarray, s: np.ndarray,
                   h: Optional[np.ndarray] = None,
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Steepest 1-flip descent to a local minimum of
    E = -(1/2) s'Js - h's.  Returns (state, local field J s + h)."""
    s = np.array(s, dtype=np.float64, copy=True)
    f = J @ s if h is None else J @ s + h
    while True:
        dE = 2.0 * s * f            # flip i: E -> E + 2 s_i f_i
        i = int(np.argmin(dE))
        if dE[i] >= -1e-12:
            return s, f
        s[i] = -s[i]
        f = f + 2.0 * s[i] * J[:, i]


def two_flip_descent(J: np.ndarray, s: np.ndarray,
                     h: Optional[np.ndarray] = None,
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Steepest 2-flip descent (each accepted pair is followed by 1-flip
    descent to stability).  O(n^2) per step: host polish for the
    candidates the 1-flip descent leaves near the target."""
    s, f = greedy_descent(J, s, h)
    n = s.shape[0]
    while True:
        d1 = 2.0 * s * f
        # flip {i, j}: dE = d1_i + d1_j - 4 J_ij s_i s_j
        M = d1[:, None] + d1[None, :] - 4.0 * J * np.outer(s, s)
        np.fill_diagonal(M, np.inf)
        i, j = np.unravel_index(int(np.argmin(M)), (n, n))
        if M[i, j] >= -1e-12:
            return s, f
        s[i] = -s[i]
        f = f + 2.0 * s[i] * J[:, i]
        s[j] = -s[j]
        f = f + 2.0 * s[j] * J[:, j]
        s, f = greedy_descent(J, s, h)


def _energy(J, h, s):
    return float(-(0.5 * s @ (J @ s) + (0.0 if h is None else h @ s)))


def batched_descent_host(J: np.ndarray, S: np.ndarray,
                         h: Optional[np.ndarray] = None) -> np.ndarray:
    """Vectorized greedy 1-flip descent of a batch [C, n]: every iteration
    flips the steepest improving spin of each not-yet-stable candidate,
    fields updated with one gathered-row rank-1 step."""
    S = np.array(S, dtype=np.float64)
    C, n = S.shape
    F = S @ J if h is None else S @ J + h[None, :]
    rows = np.arange(C)
    alive = np.ones(C, dtype=bool)
    while alive.any():
        dE = 2.0 * S * F
        i = np.argmin(dE, axis=1)
        improving = dE[rows, i] < -1e-12
        alive = alive & improving
        if not alive.any():
            break
        a = np.flatnonzero(alive)
        ia = i[a]
        S[a, ia] = -S[a, ia]
        F[a] += 2.0 * S[a, ia][:, None] * J[ia, :]
    return S


def auto_subspace_dim(w: np.ndarray, *, min_top_frac: float = 0.25) -> int:
    """Estimate the degenerate top-eigenspace dimension of a planted
    instance from its (ascending) eigenvalue spectrum: the largest gap in
    the lower part of the spectrum separates the M strongly-negative
    W'W directions from the near-degenerate null-space bulk.  Keeps at
    least `min_top_frac` of the spectrum on top."""
    w = np.asarray(w, dtype=np.float64)
    n = w.shape[0]
    gaps = np.diff(w)
    lo, hi = 0, n - max(2, int(n * min_top_frac))
    if hi <= lo:
        return max(2, n // 2)
    k = int(np.argmax(gaps[lo:hi])) + lo   # gap between w[k] and w[k+1]
    return n - k - 1                       # bottom group = indices 0..k


def difference_map_rounding(V: np.ndarray, *, num_starts: int = 512,
                            iters: int = 500, beta: float = 0.9,
                            snapshot_every: int = 20,
                            seed: int = 0) -> np.ndarray:
    """Difference-map (Douglas-Rachford-style) search for +-1 vectors
    near the column span of the orthonormal basis `V` [n, d]:

        PA(x) = V V' x            (projection onto the subspace)
        PB(y) = sign(y)           (projection onto the hypercube)
        x    <- x + beta * (PB(2 PA(x) - x) - PA(x))

    When the planted state is only NEAR the subspace (float-coupling
    Wishart instances, where no exact fixed point exists), the iterate
    orbits the near-intersection; the pooled snapshots of sign(PA(x))
    taken every `snapshot_every` steps pass through the planted basin.
    Returns the unique pooled +-1 snapshots [C', n]: descend them on the
    true J and keep the minimum."""
    n = V.shape[0]
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(num_starts, n))
    outs = []
    for it in range(iters):
        PA = (X @ V) @ V.T
        RB = np.sign(2.0 * PA - X)
        RB[RB == 0] = 1.0
        X = X + beta * (RB - PA)
        if it % snapshot_every == snapshot_every - 1:
            c = np.sign((X @ V) @ V.T)
            c[c == 0] = 1.0
            outs.append(c)
    if not outs:
        c = np.sign((X @ V) @ V.T)
        c[c == 0] = 1.0
        outs.append(c)
    return np.unique(np.concatenate(outs, axis=0), axis=0)


def spectral_candidates(J: np.ndarray, h: Optional[np.ndarray] = None,
                        *, top_k: Optional[int] = None,
                        num_subspace: int = 0,
                        subspace_dim: Optional[int] = None,
                        dm_starts: int = 0, dm_iters: int = 500,
                        dm_beta: float = 0.9, dm_dim: Optional[int] = None,
                        seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Sign-rounded eigenvectors of J (both signs when h breaks the Z2
    symmetry), greedy-descended in one batch, plus `num_subspace` rounded
    random samples from the top-`subspace_dim` eigenspace.  `top_k`
    restricts to the eigenvectors of the top_k LARGEST eigenvalues; None =
    all n.  `dm_starts > 0` adds the pooled `difference_map_rounding`
    snapshots from that many random starts in the top-`dm_dim` eigenspace
    (`dm_dim=None` = the `auto_subspace_dim` spectral-gap estimate).
    Returns (states [C, n], energies [C]) sorted ascending by energy."""
    J = np.asarray(J, dtype=np.float64)
    n = J.shape[0]
    w, v = np.linalg.eigh(J)
    vt = v.T[::-1]                       # rows = eigenvectors, top first
    if top_k is not None:
        vt = vt[:top_k]
    raw = [vt]
    if h is not None and np.any(h):
        raw.append(-vt)
    if num_subspace > 0:
        dim = subspace_dim if subspace_dim is not None else max(1, n // 2)
        V = v[:, n - dim:]
        rng = np.random.default_rng(seed)
        raw.append((V @ rng.normal(size=(dim, num_subspace))).T)
    X = np.concatenate(raw, axis=0)
    S = np.sign(X)
    S[S == 0] = 1.0
    if dm_starts > 0:
        d = int(dm_dim) if dm_dim else auto_subspace_dim(w)
        d = max(2, min(d, n - 1))
        S = np.concatenate([S, difference_map_rounding(
            v[:, n - d:], num_starts=dm_starts, iters=dm_iters,
            beta=dm_beta, seed=seed)], axis=0)
    S = batched_descent_host(J, S, h)
    energies = -(0.5 * np.einsum("cn,cn->c", S, S @ J)
                 + (S @ h if h is not None else 0.0))
    order = np.argsort(energies, kind="stable")
    return S[order], energies[order]


@dataclasses.dataclass
class SpectralResult:
    best_state: np.ndarray   # [n] +-1, f64
    best_energy: float
    states: np.ndarray       # [C, n] candidates, ascending energy
    energies: np.ndarray     # [C]


def spectral_search(prob, *, top_k: Optional[int] = None,
                    num_subspace: int = 0,
                    subspace_dim: Optional[int] = None,
                    dm_starts: int = 0, dm_iters: int = 500,
                    dm_beta: float = 0.9, dm_dim: Optional[int] = None,
                    polish: int = 0, seed: int = 0) -> SpectralResult:
    """Full host search on an `IsingProblem`: spectral candidates
    (+ optional difference-map pool, see `difference_map_rounding`), then
    an optional 2-flip polish of the `polish` lowest-energy candidates."""
    states, energies = spectral_candidates(
        prob.J, prob.h if np.any(prob.h) else None, top_k=top_k,
        num_subspace=num_subspace, subspace_dim=subspace_dim,
        dm_starts=dm_starts, dm_iters=dm_iters, dm_beta=dm_beta,
        dm_dim=dm_dim, seed=seed)
    h = prob.h if np.any(prob.h) else None
    if polish > 0:
        for c in range(min(polish, states.shape[0])):
            s, _ = two_flip_descent(prob.J, states[c], h)
            e = _energy(prob.J, h, s)
            if e < energies[c] - 1e-12:
                states[c], energies[c] = s, e
        order = np.argsort(energies, kind="stable")
        states, energies = states[order], energies[order]
    return SpectralResult(states[0], float(energies[0]), states, energies)


# ----------------------------------------------------------------------
# Device (torch) implementation
# ----------------------------------------------------------------------

def _signs(x: torch.Tensor) -> torch.Tensor:
    """+-1 rounding with sign(0) -> +1 (torch.sign(0) is 0)."""
    return torch.sign(x) + (x == 0).to(x.dtype)


# steps of `batched_descent_device` between two reads of its done flags
_CHECK_EVERY = 16


def batched_descent_device(J: torch.Tensor, S: torch.Tensor,
                           h: Optional[torch.Tensor] = None,
                           *, max_iters: Optional[int] = None
                           ) -> torch.Tensor:
    """Greedy 1-flip descent of a batch of states [C, n] (on S's device,
    in S's dtype) to 1-flip stability. Each step flips the steepest spin
    of every not-yet-stable candidate (dE < -1e-6; ties go to the first
    index, as jnp.argmin) and updates the fields with the gathered row of
    J. A candidate whose step flips nothing is done for good. The host
    reads the done flags once every `_CHECK_EVERY` steps; the steps past
    the last candidate's end change nothing. At most `max_iters` steps
    (default 8n), as the JAX package's while_loop."""
    C, n = S.shape
    dt = S.dtype
    Jd = J.to(dt)
    hv = torch.zeros(n, dtype=dt, device=S.device) if h is None else h.to(dt)
    max_iters = int(max_iters if max_iters is not None else 8 * n)
    rows = torch.arange(C, device=S.device)
    S = S.clone()
    F = S @ Jd + hv[None, :]
    done = torch.zeros(C, dtype=torch.bool, device=S.device)
    it = 0
    while it < max_iters:
        steps = min(_CHECK_EVERY, max_iters - it)
        for _ in range(steps):
            dE = 2.0 * S * F
            i = torch.argmin(dE, dim=1)
            best = dE[rows, i]
            flip = (best < -1e-6) & ~done
            S[rows, i] = torch.where(flip, -S[rows, i], S[rows, i])
            s_new_i = S[rows, i]
            F = F + 2.0 * (s_new_i * flip.to(dt))[:, None] * Jd[i]
            done = done | ~flip
        it += steps
        if bool(done.all()):
            break
    return S


def difference_map_rounding_device(V: torch.Tensor, *, num_starts: int = 512,
                                   iters: int = 500, beta: float = 0.9,
                                   snapshot_every: int = 20,
                                   generator: Optional[torch.Generator] = None,
                                   x0: Optional[torch.Tensor] = None,
                                   dtype=None) -> torch.Tensor:
    """Device analogue of `difference_map_rounding` on V's device: blocks
    of `snapshot_every` difference-map steps (two [C, n] x [n, d] products
    per step), a rounded snapshot after each. Starts from `x0` [num_starts,
    n] when given, else from standard normals drawn with `generator`.
    Returns the pooled +-1 snapshots [blocks * C, n] (not uniqued: the
    descent takes duplicates as they come)."""
    dtype = V.dtype if dtype is None else dtype
    V = V.to(dtype)
    n = V.shape[0]
    if x0 is None:
        X = torch.randn((num_starts, n), generator=generator, dtype=dtype,
                        device=V.device)
    else:
        X = torch.as_tensor(x0, dtype=dtype, device=V.device).clone()
        num_starts = X.shape[0]
    blocks = max(1, iters // snapshot_every)
    snaps = []
    for _ in range(blocks):
        for _ in range(snapshot_every):
            PA = (X @ V) @ V.T
            X = X + beta * (_signs(2.0 * PA - X) - PA)
        snaps.append(_signs((X @ V) @ V.T))
    return torch.cat(snaps, dim=0)


def spectral_candidates_device(J, h=None, *, num_subspace: int = 0,
                               subspace_dim: Optional[int] = None,
                               dm_starts: int = 0, dm_iters: int = 500,
                               dm_beta: float = 0.9,
                               dm_dim: Optional[int] = None,
                               generator: Optional[torch.Generator] = None,
                               device=None, dtype="float32",
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device analogue of `spectral_candidates`: `torch.linalg.eigh` +
    sign rounding of every eigenvector (both signs when h is nonzero)
    (+ rounded random subspace samples and the
    `difference_map_rounding_device` pool, drawn with `generator`) +
    `batched_descent_device`. Runs on `device` (default: the CUDA card;
    raises without one). `dm_dim` None takes n // 2 (use
    `auto_subspace_dim` on host eigenvalues for the gap estimate).
    Returns (states [C, n], energies [C]) on the device, sorted ascending
    (stable)."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype, dev)
    J = torch.as_tensor(np.asarray(J) if not torch.is_tensor(J) else J,
                        dtype=dt, device=dev)
    n = J.shape[0]
    hv = None
    if h is not None:
        hv = torch.as_tensor(np.asarray(h) if not torch.is_tensor(h) else h,
                             dtype=dt, device=dev)
        if not bool(torch.any(hv != 0)):
            hv = None
    w, v = torch.linalg.eigh(J)
    cands = [_signs(v.T)]
    if hv is not None:
        cands.append(-cands[0])
    if num_subspace > 0:
        dim = subspace_dim if subspace_dim is not None else max(1, n // 2)
        x = torch.randn((num_subspace, dim), generator=generator, dtype=dt,
                        device=dev) @ v[:, n - dim:].T
        cands.append(_signs(x))
    if dm_starts > 0:
        d = int(dm_dim) if dm_dim else max(1, n // 2)
        d = max(2, min(d, n - 1))
        cands.append(difference_map_rounding_device(
            v[:, n - d:], num_starts=dm_starts, iters=dm_iters,
            beta=dm_beta, generator=generator))
    S = batched_descent_device(J, torch.cat(cands, dim=0), hv)
    E = -(0.5 * torch.sum(S * (S @ J), dim=1)
          + (S @ hv if hv is not None else 0.0))
    order = torch.argsort(E, stable=True)
    return S[order], E[order]
