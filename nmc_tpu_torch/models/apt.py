"""APT preprocessor — adaptive inverse-temperature schedule (torch).

The counterpart of ``nmc_tpu/models/apt.py``: grow a beta ladder from
measured energy fluctuations. At each rung `num_rng` independent Gibbs
chains run at the current beta as one batch of one sweep-engine call,
sigma_E = mean over chains of the std over the last `num_sweeps_read`
sweeps of the energy, and the next rung is beta + alpha / sigma_E. The loop
stops when sigma_E drops below 0.5 * min|J_ij != 0| (freeze-out) or beta
exceeds beta_max. Chains warm-start from their previous final states.

Artifacts (`beta_list_python.npy`, `sigma_list_python.npy`, per-rung
energies) are written when `save_dir` is set; the beta list is what NPT
consumes.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterable, List, NamedTuple, Optional

import numpy as np
import torch

from ..core.problem import IsingProblem
from ..device import resolve_device
from ..ops.engine import SweepEngine
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.metrics import MetricsLogger


@dataclasses.dataclass
class APTConfig:
    """Hyperparameters; names and defaults mirror the JAX package's APTConfig."""
    num_sweeps_MCMC: int = 1000
    num_sweeps_read: int = 1000
    num_rng: int = 100
    beta_start: float = 0.5
    alpha: float = 1.25
    sigma_E_val: float = 1000.0
    beta_max: float = 30.0
    normalize: bool = True
    max_rungs: int = 10_000       # safety bound absent in the reference
    save_dir: Optional[str] = None  # e.g. "Results/data" for artifact parity
    # fault tolerance: snapshot every K rungs (0 = off), resume from it
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0
    resume: bool = False
    # execution knobs
    block_size: int = 128
    use_coloring: bool = False
    dtype: str = "float32"


class APTResult(NamedTuple):
    beta: List[float]        # the schedule (first entry = beta_start)
    sigma: List[float]       # sigma_E per accepted rung
    final_states: np.ndarray  # [num_rng, n] last chain states
    norm_factor: float


def apt_preprocess(
    problem: IsingProblem,
    cfg: APTConfig = APTConfig(),
    generator: Optional[torch.Generator] = None,
    engine: Optional[SweepEngine] = None,
    metrics: Optional[MetricsLogger] = None,
    device=None,
    *,
    m_init: Optional[np.ndarray] = None,
    uniforms: Optional[Iterable[torch.Tensor]] = None,
) -> APTResult:
    """Build the beta ladder. `generator` (default: seed 0 on `device`)
    drives every draw; `m_init` ([num_rng, n]) and `uniforms` (one
    [T, num_rng, n_pad] tensor per rung, in run order) replace the initial
    and per-rung draws, so tests can replay another implementation's."""
    if engine is not None:
        device = engine.device
    elif device is None and generator is not None:
        device = generator.device
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    norm_prob, norm_factor = (problem.normalized() if cfg.normalize
                              else (problem, 1.0))
    if engine is None:
        engine = SweepEngine(norm_prob, block_size=cfg.block_size,
                             use_coloring=cfg.use_coloring, dtype=cfg.dtype,
                             device=device)
    if cfg.num_sweeps_MCMC <= 0:
        raise ValueError("num_sweeps_MCMC must be positive")
    if cfg.num_sweeps_read > cfg.num_sweeps_MCMC:
        raise ValueError("num_sweeps_read cannot exceed num_sweeps_MCMC")

    sigma_E_min = 0.5 * norm_prob.min_abs_nonzero_J()
    beta: List[float] = [float(cfg.beta_start)]
    sigma: List[float] = []
    sigma_E = float(cfg.sigma_E_val)

    if cfg.save_dir:
        os.makedirs(cfg.save_dir, exist_ok=True)

    m = (engine.from_blocked(engine.init_states(generator, cfg.num_rng))
         if m_init is None else torch.as_tensor(
             m_init, dtype=engine.dtype, device=engine.device))
    rung_uniforms = iter(uniforms) if uniforms is not None else None

    rung = 1
    if cfg.resume and cfg.checkpoint_path and os.path.exists(cfg.checkpoint_path):
        snap, step, _ = load_checkpoint(cfg.checkpoint_path)
        m = torch.as_tensor(snap["m"], dtype=engine.dtype,
                            device=engine.device)
        beta = [float(b) for b in snap["beta"]]
        sigma = [float(s) for s in snap["sigma"]]
        sigma_E = float(snap["sigma_E"])
        generator.set_state(torch.as_tensor(snap["generator"]))
        rung = int(step)

    while sigma_E > sigma_E_min and rung <= cfg.max_rungs:
        rung_t0 = time.perf_counter()
        if rung != 1:
            beta.append(beta[-1] + cfg.alpha / sigma_E)

        res = engine.run(m, generator, num_sweeps=cfg.num_sweeps_MCMC,
                         beta=beta[-1],
                         uniforms=next(rung_uniforms) if rung_uniforms else None)
        m = res.m
        energies = res.energies.cpu().numpy()         # [T, num_rng]
        window = energies[-cfg.num_sweeps_read:]      # [num_sweeps_read, R]
        sigma_E = float(np.mean(np.std(window, axis=0)))
        if metrics is not None:
            metrics.apt_rung(rung=rung, beta=beta[-1], sigma_E=sigma_E,
                             seconds=time.perf_counter() - rung_t0)

        if beta[-1] > cfg.beta_max:
            # the reference logs and breaks BEFORE appending sigma
            break

        sigma.append(sigma_E)
        if cfg.save_dir:
            np.save(os.path.join(cfg.save_dir, f"Energy_iter_{rung}.npy"),
                    window.T)  # reference layout: [num_rng, num_sweeps_read]
            np.save(os.path.join(cfg.save_dir, f"sigma_iter_{rung}.npy"),
                    sigma_E)
        rung += 1
        if (cfg.checkpoint_path and cfg.checkpoint_every
                and (rung - 1) % cfg.checkpoint_every == 0):
            save_checkpoint(
                cfg.checkpoint_path,
                {"m": m.cpu().numpy(), "beta": np.asarray(beta),
                 "sigma": np.asarray(sigma), "sigma_E": sigma_E,
                 "generator": generator.get_state().numpy()},
                step=rung)

    if cfg.save_dir:
        np.save(os.path.join(cfg.save_dir, "beta_list_python.npy"),
                np.asarray(beta))
        np.save(os.path.join(cfg.save_dir, "sigma_list_python.npy"),
                np.asarray(sigma))

    return APTResult(beta=beta, sigma=sigma, final_states=m.cpu().numpy(),
                     norm_factor=norm_factor)
