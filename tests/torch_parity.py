"""Helpers shared by the tests that hold nmc_tpu_torch against nmc_tpu."""

import jax
import numpy as np
import torch


def jax_sweep_uniforms(key, num_sweeps, R, n_pad, dtype=np.float64):
    """The uniforms nmc_tpu.ops.sweeps.run_sweeps draws from `key`:
    split(key, T), then split(key_t)[0], then uniform((R, n_pad)) per sweep.
    Returned as [T, R, n_pad] for the port's injected-uniforms path."""
    keys = jax.random.split(key, num_sweeps)
    return np.stack([
        np.asarray(jax.random.uniform(jax.random.split(k)[0], (R, n_pad),
                                      dtype=dtype))
        for k in keys])


def nmc_phase_uniforms(key, cfg, R, n_pad, dtype=np.float64):
    """Per-phase uniforms of nmc_tpu.models.nmc.nmc_subroutine, in run
    order: each cycle splits (key, kc, knc, kall) and runs C, NC and, every
    full_update_frequency cycles, ALL."""
    out = []
    for cycle in range(cfg.num_NMC_cycles):
        key, kc, knc, kall = jax.random.split(key, 4)
        subs = [kc, knc] + ([kall] if cycle % cfg.full_update_frequency == 0
                            else [])
        out += [torch.as_tensor(jax_sweep_uniforms(
            k, cfg.num_sweeps_per_NMC_phase, R, n_pad, dtype)) for k in subs]
    return out


def t64(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def apt_replay(key, engine, cfg):
    """The draws of nmc_tpu.models.apt.apt_preprocess from `key`, on the JAX
    `engine` it runs: (initial states [num_rng, n], an endless iterator of
    per-rung uniforms [T, num_rng, n_pad]). apt_preprocess splits
    (key, k_init), then (key, k_run) once per rung."""
    key, k_init = jax.random.split(key)
    m_init = np.array(engine.from_blocked(
        engine.init_states(k_init, cfg.num_rng)), np.float64)

    def rungs(key):
        while True:
            key, k_run = jax.random.split(key)
            yield torch.as_tensor(jax_sweep_uniforms(
                k_run, cfg.num_sweeps_MCMC, cfg.num_rng, engine.n_pad))

    return m_init, rungs(key)


def npt_replay(key, engine, cfg, doNMC, dtype=np.float64):
    """The draws of nmc_tpu.models.npt.npt_run from `key` on the JAX
    `engine` it builds: (initial states [R, n], the host rng of its pair
    selection, and per swap round the pair (plain replicas' uniforms
    [per_swap, R_mcmc, n_pad] or None, NMC replicas' per-phase uniforms or
    None)). npt_run splits (key, k_init), seeds its host rng from the last
    word of the remaining key, then splits (key, k_mcmc, k_nmc) per round;
    its NMC replicas run nmc_subroutine on k_nmc."""
    from nmc_tpu.models.nmc import NMCConfig
    doNMC = np.asarray(doNMC, bool)
    R = doNMC.size
    key, k_init = jax.random.split(key)
    m_init = np.array(engine.from_blocked(engine.init_states(k_init, R)),
                      np.float64)
    host_rng = np.random.default_rng(
        np.asarray(jax.random.key_data(key)).ravel()[-1])
    per_swap, _, nmc_phase = cfg.derived_budgets()
    nmc_cfg = NMCConfig(num_sweeps_per_NMC_phase=nmc_phase,
                        num_NMC_cycles=cfg.num_cycles,
                        full_update_frequency=cfg.full_update_frequency)
    rounds = []
    for _ in range(cfg.num_swap_attempts):
        key, k_mcmc, k_nmc = jax.random.split(key, 3)
        mcmc = (torch.as_tensor(jax_sweep_uniforms(
            k_mcmc, per_swap, int((~doNMC).sum()), engine.n_pad, dtype))
            if (~doNMC).any() else None)
        nmc = (nmc_phase_uniforms(k_nmc, nmc_cfg, int(doNMC.sum()),
                                  engine.n_pad, dtype)
               if doNMC.any() else None)
        rounds.append((mcmc, nmc))
    return m_init, host_rng, rounds
