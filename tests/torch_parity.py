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
