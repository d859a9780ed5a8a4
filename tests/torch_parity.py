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


def swap_replay(key, round_index, num_instances, num_replicas, num_pairs):
    """The label-swap draws of nmc_tpu.parallel.EnsembleNMC's round
    `round_index`, per instance i: fold_in(key, i), fold_in(., round_index),
    fold_in(., 0xD00D), then split into a selection key (split again into
    one key per pair, each drawing Gumbels over the R - 1 pairs) and an
    acceptance key (one uniform per pair). Returns (gumbels
    [I, num_pairs, R - 1], uniforms [I, num_pairs]), f64 under x64."""
    gumbels, uniforms = [], []
    for i in range(num_instances):
        k_swap = jax.random.fold_in(jax.random.fold_in(
            jax.random.fold_in(key, i), round_index), np.uint32(0xD00D))
        k_sel, k_acc = jax.random.split(k_swap)
        gumbels.append(np.stack([
            np.asarray(jax.random.gumbel(k, (num_replicas - 1,)))
            for k in jax.random.split(k_sel, num_pairs)]))
        uniforms.append(np.array(jax.random.uniform(k_acc, (num_pairs,))))
    return torch.as_tensor(np.stack(gumbels)), torch.as_tensor(
        np.stack(uniforms))


def ensemble_phase_uniforms(key, round_index, num_instances, cfg, R, n_pad,
                            dtype=np.float64):
    """The per-phase sweep uniforms of the plain (XLA) round of
    nmc_tpu.parallel.EnsembleNMC (`one_instance`), as [P, T, I, R, n_pad]:
    per instance k_dev = fold_in(fold_in(key, i), round_index), then per
    cycle split(k_dev, 4) -> (k_dev, kc, knc, kall) and the phases C, NC
    and, every full_update_frequency cycles, ALL draw from kc, knc, kall."""
    per_inst = []
    for i in range(num_instances):
        k_dev = jax.random.fold_in(jax.random.fold_in(key, i), round_index)
        phases = []
        for cycle in range(cfg.num_cycles):
            k_dev, kc, knc, kall = jax.random.split(k_dev, 4)
            subs = [kc, knc] + ([kall] if cycle % cfg.full_update_frequency
                                == 0 else [])
            phases += [jax_sweep_uniforms(k, cfg.sweeps_per_phase, R, n_pad,
                                          dtype) for k in subs]
        per_inst.append(np.stack(phases))          # [P, T, R, n_pad]
    return torch.as_tensor(np.stack(per_inst, axis=2))


def ensemble_replay(key, cfg, num_instances, R, n_pad, *, plain):
    """`draws(round_index)` for nmc_tpu_torch's EnsembleNMC.run_scanned that
    replays the JAX engine's draws from its state key: the plain route's
    per-phase uniforms (or, for the kernel route, zeros, which is what the
    Pallas interpreter's PRNG gives), and the label-swap draws."""
    from nmc_tpu_torch.ops.round_cuda import phase_list
    from nmc_tpu_torch.parallel import RoundDraws
    P = len(phase_list(cfg.num_cycles, cfg.full_update_frequency))

    def draws(round_index):
        g, u = swap_replay(key, round_index, num_instances, R,
                           cfg.num_swapping_pairs)
        if plain:
            sweeps = ensemble_phase_uniforms(key, round_index, num_instances,
                                             cfg, R, n_pad)
        else:
            sweeps = torch.zeros((P, cfg.sweeps_per_phase, num_instances, R,
                                  n_pad), dtype=torch.float32)
        return RoundDraws(sweep_uniforms=sweeps, gumbels=g, swap_uniforms=u)

    return draws


def label_swap_draws(k_swap, num_replicas, num_pairs):
    """The draws nmc_tpu.parallel.swaps.metropolis_label_swap makes from
    `k_swap` for one ladder: split into a selection key (split again into
    one key per pair, each drawing Gumbels over the R - 1 pairs) and an
    acceptance key (one uniform per pair). Returns (gumbels [1, num_pairs,
    R - 1], uniforms [1, num_pairs])."""
    k_sel, k_acc = jax.random.split(k_swap)
    g = np.stack([np.asarray(jax.random.gumbel(k, (num_replicas - 1,)))
                  for k in jax.random.split(k_sel, num_pairs)])
    u = np.array(jax.random.uniform(k_acc, (num_pairs,)))
    return torch.as_tensor(g[None]), torch.as_tensor(u[None])


def sharded_npt_replay(key, cfg, R, n_pad, n_dev, *, plain,
                       dtype=np.float64):
    """`draws(round_index)` replaying nmc_tpu.parallel.ShardedNPT's round on
    an n_dev-device mesh from its state key, for the port's whole ladder:
    kr = fold_in(key, round_index); the swap draws from fold_in(kr, 0xD00D);
    on the plain route device d's phase uniforms (k_dev = fold_in(kr, d),
    split per cycle into (k_dev, kc, knc, kall)) for its R / n_dev rows, the
    devices' rows stacked in order; on the kernel route zeros, which the
    Pallas interpreter's PRNG gives."""
    from nmc_tpu_torch.ops.round_cuda import phase_list
    from nmc_tpu_torch.parallel import RoundDraws
    P = len(phase_list(cfg.num_cycles, cfg.full_update_frequency))
    T, R_loc = cfg.sweeps_per_phase, R // n_dev

    def draws(round_index):
        kr = jax.random.fold_in(key, round_index)
        g, u = label_swap_draws(jax.random.fold_in(kr, np.uint32(0xD00D)),
                                R, cfg.num_swapping_pairs)
        if not plain:
            return RoundDraws(torch.zeros((P, T, 1, R, n_pad),
                                          dtype=torch.float32), g, u)
        per_dev = []
        for d in range(n_dev):
            k_dev = jax.random.fold_in(kr, d)
            phases = []
            for cycle in range(cfg.num_cycles):
                k_dev, kc, knc, kall = jax.random.split(k_dev, 4)
                subs = [kc, knc] + ([kall] if cycle % cfg.full_update_frequency
                                    == 0 else [])
                phases += [jax_sweep_uniforms(k, T, R_loc, n_pad, dtype)
                           for k in subs]
            per_dev.append(np.stack(phases))            # [P, T, R_loc, n]
        sweeps = np.concatenate(per_dev, axis=2)[:, :, None]
        return RoundDraws(torch.as_tensor(sweeps), g, u)

    return draws


def spin_sharded_replay(key, step, num_sweeps, num_blocks, R, B,
                        dtype=np.float32):
    """The uniforms nmc_tpu.parallel.SpinShardedSweeper.sweeps draws from
    its state key on a 'spin' mesh (no replica axis): key folded with
    replica shard 0, per sweep t k_t = fold_in(fold_in(key, step + t), 0),
    per block b uniform(fold_in(k_t, b), (R, B)). Returned as
    [T, num_blocks, R, B] for the port's injected uniforms."""
    key = jax.random.fold_in(key, np.uint32(0))
    out = []
    for t in range(num_sweeps):
        k_t = jax.random.fold_in(jax.random.fold_in(key, step + t),
                                 np.uint32(0))
        out.append([np.asarray(jax.random.uniform(
            jax.random.fold_in(k_t, b), (R, B), dtype=dtype))
            for b in range(num_blocks)])
    return torch.as_tensor(np.array(out))
