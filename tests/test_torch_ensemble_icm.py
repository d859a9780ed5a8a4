"""nmc_tpu_torch.parallel.EnsembleICM against nmc_tpu.parallel.EnsembleICM.

Both engines start from the same state (carried over with
`interop.ensemble_icm_state_from_numpy`) and run rounds of sweeps, Houdayer
moves and label swaps; the port replays the JAX engine's draws
(`icm_replay` below: the per-instance key tree fold_in(key, i) ->
fold_in(., round_index), then split(., 2)[0] for the plain sweep stage and
split(., 4)[1:] for the sub-replica permutation, the cluster uniforms and
the label swaps). Compared after the rounds: m, beta_to_slot,
slot_to_beta, icm_moves, icm_flips, cl, dn and e_best exactly, m_best
through its energy (ties may keep different states).

  * kernel route, f32: the port's K4 (its plain twin on the CPU) fed zero
    uniforms against JAX's round_kernel="on" (the Pallas kernel in
    interpret mode, whose PRNG gives zeros);
  * plain route, f64: round_kernel="off" on both sides, JAX's sweep
    uniforms replayed.
Each route runs pure ICM and the hybrid arm. The family's third instance
lacks two couplings of the union, so the union colouring, the zero tiles
and the padded edge lists are exercised; ea_2d L = 6 on blocks of 16 has
n_pad 64 > 36 spins, so padded spins and the Katzgraber flip (clusters
above n_pad // 2 = 32 spins) occur.
"""

import jax
import numpy as np
import pytest
import torch

from nmc_tpu.core.problem import IsingProblem as JProblem
from nmc_tpu.io.generators import ea_2d
from nmc_tpu.parallel import EnsembleICM as JEnsemble
from nmc_tpu.parallel import EnsembleICMConfig as JConfig
from nmc_tpu_torch import interop
from nmc_tpu_torch.io.generators import chimera_graph, random_sk
from nmc_tpu_torch.ops.round_cuda import (ensemble_round,
                                          ensemble_round_sparse)
from nmc_tpu_torch.parallel import EnsembleICM, EnsembleICMConfig, ICMDraws

from torch_parity import jax_sweep_uniforms

# With zero uniforms a spin goes up iff p_up = (1 + tanh(beta * phi)) / 2
# is above 0. XLA's float32 tanh is exactly -1 from |x| = 7.9053 on, torch's
# only from about 9.01, so no beta * |phi| of the kernel test may fall in
# between: the ladder avoids 3.0 (3 x 3 = 9 on the degree-3 spins of the
# third instance). With drawn uniforms the two differ with probability
# ~1e-7 per update.
BETA = np.array([0.3, 0.5, 0.8, 1.2, 1.6, 1.9, 2.5, 6.0])
ROUNDS = 4


def family():
    """Three normalized ea_2d(6) instances; the third lacks two couplings."""
    probs = [ea_2d(6, seed=s).normalized()[0] for s in range(3)]
    J = probs[2].J.copy()
    for a, b in ((0, 1), (7, 13)):
        assert J[a, b] != 0
        J[a, b] = J[b, a] = 0.0
    probs[2] = JProblem(J, probs[2].h)
    return probs


def config(**kw):
    base = dict(sweeps_per_round=6, num_subreplicas=4, num_swapping_pairs=2,
                use_coloring=True, block_size=16)
    base.update(kw)
    return base


def icm_replay(key, cfg, I, R, n_pad, *, plain):
    """`draws(round_index)` for the port's EnsembleICM.run_scanned that
    replays nmc_tpu's EnsembleICM from its state key: per instance
    k = fold_in(fold_in(key, i), round_index). The plain sweep stage draws
    from split(k)[0] (pure ICM one run_sweeps call; hybrid per cycle
    split(., 4) -> (next, kc, knc, kall)); the kernel route gets zeros,
    what the Pallas interpreter's PRNG gives. split(k, 4)[1:] are the
    sub-replica permutation key, the cluster key (split into S // 2 * R
    keys, one uniform [n_pad] each) and the swap key (split into S keys,
    each split into the pair selection's Gumbel keys and the acceptance
    uniforms)."""
    S, npairs = cfg.num_subreplicas, cfg.num_swapping_pairs
    Pn = S // 2
    hybrid = cfg.hybrid_cold > 0
    cycles = cfg.num_cycles if hybrid else 1
    spp = cfg.sweeps_per_round // (3 * cycles)

    def draws(round_index):
        sweeps, perms, g, gum, su = [], [], [], [], []
        for i in range(I):
            k = jax.random.fold_in(jax.random.fold_in(key, i), round_index)
            if plain:
                k_sw = jax.random.split(k)[0]
                if not hybrid:
                    ph = [jax_sweep_uniforms(k_sw, cfg.sweeps_per_round,
                                             S * R, n_pad)]
                else:
                    ph = []
                    for _ in range(cycles):
                        k_sw, kc, knc, kall = jax.random.split(k_sw, 4)
                        ph += [jax_sweep_uniforms(kk, spp, S * R, n_pad)
                               for kk in (kc, knc, kall)]
                sweeps.append(np.stack(ph))
            _, k_pair, k_icm, k_swap = jax.random.split(k, 4)
            perms.append(np.asarray(jax.random.permutation(k_pair, S)))
            keys = jax.random.split(k_icm, Pn * R)
            g.append(np.stack([np.asarray(jax.random.uniform(kk, (n_pad,)))
                               for kk in keys]).reshape(Pn, R, n_pad))
            gi, ui = [], []
            for ks in jax.random.split(k_swap, S):
                k_sel, k_acc = jax.random.split(ks)
                gi.append(np.stack([
                    np.asarray(jax.random.gumbel(kk, (R - 1,)))
                    for kk in jax.random.split(k_sel, npairs)]))
                ui.append(np.asarray(jax.random.uniform(k_acc, (npairs,))))
            gum.append(np.stack(gi))
            su.append(np.stack(ui))
        if plain:
            sw = torch.as_tensor(np.stack(sweeps, axis=2))
        else:
            sw = torch.zeros((3 * cycles, spp, I, S * R, n_pad),
                             dtype=torch.float32)
        return ICMDraws(sweep_uniforms=sw,
                        perms=torch.as_tensor(np.stack(perms)),
                        cluster_uniforms=torch.as_tensor(np.stack(g)),
                        gumbels=torch.as_tensor(np.stack(gum)),
                        swap_uniforms=torch.as_tensor(np.stack(su)))

    return draws


def run_both(kw, *, plain, dtype, rounds=ROUNDS):
    """(JAX final state, port final state, port engine, problems)."""
    probs = family()
    je = JEnsemble(probs, BETA, JConfig(**kw))
    te = EnsembleICM(probs, BETA, EnsembleICMConfig(**kw), device="cpu")
    assert je._use_round_kernel != plain
    assert te.round_path == ("plain" if plain else "K4")
    js0 = je.init_state(jax.random.PRNGKey(0))
    ts0 = interop.ensemble_icm_state_from_numpy(js0, torch.Generator(),
                                                dtype=dtype, device="cpu")
    js = je.run_scanned(js0, rounds)
    draws = icm_replay(js0.key, te.cfg, len(probs), len(BETA), te.n_pad,
                       plain=plain)
    ts = te.run_scanned(ts0, rounds, draws=draws)
    return js, ts, te, probs


def assert_states_equal(js, ts, te, probs, rounds=ROUNDS):
    for f in ("m", "beta_to_slot", "slot_to_beta", "icm_moves", "icm_flips",
              "e_best"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    if te.hybrid:
        for f in ("cl", "dn"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)),
                                          err_msg=f)
    else:
        assert ts.cl is None and ts.dn is None
    eb, mb = te.best(ts)
    for i, p in enumerate(probs):
        assert abs(p.energy(mb[i]) - eb[i]) <= 1e-4
    assert ts.round_index == rounds
    assert int(ts.icm_moves.sum()) > 0
    assert (ts.m.numpy()[..., ~te.blocked0.active] == 1).all()
    assert not torch.equal(
        ts.beta_to_slot, torch.arange(len(BETA)).expand_as(ts.beta_to_slot))


HYBRID = dict(hybrid_cold=3, temp_x=10.0, num_cycles=2)


@pytest.mark.parametrize("arm", ["icm", "hybrid"])
def test_kernel_route_matches_jax(arm):
    """f32, K4's plain twin with u = 0 against JAX's interpreted K4."""
    kw = config(round_kernel="on", **(HYBRID if arm == "hybrid" else {}))
    js, ts, te, probs = run_both(kw, plain=False, dtype="float32")
    assert_states_equal(js, ts, te, probs)
    if arm == "hybrid":
        assert ts.dn.any()


@pytest.mark.parametrize("arm", ["icm", "hybrid"])
def test_plain_route_matches_jax(arm):
    """f64, round_kernel="off" on both sides, the sweep uniforms replayed;
    a Katzgraber flip happens on this family at these seeds."""
    kw = config(round_kernel="off", dtype="float64",
                **(HYBRID if arm == "hybrid" else {}))
    js, ts, te, probs = run_both(kw, plain=True, dtype="float64", rounds=6)
    assert_states_equal(js, ts, te, probs, rounds=6)
    assert int(ts.icm_flips.sum()) > 0
    if arm == "hybrid":
        assert ts.dn.any()


def test_four_backends_give_one_trajectory():
    """auto (= matmul on ea_2d, degree 4), matmul, blocked and sparse reach
    the same labels, so the same draws give the same rounds."""
    probs = family()
    out = {}
    for mode in ("auto", "matmul", "blocked", "sparse"):
        ens = EnsembleICM(probs, BETA, EnsembleICMConfig(
            **config(houdayer=mode)), device="cpu")
        assert ens.houdayer == ("matmul" if mode == "auto" else mode)
        s = ens.init_state(torch.Generator().manual_seed(3))
        stats = {}
        out[mode] = ens.run_scanned(s, 5, houdayer_stats=stats)
        assert stats["iterations"] >= 1 and stats["steps"] >= 1
    for mode in ("matmul", "blocked", "sparse"):
        for f in ("m", "beta_to_slot", "e_best", "icm_moves", "icm_flips"):
            assert torch.equal(getattr(out["auto"], f),
                               getattr(out[mode], f)), (mode, f)
    assert int(out["auto"].icm_moves.sum()) > 0


def test_config_errors():
    probs = family()
    with pytest.raises(ValueError, match="hybrid_cold"):
        EnsembleICM(probs, BETA, EnsembleICMConfig(**config(hybrid_cold=9)),
                    device="cpu")
    with pytest.raises(ValueError, match="3\\*num_cycles"):
        EnsembleICM(probs, BETA, EnsembleICMConfig(**config(
            sweeps_per_round=9, hybrid_cold=2, num_cycles=2)), device="cpu")
    # pure ICM: the kernel route needs 3 | sweeps_per_round; JAX would
    # quietly take its XLA round, the port raises and names it
    with pytest.raises(ValueError, match="round_kernel='off'"):
        EnsembleICM(probs, BETA, EnsembleICMConfig(**config(
            sweeps_per_round=7)), device="cpu")
    ens = EnsembleICM(probs, BETA, EnsembleICMConfig(**config(
        sweeps_per_round=7, round_kernel="off")), device="cpu")
    assert ens.round_path == "plain"
    with pytest.raises(ValueError, match="use_coloring"):
        EnsembleICM(probs, BETA, EnsembleICMConfig(**config(
            use_coloring=False, round_kernel="on")), device="cpu")
    with pytest.raises(ValueError, match="float32"):
        EnsembleICM(probs, BETA, EnsembleICMConfig(**config(
            dtype="float64", round_kernel="on")), device="cpu")
    with pytest.raises(ValueError, match="auto\\|on\\|off"):
        EnsembleICM(probs, BETA, EnsembleICMConfig(**config(
            round_kernel="maybe")), device="cpu")
    with pytest.raises(ValueError, match="auto\\|matmul"):
        EnsembleICM(probs, BETA, EnsembleICMConfig(**config(
            houdayer="dense")), device="cpu")
    # a dense instance: 'matmul' raises past the degree cap, 'auto' falls
    # back to the edge lists
    dense = [random_sk(24, seed=0)]
    with pytest.raises(ValueError, match="degree"):
        EnsembleICM(dense, BETA[:4], EnsembleICMConfig(
            sweeps_per_round=4, num_subreplicas=2, block_size=8,
            houdayer="matmul"), device="cpu")
    ens = EnsembleICM(dense, BETA[:4], EnsembleICMConfig(
        sweeps_per_round=4, num_subreplicas=2, block_size=8), device="cpu")
    assert ens.houdayer == "sparse" and ens.round_path == "plain"


@pytest.mark.parametrize("size,path", [(8, "K4"), (16, "K5")])
def test_routing_and_init_state(size, path):
    """K4 up to n_pad 1536, K5 above (chimera 16x16); init_state seeds the
    coldest chains of sub-replica 0 only, and pure ICM carries no masks."""
    probs = [chimera_graph(size, size, seed=s) for s in range(2)]
    ens = EnsembleICM(probs, np.geomspace(0.3, 3.0, 4), EnsembleICMConfig(
        sweeps_per_round=3, num_subreplicas=2, use_coloring=True),
        device="cpu")
    assert ens.round_path == path and ens.houdayer == "matmul"
    assert (ens._stream_tiles is None) == (path == "K4")
    m0 = np.where(np.random.default_rng(0).random((2, 2, probs[0].n)) < 0.5,
                  -1.0, 1.0)
    s = ens.init_state(torch.Generator().manual_seed(0), m0=m0)
    assert s.cl is None and s.dn is None
    got = s.m[:, 0, 2:][..., ens._inv_perm].numpy()
    np.testing.assert_array_equal(got, m0[:, ::-1])
    with pytest.raises(ValueError, match="seeds"):
        ens.init_state(torch.Generator(), m0=np.ones((2, 5, probs[0].n)))


def test_run_scanned_with_generator_timings_and_best():
    """Drawn from the state's generator: the same seed gives the same
    rounds; the timing split covers every stage; the round kernel's plain
    twin ran on the CPU (no launch); best() returns each instance's energy
    with its state in the original spin order."""
    probs = family()
    ens = EnsembleICM(probs, BETA, EnsembleICMConfig(**config(**HYBRID)),
                      device="cpu")
    assert ens.round_path == "K4"
    finals = []
    for _ in range(2):
        timings = {}
        s = ens.init_state(torch.Generator().manual_seed(4))
        s = ens.run_scanned(s, 3, timings=timings)
        finals.append(s)
    assert set(timings) == {"round", "houdayer", "swaps", "rounds", "host_s",
                            "host_syncs", "houdayer_steps", "houdayer_pairs"}
    assert all(v >= 0 for v in timings.values())
    assert timings["rounds"] == 3
    for f in ("m", "beta_to_slot", "e_best", "cl", "icm_moves"):
        assert torch.equal(getattr(finals[0], f), getattr(finals[1], f))
    eb, mb = ens.best(finals[0])
    assert mb.shape == (3, 36) and np.isin(mb, [-1.0, 1.0]).all()
    for i, p in enumerate(probs):
        assert abs(p.energy(mb[i]) - eb[i]) <= 1e-4
    for b2s in finals[0].beta_to_slot.numpy().reshape(-1, len(BETA)):
        assert sorted(b2s.tolist()) == list(range(len(BETA)))
    assert ensemble_round.launches == 0 and ensemble_round_sparse.launches == 0
