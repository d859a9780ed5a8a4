"""nmc_tpu_torch.parallel.EnsembleNMC against nmc_tpu.parallel.EnsembleNMC.

Both engines start from the same state (carried over with
`interop.ensemble_nmc_state_from_numpy`) and run rounds with LBP refreshes
and label swaps; the port replays the JAX engine's draws (tests/
torch_parity.ensemble_replay). Compared after the rounds: m, beta_to_slot,
cl, do_nmc_slot and e_best exactly, m_best through its energy (ties may
keep different states).

  * kernel route, f32: the port's K4 (its plain twin on the CPU) fed zero
    uniforms against JAX's round_kernel="on" (the Pallas kernel in
    interpret mode, whose PRNG gives zeros). In f32 the LBP relative-change
    plateau sits at a few ulps, so lbp_tolerance is 1e-4, far above it,
    and both packages take the same convergence decisions; no belief logit
    may lie within 1e-4 of the backbone threshold;
  * the plain route, f64, is in tests/test_torch_ensemble_plain.py.
The family has one instance that lacks two couplings of the union, so the
union colouring and the zero tiles of `_union_tiles` are exercised. Each
LBP mode (dense, sparse, planes) runs.
"""

import math

import jax
import numpy as np
import pytest
import torch

from nmc_tpu.core.problem import IsingProblem as JProblem
from nmc_tpu.io.generators import chimera_graph, ea_2d
from nmc_tpu.parallel import EnsembleNMC as JEnsemble
from nmc_tpu.parallel.sharded_pt import ShardedNPTConfig as JConfig
from nmc_tpu_torch import interop
from nmc_tpu_torch.core.problem import IsingProblem
from nmc_tpu_torch.io.generators import chimera_graph as t_chimera_graph
from nmc_tpu_torch.io.generators import random_sk
from nmc_tpu_torch.ops import lbp_jit, lbp_planes
from nmc_tpu_torch.ops.round_cuda import (ensemble_round,
                                          ensemble_round_sparse)
from nmc_tpu_torch.parallel import EnsembleNMC, ShardedNPTConfig
from nmc_tpu_torch.parallel import ensemble_nmc as ten

from torch_parity import ensemble_replay

BETA = np.array([0.3, 0.5, 0.8, 1.2, 1.6, 1.9, 3.0, 6.0])
DO_NMC = [False] * 6 + [True] * 2
ROUNDS = 4


def family():
    """Three ea_2d(6) instances; the third lacks two couplings."""
    probs = [ea_2d(6, seed=s).normalized()[0] for s in range(3)]
    J = probs[2].J.copy()
    for a, b in ((0, 1), (7, 13)):
        assert J[a, b] != 0
        J[a, b] = J[b, a] = 0.0
    probs[2] = JProblem(J, probs[2].h)
    return probs


def config(**kw):
    base = dict(sweeps_per_phase=3, num_cycles=2, full_update_frequency=2,
                num_swapping_pairs=2, use_coloring=True, block_size=16,
                lbp_max_iterations=30, lbp_tolerance=1e-4, lbp_every=2)
    base.update(kw)
    return base


def run_both(kw, *, plain, dtype):
    """(JAX final state, port final state, port engine, JAX engine)."""
    probs = family()
    je = JEnsemble(probs, BETA, DO_NMC, JConfig(**kw))
    te = EnsembleNMC(probs, BETA, DO_NMC, ShardedNPTConfig(**kw),
                     device="cpu")
    assert je._use_round_kernel != plain
    assert te.round_path == ("plain" if plain else "K4")
    js0 = je.init_state(jax.random.PRNGKey(0))
    ts0 = interop.ensemble_nmc_state_from_numpy(js0, torch.Generator(),
                                                dtype=dtype, device="cpu")
    js = je.run_scanned(js0, ROUNDS)
    draws = ensemble_replay(js0.key, te.cfg, len(probs), len(BETA),
                            te.n_pad, plain=plain)
    ts = te.run_scanned(ts0, ROUNDS, draws=draws)
    return js, ts, te, probs


def assert_states_equal(js, ts, te, probs, atol):
    for f in ("m", "beta_to_slot", "slot_to_beta", "cl", "do_nmc_slot"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    np.testing.assert_allclose(ts.e_best.numpy(), np.asarray(js.e_best),
                               rtol=0, atol=atol)
    eb, mb = te.best(ts)
    for i, p in enumerate(probs):
        assert abs(p.energy(mb[i]) - eb[i]) <= 1e-4
    assert ts.round_index == ROUNDS
    assert ts.cl.any() and (~ts.cl).any()
    assert not torch.equal(ts.beta_to_slot,
                           torch.arange(len(BETA)).expand_as(ts.beta_to_slot))


@pytest.mark.parametrize("lbp_mode", ["dense", "sparse", "planes"])
def test_kernel_route_matches_jax(lbp_mode, monkeypatch):
    """f32, K4's plain twin with u = 0 against JAX's interpreted K4."""
    logits = []
    for mod, name in ((lbp_jit, "convexified_marginal_dense"),
                      (lbp_jit, "convexified_marginal_sparse"),
                      (lbp_planes, "convexified_marginal_planes")):
        inner = getattr(mod, name)

        def recording(*a, _inner=inner, **k):
            out = _inner(*a, **k)
            logits.append(out)
            return out
        monkeypatch.setattr(mod, name, recording)
    monkeypatch.setattr(ten, "convexified_marginal_dense",
                        lbp_jit.convexified_marginal_dense)
    monkeypatch.setattr(ten, "convexified_marginal_sparse",
                        lbp_jit.convexified_marginal_sparse)
    js, ts, te, probs = run_both(
        config(lbp_mode=lbp_mode, dtype="float32", round_kernel="on"),
        plain=False, dtype="float32")
    assert (te.edge_slots is not None) == (lbp_mode == "planes")
    assert (te.edge_graph is not None) == (lbp_mode == "sparse")
    assert len(logits) == ROUNDS // 2                 # refresh rounds 0, 2
    thr = math.atanh(0.999999)
    for x in logits:
        assert (torch.abs(torch.abs(x) - thr) > 1e-4).all()
    assert_states_equal(js, ts, te, probs, atol=0)


@pytest.mark.parametrize("name,path", [("chimera_8x8", "K4"),
                                       ("chimera_16x16", "K5"),
                                       ("wishart_like", "plain")])
def test_routing_decision(name, path):
    """The route alone, fixed at setup: K4 up to n_pad 1536, K5 above it
    (chimera 16x16: K = 5 of 16 tiles), plain for an uncoloured layout."""
    if name == "wishart_like":
        probs = [random_sk(24, seed=s) for s in range(2)]
        cfg = ShardedNPTConfig(use_coloring=False)
    else:
        size = 8 if name == "chimera_8x8" else 16
        probs = [t_chimera_graph(size, size, seed=s) for s in range(2)]
        cfg = ShardedNPTConfig(use_coloring=True)
    ens = EnsembleNMC(probs, np.geomspace(0.3, 3.0, 8), [False] * 8, cfg,
                      device="cpu")
    assert ens.round_path == path
    if path == "K5":
        col_idx, J_tiles = ens._stream_tiles
        assert tuple(col_idx.shape) == (16, 5)
        assert tuple(J_tiles.shape) == (2, 16, 5, 128, 128)
    else:
        assert ens._stream_tiles is None


def test_round_kernel_on_refuses_an_uncoloured_layout():
    probs = [random_sk(12, seed=s) for s in range(2)]
    with pytest.raises(ValueError, match="use_coloring"):
        EnsembleNMC(probs, [0.5, 1.0], [False, False],
                    ShardedNPTConfig(round_kernel="on"), device="cpu")
    with pytest.raises(ValueError, match="float32"):
        EnsembleNMC(probs, [0.5, 1.0], [False, False],
                    ShardedNPTConfig(round_kernel="on", use_coloring=True,
                                     dtype="float64"), device="cpu")
    with pytest.raises(ValueError, match="auto\\|on\\|off"):
        EnsembleNMC(probs, [0.5, 1.0], [False, False],
                    ShardedNPTConfig(round_kernel="maybe"), device="cpu")


def test_init_state_seeds_and_padding_match_jax():
    """Padding of a family with different spin counts to the family max,
    and `m0` seeds placed on the coldest slots in reverse order."""
    probs = [chimera_graph(1, 2, seed=s).normalized()[0] for s in (1, 2)]
    J = np.zeros((14, 14))
    J[:, :] = probs[1].J[:14, :14]
    probs[1] = JProblem(J, np.zeros(14))
    kw = dict(use_coloring=True, block_size=8)
    je = JEnsemble(probs, BETA, DO_NMC, JConfig(**kw))
    te = EnsembleNMC([IsingProblem(p.J, p.h) for p in probs], BETA, DO_NMC,
                     ShardedNPTConfig(**kw), device="cpu")
    assert te.n_pad == je.n_pad
    np.testing.assert_array_equal(te.h.numpy(), np.asarray(je.h))
    np.testing.assert_array_equal(te.J_rows.numpy(), np.asarray(je.J_rows))
    np.testing.assert_array_equal(te.epsilon.numpy(),
                                  np.asarray(je.epsilon))
    rng = np.random.default_rng(0)
    m0 = np.where(rng.random((2, 3, 16)) < 0.5, -1.0, 1.0)
    js = je.init_state(jax.random.PRNGKey(1), m0=m0)
    ts = te.init_state(torch.Generator().manual_seed(1), m0=m0)
    np.testing.assert_array_equal(ts.m.numpy()[:, -3:],
                                  np.asarray(js.m)[:, -3:])
    assert ts.m.shape == tuple(js.m.shape)
    assert (ts.m.numpy()[..., ~te.blocked0.active] == 1).all()
    np.testing.assert_array_equal(ts.do_nmc_slot.numpy(),
                                  np.asarray(js.do_nmc_slot))
    with pytest.raises(ValueError, match="seeds"):
        te.init_state(torch.Generator(), m0=np.ones((2, 9, 16)))


def test_run_scanned_with_generator_timings_and_best():
    """Drawn from the state's generator: the same seed gives the same
    rounds; the timing split covers every stage; best() returns each
    instance's energy with its state in the original spin order."""
    probs = family()
    cfg = ShardedNPTConfig(**config(lbp_mode="planes"))
    ens = EnsembleNMC(probs, BETA, DO_NMC, cfg, device="cpu")
    finals = []
    for _ in range(2):
        timings = {}
        s = ens.init_state(torch.Generator().manual_seed(4))
        s = ens.run_scanned(s, 3, timings=timings)
        finals.append(s)
    assert set(timings) == {"lbp", "round", "swaps", "rounds", "host_s",
                            "host_syncs", "lbp_refreshes", "lbp_iterations"}
    assert all(v >= 0 for v in timings.values())
    assert timings["rounds"] == 3 and timings["lbp_refreshes"] == 2
    for f in ("m", "beta_to_slot", "e_best", "cl"):
        assert torch.equal(getattr(finals[0], f), getattr(finals[1], f))
    eb, mb = ens.best(finals[0])
    assert mb.shape == (3, 36) and np.isin(mb, [-1.0, 1.0]).all()
    for i, p in enumerate(probs):
        assert abs(p.energy(mb[i]) - eb[i]) <= 1e-4
    assert ensemble_round.launches == 0 and ensemble_round_sparse.launches == 0
