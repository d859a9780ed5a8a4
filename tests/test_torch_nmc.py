"""The slice as a whole: the port's NMC driver against nmc_tpu's.

Both drivers run on identical J, h and layout (carried over with interop),
from the same m_star, and the port replays the JAX driver's per-phase
uniforms (rebuilt from its key splits) through the injected-uniforms path:
equal clusters, phase bookkeeping and best states, energies to 1e-9 (f64).
"""

import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmc_tpu.io.generators import chimera_graph
from nmc_tpu.models import nmc as jn
from nmc_tpu.ops.engine import SweepEngine as JaxEngine
from nmc_tpu_torch import cli, interop
from nmc_tpu_torch.io.generators import ea_2d
from nmc_tpu_torch.models import nmc as tn
from nmc_tpu_torch.ops.engine import SweepEngine
from nmc_tpu_torch.ops.sweeps_cuda import colored_sweeps

from torch_parity import nmc_phase_uniforms

# the CLI's LBP settings (python -m nmc_tpu nmc): a clamp strong enough that
# the first rung converges on these small instances
LBP = dict(lambda_start=3.0, tolerance=1e-8, max_iterations=200)


@pytest.mark.parametrize("record_m,clusters_once", [
    (False, False), (True, False), (False, True)])
def test_nmc_subroutine_matches_jax(record_m, clusters_once):
    prob = chimera_graph(2, 2, seed=3).normalized()[0]
    R = 4
    common = dict(num_sweeps_per_NMC_phase=6, num_NMC_cycles=2,
                  record_m=record_m, clusters_once=clusters_once,
                  use_coloring=True, block_size=8, num_chains=R, **LBP)
    jcfg = jn.NMCConfig(dtype="float64", **common)
    tcfg = tn.NMCConfig(dtype="float64", **common)
    jeng = JaxEngine(prob, block_size=8, use_coloring=True,
                     dtype=jnp.float64)
    teng = SweepEngine.from_blocked_problem(
        interop.blocked_from_numpy(jeng.blocked),
        interop.problem_from_numpy(prob.J, prob.h), dtype="float64",
        device="cpu")
    rng = np.random.default_rng(8)
    m_star = np.where(rng.random((R, prob.n)) < 0.5, -1.0, 1.0)
    key = jax.random.PRNGKey(3)

    jr = jn.nmc_subroutine(jeng, prob, m_star, key, jcfg)
    before = colored_sweeps.launches
    tr = tn.nmc_subroutine(
        teng, teng.problem, m_star, None, tcfg,
        uniforms=nmc_phase_uniforms(key, jcfg, R, teng.n_pad))
    assert colored_sweeps.launches == before

    assert tr.phase_labels == jr.phase_labels == ["C", "NC", "ALL"] * 2
    assert tr.phase_lengths == jr.phase_lengths
    np.testing.assert_array_equal(tr.all_clusters, jr.all_clusters)
    assert tr.all_clusters.size > 0
    np.testing.assert_array_equal(tr.m_best, jr.m_best)
    np.testing.assert_array_equal(tr.m_final, jr.m_final)
    np.testing.assert_allclose(tr.energy_overall, jr.energy_overall,
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(tr.min_energy, jr.min_energy, rtol=0,
                               atol=1e-9)
    if record_m:
        np.testing.assert_array_equal(tr.M_overall, jr.M_overall)
    else:
        assert tr.M_overall is None and jr.M_overall is None


def test_per_chain_clusters_match_jax():
    prob = chimera_graph(2, 2, seed=5).normalized()[0]
    rng = np.random.default_rng(2)
    m_star = np.where(rng.random((3, prob.n)) < 0.5, -1.0, 1.0)
    jcfg, tcfg = jn.NMCConfig(**LBP), tn.NMCConfig(**LBP)
    for rows in (m_star, m_star[:1]):        # batched LBP, and one chain
        a = jn._per_chain_clusters(prob, rows, jcfg)
        b = tn._per_chain_clusters(prob, rows, tcfg, device="cpu",
                                   dtype=torch.float64)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_nmc_run_reaches_ground_state():
    prob = ea_2d(4, seed=0)                  # 16 spins, enumerable
    states = np.array(list(itertools.product([-1, 1], repeat=prob.n)), float)
    ground = prob.energy(states).min()
    cfg = tn.NMCConfig(num_sweeps_initial=300, num_sweeps_per_NMC_phase=50,
                       num_NMC_cycles=2, num_chains=8, use_coloring=True,
                       block_size=8, record_m=False, dtype="float64", **LBP)
    res = tn.nmc_run(prob, cfg, torch.Generator().manual_seed(0),
                     device="cpu")
    assert res.m_best.shape == (8, prob.n)
    np.testing.assert_allclose(res.min_energy, prob.energy(res.m_best),
                               atol=1e-12)
    assert res.min_energy.min() == pytest.approx(ground, abs=1e-9)
    assert res.norm_factor == 1.0


@pytest.mark.parametrize("clusters_once", [False, True])
def test_nmc_subroutine_above_sparse_threshold_matches_jax(clusters_once):
    """N = 32 > sparse_lbp_threshold = 16: both drivers extract clusters
    with edge-message LBP (JAX per chain, the port batched over chains);
    with JAX's uniforms replayed the runs agree as in the dense case."""
    prob = chimera_graph(2, 2, seed=3).normalized()[0]
    R = 4
    common = dict(num_sweeps_per_NMC_phase=6, num_NMC_cycles=2,
                  record_m=False, clusters_once=clusters_once,
                  sparse_lbp_threshold=16, use_coloring=True, block_size=8,
                  num_chains=R, **LBP)
    jcfg = jn.NMCConfig(dtype="float64", **common)
    tcfg = tn.NMCConfig(dtype="float64", **common)
    jeng = JaxEngine(prob, block_size=8, use_coloring=True,
                     dtype=jnp.float64)
    teng = SweepEngine.from_blocked_problem(
        interop.blocked_from_numpy(jeng.blocked),
        interop.problem_from_numpy(prob.J, prob.h), dtype="float64",
        device="cpu")
    rng = np.random.default_rng(8)
    m_star = np.where(rng.random((R, prob.n)) < 0.5, -1.0, 1.0)
    key = jax.random.PRNGKey(3)

    jr = jn.nmc_subroutine(jeng, prob, m_star, key, jcfg)
    tr = tn.nmc_subroutine(
        teng, teng.problem, m_star, None, tcfg,
        uniforms=nmc_phase_uniforms(key, jcfg, R, teng.n_pad))

    assert tr.phase_labels == jr.phase_labels
    np.testing.assert_array_equal(tr.all_clusters, jr.all_clusters)
    assert tr.all_clusters.size > 0
    np.testing.assert_array_equal(tr.m_best, jr.m_best)
    np.testing.assert_array_equal(tr.m_final, jr.m_final)
    np.testing.assert_allclose(tr.energy_overall, jr.energy_overall,
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(tr.min_energy, jr.min_energy, rtol=0,
                               atol=1e-9)


def test_per_chain_clusters_above_sparse_threshold_match_jax():
    prob = chimera_graph(2, 2, seed=5).normalized()[0]
    rng = np.random.default_rng(2)
    m_star = np.where(rng.random((3, prob.n)) < 0.5, -1.0, 1.0)
    jcfg = jn.NMCConfig(sparse_lbp_threshold=16, **LBP)
    tcfg = tn.NMCConfig(sparse_lbp_threshold=16, **LBP)
    for rows in (m_star, m_star[:1]):        # batched LBP, and one chain
        a = jn._per_chain_clusters(prob, rows, jcfg)
        b = tn._per_chain_clusters(prob, rows, tcfg, device="cpu",
                                   dtype=torch.float64)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_nmc_run_above_sparse_threshold_reaches_ground_state():
    prob = ea_2d(4, seed=0)                  # 16 spins, enumerable
    states = np.array(list(itertools.product([-1, 1], repeat=prob.n)), float)
    ground = prob.energy(states).min()
    cfg = tn.NMCConfig(num_sweeps_initial=300, num_sweeps_per_NMC_phase=50,
                       num_NMC_cycles=2, num_chains=8, use_coloring=True,
                       block_size=8, record_m=False, dtype="float64",
                       sparse_lbp_threshold=8, **LBP)
    res = tn.nmc_run(prob, cfg, torch.Generator().manual_seed(0),
                     device="cpu")
    np.testing.assert_allclose(res.min_energy, prob.energy(res.m_best),
                               atol=1e-12)
    assert res.min_energy.min() == pytest.approx(ground, abs=1e-9)


def test_cli_nmc_prints_the_jax_cli_keys(tmp_path, capsys):
    prob = ea_2d(4, seed=1)
    np.save(tmp_path / "J.npy", prob.J)
    np.save(tmp_path / "h.npy", prob.h)
    metrics = tmp_path / "m.jsonl"
    cli.main(["nmc", "--J", str(tmp_path / "J.npy"), "--h",
              str(tmp_path / "h.npy"), "--coloring", "--chains", "4",
              "--sweeps-initial", "100", "--sweeps-per-phase", "20",
              "--cycles", "1", "--block-size", "8", "--metrics",
              str(metrics), "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"min_energy", "min_energy_unnormalized", "num_chains"}
    assert out["num_chains"] == 4 and np.isfinite(out["min_energy"])
    kinds = [json.loads(line)["kind"]
             for line in metrics.read_text().splitlines()]
    assert kinds == ["sweeps", "clusters", "sweeps", "sweeps", "sweeps"]
