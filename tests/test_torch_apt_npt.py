"""The replica-exchange slice: the port's APT and NPT against nmc_tpu's.

Each port driver replays the JAX driver's draws (initial states, per-rung
or per-round uniforms rebuilt from its key splits, and NPT's host rng), so
on one instance and one layout the two runs agree: equal beta ladders,
swap records and states, energies to 1e-9 (APT in f64; NPT in f32, see
its test). The reference quirks the
JAX package keeps, checkpoint and resume, and the CLI keys are checked too.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmc_tpu.io.generators import chimera_graph
from nmc_tpu.models import apt as ja
from nmc_tpu.models import npt as jp
from nmc_tpu.ops.engine import SweepEngine as JaxEngine
from nmc_tpu.utils import checkpoint as jck
from nmc_tpu_torch import cli, interop
from nmc_tpu_torch.io.generators import ea_2d
from nmc_tpu_torch.models import apt as ta
from nmc_tpu_torch.models import npt as tp
from nmc_tpu_torch.ops.engine import SweepEngine
from nmc_tpu_torch.utils import checkpoint as tck

from torch_parity import apt_replay, npt_replay

# the CLI's LBP settings: a clamp strong enough that the first rung
# converges on these small instances
LBP = dict(lambda_start=3.0, tolerance=1e-8, max_iterations=200)


@pytest.mark.parametrize("use_coloring", [True, False])
def test_apt_preprocess_matches_jax(use_coloring):
    prob = chimera_graph(2, 2, seed=4)
    common = dict(num_sweeps_MCMC=16, num_sweeps_read=8, num_rng=4,
                  beta_start=0.5, alpha=1.25, beta_max=4.0, block_size=8,
                  use_coloring=use_coloring, dtype="float64")
    jcfg, tcfg = ja.APTConfig(**common), ta.APTConfig(**common)
    norm = prob.normalized()[0]
    jeng = JaxEngine(norm, block_size=8, use_coloring=use_coloring,
                     dtype=jnp.float64)
    teng = SweepEngine.from_blocked_problem(
        interop.blocked_from_numpy(jeng.blocked),
        interop.problem_from_numpy(norm.J, norm.h), dtype="float64",
        device="cpu")
    key = jax.random.PRNGKey(6)
    jr = ja.apt_preprocess(prob, jcfg, key, engine=jeng)
    m_init, rungs = apt_replay(key, jeng, jcfg)
    tr = ta.apt_preprocess(prob, tcfg, engine=teng, m_init=m_init,
                           uniforms=rungs)
    assert len(tr.beta) == len(jr.beta) > 2
    np.testing.assert_allclose(tr.beta, jr.beta, rtol=0, atol=1e-9)
    np.testing.assert_allclose(tr.sigma, jr.sigma, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(tr.final_states,
                                  np.asarray(jr.final_states))
    assert tr.norm_factor == jr.norm_factor


def _npt_setup(record, dtype="float64"):
    prob = chimera_graph(2, 2, seed=7)
    # close betas, so that swaps are accepted
    beta_list = np.array([0.2, 0.3, 0.4, 0.5])
    doNMC = [False, False, True, True]
    common = dict(num_sweeps_MCMC=24, num_sweeps_read=12, num_swap_attempts=4,
                  num_swapping_pairs=1, num_cycles=1, global_beta=2.5,
                  block_size=8, use_coloring=True, dtype=dtype,
                  record_last_round_m=record, **LBP)
    return prob, beta_list, doNMC, common


@pytest.mark.parametrize("record", [False, True])
def test_npt_run_matches_jax(record):
    """Two plain replicas (one engine call with beta_replica) and two NMC
    replicas (one batched nmc_subroutine), four swap rounds. In f32: the
    JAX npt_run cannot run in f64 (its initial states are a read-only
    view of a device array there, and the swap writes into them). On +-J
    couplings the energies are integers, exact in f32, so they still agree
    to 1e-9."""
    prob, beta_list, doNMC, common = _npt_setup(record, "float32")
    jcfg, tcfg = jp.NPTConfig(**common), tp.NPTConfig(**common)
    key = jax.random.PRNGKey(2)
    jr = jp.npt_run(prob, beta_list, doNMC, jcfg, key)
    jeng = JaxEngine(prob.normalized()[0], block_size=8, use_coloring=True,
                     dtype=jnp.float32)
    m_init, host_rng, rounds = npt_replay(key, jeng, jcfg, doNMC, np.float32)
    tr = tp.npt_run(prob, beta_list, doNMC, tcfg, device="cpu",
                    m_init=m_init, host_rng=host_rng, uniforms=rounds)
    np.testing.assert_array_equal(tr.swap_attempted, jr.swap_attempted)
    np.testing.assert_array_equal(tr.swap_accepted, jr.swap_accepted)
    np.testing.assert_array_equal(tr.swap_counts, jr.swap_counts)
    np.testing.assert_allclose(tr.Energy, jr.Energy, rtol=0, atol=1e-9)
    np.testing.assert_allclose(tr.energy_trace, jr.energy_trace, rtol=0,
                               atol=1e-9)
    assert tr.min_energy == pytest.approx(jr.min_energy, abs=1e-9)
    np.testing.assert_array_equal(tr.best_state, jr.best_state)
    assert tr.rounds_completed == jr.rounds_completed == 4
    assert tr.swap_counts.sum() > 0         # states were exchanged
    assert tr.acceptance_rate == jr.acceptance_rate
    if record:
        np.testing.assert_array_equal(tr.M, jr.M)
    else:
        assert tr.M is None and jr.M is None


def test_select_non_overlapping_pairs_matches_jax():
    pairs = [(i, i + 1) for i in range(1, 9)]
    a = jp.select_non_overlapping_pairs(pairs, 3, np.random.default_rng(4))
    b = tp.select_non_overlapping_pairs(pairs, 3, np.random.default_rng(4))
    assert a == b
    with pytest.raises(ValueError, match="non-overlapping"):
        tp.select_non_overlapping_pairs(pairs[:1], 2,
                                        np.random.default_rng(0))


def test_quirk_nmc_replicas_run_at_global_beta(monkeypatch):
    """As in the JAX package (tests/test_quirks.py): NPT's NMC replicas
    sample at global_beta, not at their tempering beta."""
    captured = {}
    orig = tp.nmc_subroutine

    def spy(engine, problem, m_star, generator, cfg, **kw):
        captured["global_beta"] = cfg.global_beta
        return orig(engine, problem, m_star, generator, cfg, **kw)

    monkeypatch.setattr(tp, "nmc_subroutine", spy)
    prob, _, _, common = _npt_setup(False)
    cfg = tp.NPTConfig(**dict(common, global_beta=7.5, num_swap_attempts=2))
    tp.npt_run(prob, [0.1, 0.2], [False, True], cfg,
               torch.Generator().manual_seed(0))
    assert captured["global_beta"] == 7.5     # not 0.2


def test_quirk_acceptance_rate_is_round_fraction():
    res = tp.NPTResult(M=None, Energy=np.zeros(2),
                       energy_trace=np.zeros((2, 1)), min_energy=0.0,
                       best_state=np.zeros(2),
                       swap_counts=np.array([0, 2, 1, 0.0]),
                       swap_attempted=np.zeros((4, 2)),
                       swap_accepted=np.zeros((4, 2)),
                       beta_list=np.array([1.0, 2.0]), norm_factor=1.0)
    assert res.acceptance_rate == 0.5  # 2 of 4 rounds, NOT 3/8 pair-rate


def test_npt_resume_matches_uninterrupted(tmp_path):
    """A checkpoint after round 4 of 6 (generator state, host rng, states,
    swap records) resumes into the run that never stopped."""
    prob, beta_list, doNMC, common = _npt_setup(False)
    base = dict(common, num_swap_attempts=6)
    full = tp.npt_run(prob, beta_list, doNMC, tp.NPTConfig(**base),
                      torch.Generator().manual_seed(5))
    ck = str(tmp_path / "npt.npz")
    tp.npt_run(prob, beta_list, doNMC,
               tp.NPTConfig(**base, checkpoint_path=ck, checkpoint_every=4),
               torch.Generator().manual_seed(5))
    _, step, _ = tck.load_checkpoint(ck)
    assert step == 4
    resumed = tp.npt_run(prob, beta_list, doNMC,
                         tp.NPTConfig(**base, checkpoint_path=ck, resume=True),
                         torch.Generator().manual_seed(5))
    for f in ("Energy", "energy_trace", "swap_counts", "swap_attempted",
              "swap_accepted", "best_state"):
        np.testing.assert_array_equal(getattr(resumed, f), getattr(full, f),
                                      err_msg=f)
    assert resumed.min_energy == full.min_energy
    assert resumed.rounds_completed == full.rounds_completed == 6


def test_checkpoint_copy_reads_and_writes_the_jax_format(tmp_path):
    state = {"m": np.ones((3, 4)), "generator": np.arange(16, dtype=np.uint8),
             "best": {"e": -3.5, "idx": 7}, "trace": [np.arange(3), None]}
    for save, load in ((jck.save_checkpoint, tck.load_checkpoint),
                       (tck.save_checkpoint, jck.load_checkpoint)):
        path = str(tmp_path / f"{save.__module__}.npz")
        save(path, state, step=3, extra={"rng": {"a": 1}})
        got, step, extra = load(path)
        assert step == 3 and extra == {"rng": {"a": 1}}
        np.testing.assert_array_equal(got["generator"], state["generator"])
        assert got["best"] == state["best"] and got["trace"][1] is None


def test_generator_state_round_trips_through_a_checkpoint(tmp_path):
    g = torch.Generator().manual_seed(3)
    path = str(tmp_path / "g.npz")
    tck.save_checkpoint(path, {"generator": g.get_state().numpy()})
    want = torch.rand(5, generator=g)
    snap, _, _ = tck.load_checkpoint(path)
    g2 = torch.Generator().manual_seed(99)
    g2.set_state(torch.as_tensor(snap["generator"]))
    torch.testing.assert_close(torch.rand(5, generator=g2), want, rtol=0,
                               atol=0)


def _cli(capsys, argv):
    cli.main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_apt_and_npt_print_the_jax_cli_keys(tmp_path, capsys):
    prob = ea_2d(4, seed=1)
    np.save(tmp_path / "J.npy", prob.J)
    problem = ["--J", str(tmp_path / "J.npy"), "--coloring",
               "--block-size", "8", "--device", "cpu"]
    out = _cli(capsys, ["apt", *problem, "--sweeps", "20", "--sweeps-read",
                        "10", "--chains", "4", "--beta-max", "3",
                        "--out-dir", str(tmp_path / "apt")])
    assert set(out) == {"num_rungs", "beta"}
    assert out["num_rungs"] == len(out["beta"]) >= 2
    beta_list = tmp_path / "apt" / "beta_list_python.npy"
    np.testing.assert_allclose(np.load(beta_list), out["beta"], atol=1e-6)
    metrics = tmp_path / "npt.jsonl"
    out = _cli(capsys, ["npt", *problem, "--beta-list", str(beta_list),
                        "--nmc-coldest", "1", "--sweeps", "24",
                        "--sweeps-read", "12", "--swap-attempts", "2",
                        "--cycles", "1", "--metrics", str(metrics)])
    assert set(out) == {"Energy", "min_energy", "min_energy_unnormalized",
                        "acceptance_rate"}
    assert len(out["Energy"]) == len(np.load(beta_list))
    kinds = [json.loads(line)["kind"]
             for line in metrics.read_text().splitlines()]
    assert kinds.count("swap") == 2


def test_configs_carry_the_jax_fields():
    """Every field of the JAX configs exists in the port's, with the same
    default, except the TPU precision knob and the reference's hash-table
    no-op."""
    for j, t in ((ja.APTConfig, ta.APTConfig), (jp.NPTConfig, tp.NPTConfig)):
        jf = {f.name: f.default for f in dataclasses.fields(j)}
        tf = {f.name: f.default for f in dataclasses.fields(t)}
        assert set(jf) - set(tf) == {"precision", "use_hash_table"}
        assert all(tf[k] == v for k, v in jf.items() if k in tf)
