"""The port's staged portfolio solver (`nmc_tpu_torch/portfolio.py`) and its
`solve` and `refine` subcommands, against nmc_tpu's.

With the MCMC stage off, `portfolio_solve` is host code and equals JAX's
stage for stage (names, energies, hits) and state for state on a planted
wishart N = 16 and on a tree-decorated contrived instance (presolve, back
substitution). With MCMC on (the icm arm through the plain K4 twin on the
CPU) it hits a 16-spin chimera instance's ground state, and a contrived
instance's result re-verifies in f64 in the original space. The commands
print the JAX commands' JSON keys and return their exit codes; without a
card they raise unless `--device cpu` is given.
"""

import itertools
import json

import numpy as np
import pytest
import torch

from nmc_tpu import cli as jcli
from nmc_tpu import portfolio as jport
from nmc_tpu.core.problem import IsingProblem as JProblem
from nmc_tpu_torch import cli
from nmc_tpu_torch import portfolio as tport
from nmc_tpu_torch.exact_chimera import solve_exact_chimera
from nmc_tpu_torch.io.generators import (chimera_graph,
                                         contrived_wishart_backbone,
                                         wishart_planted)


def _jprob(prob):
    return JProblem(prob.J, prob.h)


def _same_result(a, b):
    assert a.name == b.name and a.n == b.n and a.hit == b.hit
    assert a.energy_raw == b.energy_raw and a.target_raw == b.target_raw
    np.testing.assert_array_equal(a.state, b.state)
    assert [s.stage for s in a.stages] == [s.stage for s in b.stages]
    for sa, sb in zip(a.stages, b.stages):
        assert (sa.energy_raw, sa.hit, sa.detail) == \
            (sb.energy_raw, sb.hit, sb.detail)


@pytest.mark.parametrize("spectral, target", [
    (True, "planted"), ("auto", "planted"), (True, None), (False, "low")])
def test_portfolio_without_mcmc_equals_jax(spectral, target):
    prob, t, e = wishart_planted(16, 0.5, seed=3)
    target_raw = {"planted": e, None: None, "low": e - 100.0}[target]
    kw = dict(name="w16", sweeps=0, spectral=spectral, dm_starts=64,
              dm_iters=100)
    a = tport.portfolio_solve(prob, target_raw, **kw)
    b = jport.portfolio_solve(_jprob(prob), target_raw, **kw)
    _same_result(a, b)
    assert abs(prob.energy(a.state) - a.energy_raw) < 1e-12
    if spectral is True and target == "planted":
        assert a.hit and [s.stage for s in a.stages] == ["presolve",
                                                         "spectral"]


def test_portfolio_presolve_back_substitution_equals_jax():
    prob, t, e = contrived_wishart_backbone(8, alpha=0.5, seed=2)
    kw = dict(name="cwb8", sweeps=0, dm_starts=64, dm_iters=200)
    a = tport.portfolio_solve(prob, None, **kw)
    b = jport.portfolio_solve(_jprob(prob), None, **kw)
    _same_result(a, b)
    assert a.stages[0].detail["core_n"] < prob.n
    assert a.state.shape == (prob.n,)
    assert abs(prob.energy(a.state) - a.energy_raw) < 1e-12
    assert a.energy_raw == pytest.approx(e, abs=1e-9)     # planted


def _ground_state(prob):
    S = np.array(list(itertools.product([-1.0, 1.0], repeat=prob.n)))
    E = prob.energy(S)
    return float(E.min())


def test_portfolio_mcmc_hits_a_chimera_instance():
    """The icm arm seeded by spectral candidates (the spectral stage is
    skipped: degree 5 <= 16), through the K4 twin on the CPU."""
    prob = chimera_graph(1, 2, seed=4)
    gs = _ground_state(prob)
    res = tport.portfolio_solve(
        prob, gs, name="c16", sweeps=480, coloring=True, tree=False,
        dm_starts=64, dm_iters=100,
        device="cpu", mcmc_overrides=dict(replicas=8, chunk_rounds=1,
                                          sweeps_per_phase=16, num_cycles=1))
    assert res.hit and res.energy_raw == gs
    assert [s.stage for s in res.stages] == ["presolve", "mcmc:icm"]
    assert res.stages[-1].detail["rounds"] >= 1
    assert abs(prob.energy(res.state) - gs) < 1e-12


def test_portfolio_mcmc_on_a_peeled_core_reverifies_in_f64():
    """No target: the whole budget is spent on the 2-core (plain route, an
    uncoloured layout), and the back-substituted state's f64 energy is the
    reported one."""
    prob, t, e = contrived_wishart_backbone(4, alpha=0.5, seed=1)
    res = tport.portfolio_solve(
        prob, None, name="cwb4", sweeps=48, spectral=True, dm_starts=16,
        dm_iters=40, device="cpu",
        mcmc_overrides=dict(replicas=4, subreplicas=2, sweeps_per_phase=8,
                            num_cycles=1))
    assert [s.stage for s in res.stages] == ["presolve", "spectral",
                                             "mcmc:icm"]
    assert res.stages[0].detail["core_n"] == 4 and not res.hit
    assert res.stages[-1].detail["rounds"] == 2
    assert abs(prob.energy(res.state) - res.energy_raw) < 1e-12
    assert res.energy_raw <= e + 1e-9
    with pytest.raises(ValueError, match="unknown campaign knob"):
        tport.portfolio_solve(prob, None, sweeps=576, device="cpu",
                              mcmc_overrides=dict(no_such_knob=1))


def _write_wishart_folder(folder, probs):
    """Instances {name: (prob, gs)} in the wishart dialect (0-indexed,
    negated couplings) with gs_energies.txt."""
    folder.mkdir(parents=True)
    lines = []
    for name, (prob, gs) in probs.items():
        iu, ju = np.nonzero(np.triu(prob.J, 1))
        (folder / name).write_text("".join(
            f"{i} {j} {float(-prob.J[i, j])!r}\n" for i, j in zip(iu, ju)))
        lines.append(f"{name}\t{gs!r}\n")
    (folder / "gs_energies.txt").write_text("".join(lines))


def _jax_ns(argv):
    """The port's parsed namespace, with the JAX command's --cpu."""
    ns = cli.build_parser().parse_args(argv)
    ns.cpu = False
    return ns


def _run_both(argv, capsys):
    rc = cli.main(argv)
    mine = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ns = _jax_ns(argv)
    jrc = getattr(jcli, ns.fn.__name__)(ns)
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return rc, mine, jrc, theirs


@pytest.mark.parametrize("case", ["hit", "missed", "no_target"])
def test_solve_cli_prints_jax_keys_and_exit_codes(tmp_path, capsys, case):
    prob, t, e = wishart_planted(16, 0.5, seed=3)
    folder = tmp_path / "wishart_planting_N_16_alpha_0.50"
    name = "wishart_planting_N_16_alpha_0.50_inst_1.txt"
    _write_wishart_folder(folder, {name: (prob, e)})
    if case == "no_target":
        (folder / "gs_energies.txt").unlink()
    argv = ["solve", str(folder / name), "--sweeps", "0", "--dm-starts",
            "64", "--dm-iters", "100", "--force-spectral", "--device", "cpu",
            "--save-state", str(tmp_path / "s.txt")]
    if case == "missed":
        argv += ["--target", str(e - 50.0)]
    rc, mine, jrc, theirs = _run_both(argv, capsys)
    assert rc == jrc == {"hit": 0, "missed": 1, "no_target": 0}[case]
    assert set(mine) == set(theirs) == {"name", "n", "kind", "energy_raw",
                                        "target_raw", "hit", "wall_seconds",
                                        "stages"}
    assert [set(s) for s in mine["stages"]] == \
        [set(s) for s in theirs["stages"]]
    for k in ("name", "n", "kind", "energy_raw", "target_raw", "hit"):
        assert mine[k] == theirs[k]
    assert mine["kind"] == "wishart"
    assert abs(prob.energy(np.loadtxt(tmp_path / "s.txt"))
               - mine["energy_raw"]) < 1e-12


def _write_chimera(path, prob):
    rows = [f"{i + 1} {i + 1} {float(-prob.h[i])!r}" for i in range(prob.n)
            if prob.h[i]]
    iu, ju = np.nonzero(np.triu(prob.J, 1))
    rows += [f"{i + 1} {j + 1} {float(-prob.J[i, j])!r}"
             for i, j in zip(iu, ju)]
    path.write_text("\n".join(rows) + "\n")


@pytest.mark.parametrize("case", ["hit", "missed", "no_target"])
def test_refine_cli_prints_jax_keys_and_exit_codes(tmp_path, capsys, case):
    prob = chimera_graph(2, 2, seed=3)
    path = tmp_path / "001.txt"
    _write_chimera(path, prob)
    e, s = solve_exact_chimera(prob)
    s0 = np.asarray(s, np.float64).copy()
    s0[[1, 9, 20]] *= -1
    np.savetxt(tmp_path / "s0.txt", s0, fmt="%d")
    argv = ["refine", str(path), "--kind", "chimera", "--state",
            str(tmp_path / "s0.txt"), "--ils-seconds", "0", "--device", "cpu"]
    if case != "no_target":
        argv += ["--target", str(e if case == "hit" else e - 50.0)]
    rc, mine, jrc, theirs = _run_both(argv, capsys)
    assert rc == jrc == {"hit": 0, "missed": 1, "no_target": 0}[case]
    assert set(mine) == set(theirs)
    mine.pop("seconds"), theirs.pop("seconds")
    assert mine == theirs
    assert mine["hit"] is {"hit": True, "missed": False,
                           "no_target": None}[case]


@pytest.mark.parametrize("sub", ["solve", "refine"])
def test_solve_and_refine_default_to_cuda(sub, tmp_path, monkeypatch):
    path = tmp_path / "001.txt"
    _write_chimera(path, chimera_graph(1, 2, seed=0))
    args = cli.build_parser().parse_args([sub, str(path)])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [sub, str(path), "--kind", "chimera", "--sweeps", "0"] \
        if sub == "solve" else [sub, str(path), "--state", str(path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


def test_solve_arm_auto_follows_the_family(tmp_path, monkeypatch, capsys):
    seen = []

    def fake(prob, target, **kw):
        seen.append((kw["arm"], kw["coloring"], kw["device"]))
        return tport.SolveResult("x", prob.n, 0.0, np.ones(prob.n), None,
                                 False, 0.0, [])

    monkeypatch.setattr(tport, "portfolio_solve", fake)
    path = tmp_path / "001.txt"
    _write_chimera(path, chimera_graph(1, 2, seed=0))
    for kind, arm in (("chimera", "icm"), ("dcl", "hybrid"),
                      ("wishart", "icm")):
        cli.main(["solve", str(path), "--kind", kind, "--device", "cpu"])
        assert seen[-1] == (arm, kind != "wishart", torch.device("cpu"))
    capsys.readouterr()
