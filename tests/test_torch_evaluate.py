"""The port's evaluation harness (`evaluate_solver`, `make_pt_solver`,
`InstanceEval`, `EvalReport`) and the `evaluate` command against
nmc_tpu's: the same report from a deterministic solver, the same NPT
configuration from the standard solver, and an `evaluate --device cpu` run
that hits every instance of a small planted wishart folder (f32, as JAX's
`npt_run` cannot run in f64)."""

import json

import numpy as np
import pytest
import torch

from nmc_tpu import evaluation as jev
from nmc_tpu.models import npt as jnpt
from nmc_tpu_torch import cli
from nmc_tpu_torch import evaluation as tev
from nmc_tpu_torch.io.generators import wishart_planted
from nmc_tpu_torch.io.loaders import load_wishart
from nmc_tpu_torch.models import npt as tnpt


def write_wishart_folder(folder, n=12, count=3):
    """`count` planted wisharts in the reference's wishart dialect with
    their planted energies in gs_energies.txt."""
    folder.mkdir()
    lines = []
    for k in range(count):
        prob, t, _ = wishart_planted(n, 0.5, seed=k)
        name = f"wishart_planting_N_{n}_alpha_0.50_inst_{k + 1}.txt"
        iu, ju = np.nonzero(np.triu(prob.J, 1))
        (folder / name).write_text("".join(
            f"{i} {j} {float(-prob.J[i, j])!r}\n" for i, j in zip(iu, ju)))
        e = float(load_wishart(str(folder / name)).energy(t))
        lines.append(f"{name}\t{e!r}\n")
    (folder / "gs_energies.txt").write_text("".join(lines))
    return folder


def _stub(problem):
    """Deterministic: the normalized energy of the all-ones state, or a
    little below it, so that some instances hit and some miss."""
    J = np.asarray(problem.J)
    e = float(problem.energy(np.ones(problem.n))) / float(np.abs(J).max())
    return e - 1e-3 if problem.n % 2 else e + 1.0


def _report(report):
    d = json.loads(report.to_json())
    for inst in d["instances"]:
        assert inst.pop("seconds") >= 0
    assert d["summary"].pop("total_seconds") >= 0
    return d


@pytest.mark.parametrize("tolerance", [1e-6, 0.5])
def test_evaluate_solver_report_equals_jax(tmp_path, tolerance):
    folder = write_wishart_folder(tmp_path / "w", n=11)
    write_wishart_folder(tmp_path / "w12", n=12, count=2)
    insts = [*tev.wishart_folder_instances(str(folder)),
             *tev.wishart_folder_instances(str(tmp_path / "w12"))]
    jinsts = [*jev.wishart_folder_instances(str(folder)),
              *jev.wishart_folder_instances(str(tmp_path / "w12"))]
    mine = tev.evaluate_solver(insts, _stub, tolerance=tolerance,
                               sweeps_used=7)
    theirs = jev.evaluate_solver(jinsts, _stub, tolerance=tolerance,
                                 sweeps_used=7)
    assert _report(mine) == _report(theirs)
    assert mine.hit_rate == theirs.hit_rate
    assert mine.mean_residual == theirs.mean_residual
    assert isinstance(mine.instances[0], tev.InstanceEval)
    assert {i.hit for i in mine.instances} == ({True, False}
                                               if tolerance < 0.1 else {True})


def test_make_pt_solver_builds_jax_config(monkeypatch):
    """The same beta ladder, NMC flags and NPTConfig fields as JAX's
    standard solver; the port's runs on the device it was given, with a
    generator seeded by key_seed for every instance."""
    seen = {}

    def spy(tag):
        def run(problem, beta_list, doNMC, cfg, key, *a, **k):
            seen[tag] = (np.asarray(beta_list), list(doNMC), cfg, key, k)
            return type("R", (), {"min_energy": -1.0})()
        return run

    monkeypatch.setattr(jnpt, "npt_run", spy("jax"))
    monkeypatch.setattr(tnpt, "npt_run", spy("torch"))
    kw = dict(num_replicas=10, beta_min=0.2, beta_max=6.0, sweeps=300,
              swap_attempts=9, key_seed=5, block_size=64,
              use_coloring=True, nmc_coldest=2, num_cycles=3)
    prob = wishart_planted(8, 0.5, seed=0)[0]
    assert tev.make_pt_solver(device="cpu", **kw)(prob) == -1.0
    assert jev.make_pt_solver(**kw)(prob) == -1.0
    (bt, nt, ct, gen, kt), (bj, nj, cj, _, _) = seen["torch"], seen["jax"]
    np.testing.assert_array_equal(bt, bj)
    assert nt == nj == [False] * 8 + [True] * 2
    common = set(vars(ct)) & set(vars(cj))
    assert {"num_sweeps_MCMC", "num_swapping_pairs", "use_coloring",
            "max_iterations", "tolerance"} <= common
    assert {f: getattr(ct, f) for f in common} == \
        {f: getattr(cj, f) for f in common}
    assert kt == {"device": torch.device("cpu")}
    assert gen.initial_seed() == 5


def test_evaluate_cli_hits_planted_folder(tmp_path, capsys, monkeypatch):
    folder = write_wishart_folder(tmp_path / "wishart_planting_N_12")
    argv = ["evaluate", "--folder", str(folder), "--replicas", "8",
            "--sweeps", "300", "--swap-attempts", "5"]
    args = cli.build_parser().parse_args(argv)
    assert (args.device, args.family, args.replicas) == ("cuda", "wishart",
                                                         8)
    cli.main([*argv, "--device", "cpu", "--limit", "2"])
    rep = json.loads(capsys.readouterr().out)
    assert rep["summary"]["num_instances"] == 2
    assert rep["summary"]["hit_rate"] == 1.0
    assert [i["name"] for i in rep["instances"]] == sorted(
        p.name for p in folder.glob("*_inst_*.txt"))[:2]
    for inst in rep["instances"]:
        assert inst["found_energy"] <= inst["gs_energy"] + 1e-6 * abs(
            inst["gs_energy"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
