"""The port's `generate` command, instance writers and the generators it
added (`ea_3d`, `contrived_wishart_backbone_reference`,
`emit_contrived_ensemble`) against nmc_tpu's: the same seed writes the
same bytes and prints the same JSON."""

import json

import numpy as np
import pytest

from nmc_tpu import cli as jcli
from nmc_tpu.core.problem import IsingProblem as JProblem
from nmc_tpu.io import generators as jgen
from nmc_tpu.io import writers as jw
from nmc_tpu_torch import cli
from nmc_tpu_torch.core.problem import IsingProblem
from nmc_tpu_torch.io import generators as tgen
from nmc_tpu_torch.io import loaders as tl
from nmc_tpu_torch.io import writers as tw


@pytest.mark.parametrize("kind, extra", [
    ("sk", ["--n", "24"]), ("ea2d", ["--L", "5"]), ("ea3d", ["--L", "3"]),
    ("wishart", ["--n", "20", "--alpha", "0.3"]),
    ("contrived", ["--n", "6"]), ("contrived-ref", ["--n", "5"]),
])
def test_generate_cli_equals_jax(tmp_path, capsys, kind, extra):
    argv = ["generate", "--kind", kind, *extra, "--seed", "3"]
    out_t, out_j = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    cli.main([*argv, "--out", out_t])
    rec_t = json.loads(capsys.readouterr().out)
    jcli.cmd_generate(cli.build_parser().parse_args([*argv, "--out", out_j]))
    rec_j = json.loads(capsys.readouterr().out)
    assert (tmp_path / "t.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()
    assert rec_t.pop("out") == out_t and rec_j.pop("out") == out_j
    assert rec_t == rec_j and rec_t["edges"] > 0
    assert not hasattr(cli.build_parser().parse_args([*argv, "--out", out_t]),
                       "device")


def test_writers_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    J = np.triu(rng.normal(size=(7, 7)) * (rng.random((7, 7)) < 0.5), 1)
    h = rng.normal(size=7) * (rng.random(7) < 0.5)
    t, j = IsingProblem(J + J.T, h), JProblem(J + J.T, h)
    for kw in ({}, {"negate": False}, {"include_fields": False}):
        tw.save_edgelist(str(tmp_path / "t.txt"), t, **kw)
        jw.save_edgelist(str(tmp_path / "j.txt"), j, **kw)
        assert (tmp_path / "t.txt").read_bytes() == \
            (tmp_path / "j.txt").read_bytes()
    tw.save_npy_pair(str(tmp_path / "t_"), t)
    jw.save_npy_pair(str(tmp_path / "j_"), j)
    for name in ("J.npy", "h.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / f"t_{name}"),
                                      np.load(tmp_path / f"j_{name}"))
    back = tl.load_wishart(str(tmp_path / "t.txt"))    # negated on load
    np.testing.assert_allclose(back.J, t.J, rtol=1e-11)


@pytest.mark.parametrize("pm", [False, True])
@pytest.mark.parametrize("periodic", [False, True])
def test_ea_3d_equals_jax(pm, periodic):
    a = tgen.ea_3d(3, seed=4, pm=pm, periodic=periodic)
    b = jgen.ea_3d(3, seed=4, pm=pm, periodic=periodic)
    np.testing.assert_array_equal(a.J, b.J)
    np.testing.assert_array_equal(a.h, b.h)
    assert a.name == b.name


@pytest.mark.parametrize("kw", [{}, {"num_remove_edges": 3},
                                {"num_remove_edges": 3,
                                 "remove_after_core": True}])
def test_contrived_reference_equals_jax(kw):
    a = tgen.contrived_wishart_backbone_reference(6, 2, 0.5, seed=9,
                                                  num_cross_connections=8,
                                                  **kw)
    b = jgen.contrived_wishart_backbone_reference(6, 2, 0.5, seed=9,
                                                  num_cross_connections=8,
                                                  **kw)
    np.testing.assert_array_equal(a.J, b.J)
    np.testing.assert_array_equal(a.h, b.h)
    assert a.name == b.name and a.n == 42


def test_emit_contrived_ensemble_equals_jax(tmp_path):
    kw = dict(n_backbone=4, levels=2, alpha=0.5, num_cross_connections=4)
    pt = tgen.emit_contrived_ensemble(str(tmp_path / "t"), 3, **kw)
    pj = jgen.emit_contrived_ensemble(str(tmp_path / "j"), 3, **kw)
    assert [p.split("/t/")[1] for p in pt] == [p.split("/j/")[1] for p in pj]
    for a, b in zip(pt, pj):
        assert open(a, "rb").read() == open(b, "rb").read()
    # with cores read from a wishart folder, as the reference's main() does
    cores = tmp_path / "cores"
    cores.mkdir()
    for i in (1, 2):
        prob = tgen.wishart_planted(4, 0.5, seed=i)[0]
        tw.save_edgelist(
            str(cores / f"wishart_planting_N_4_alpha_0.50_inst_{i}.txt"),
            prob)
    pt = tgen.emit_contrived_ensemble(str(tmp_path / "t2"), 2,
                                      cores_folder=str(cores), **kw)
    pj = jgen.emit_contrived_ensemble(str(tmp_path / "j2"), 2,
                                      cores_folder=str(cores), **kw)
    for a, b in zip(pt, pj):
        assert open(a, "rb").read() == open(b, "rb").read()
    assert tl.load_contrived_tree(pt[0]).n == 28
