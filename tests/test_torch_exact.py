"""The port's exact solver (`nmc_tpu_torch.exact`, `exact_chimera`) and its
`exact` command against the JAX package's.

The host helpers are copies and must be array-equal. The tiers run at
N = 15-18 on the CPU: `solve_exact_host`, `solve_exact_device(device="cpu")`
and `solve_exact_fused(device="cpu")` (the fused tier through the K6/K7
twins) against `solve_exact_host`, `solve_exact_device` and
`solve_exact_pallas(interpret=True)`. On integer couplings every tier is
exact, so energies must be bitwise equal; the states must be equal too,
since each port tier breaks ties as its JAX tier does (lowest index), and on
a planted wishart the ground state is unique up to the pinned flip. The
chimera DP is a numpy copy: bitwise equal on synthetic chimeras. The
`exact` command writes the JAX command's record on a generated wishart
folder (all keys but the wall time equal).
"""

import json
import os

import numpy as np
import pytest
import torch

from nmc_tpu import IsingProblem as JProblem
from nmc_tpu import cli as jcli
from nmc_tpu import exact as jex
from nmc_tpu import exact_chimera as jch
from nmc_tpu.io.generators import wishart_planted as j_wishart
from nmc_tpu_torch import cli
from nmc_tpu_torch import exact as tex
from nmc_tpu_torch import exact_chimera as tch
from nmc_tpu_torch.core.problem import IsingProblem as TProblem
from nmc_tpu_torch.io.generators import wishart_planted as t_wishart
from nmc_tpu_torch.ops import exact_cuda as ec

from test_exact_chimera import synth_chimera


def _integer(n, scale, seed, fields=False):
    rng = np.random.default_rng(seed)
    J = np.round(scale * rng.normal(size=(n, n)))
    J = np.triu(J, 1)
    J = J + J.T
    h = np.round(scale * rng.normal(size=n)) if fields else np.zeros(n)
    return J, h


def _pair(J, h):
    return JProblem(J, h), TProblem(J, h)


def test_host_helpers_equal(rng):
    J, h = _integer(13, 10, 1, fields=True)
    for k, off, cnt in ((5, 0, None), (7, 3, 20), (0, 0, None)):
        np.testing.assert_array_equal(tex.signs_table(k, off, cnt),
                                      jex.signs_table(k, off, cnt))
    assert tex._split(J, h) == jex._split(J, h)
    assert tex.exact_energy_bound(J, h) == jex.exact_energy_bound(J, h)
    assert tex.exact_energy_bound(J) == jex.exact_energy_bound(J)
    S = tex.signs_table(6, dtype=np.float64)
    np.testing.assert_array_equal(tex._half_energies(J[:6, :6], h[:6], S),
                                  jex._half_energies(J[:6, :6], h[:6], S))
    for dtype in (np.float32, np.float64):
        for x, y in zip(tex._b_tables(J, h, 6, 7, block=32, dtype=dtype),
                        jex._b_tables(J, h, 6, 7, block=32, dtype=dtype)):
            np.testing.assert_array_equal(x, y)
    Jd = J.copy()
    Jd[0, 0] = 2.0
    for JJ, hh in ((J, h), (J + 0.5, h), (Jd, h), (J, h + 0.25)):
        assert tex._integer_problem(JJ, hh) == jex._integer_problem(JJ, hh)


CASES = {
    # (n, coupling scale, fields): integer couplings, exact in every tier
    "int16": (16, 10, False),
    "int15_fields": (15, 10, True),     # h != 0: no pinned spin
    "int17_ties": (17, 1, False),       # couplings in {-3..3}: many ties
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiers_match_jax_bitwise_on_integer_couplings(case):
    n, scale, fields = CASES[case]
    J, h = _integer(n, scale, 7 + n, fields)
    jp, tp = _pair(J, h)
    e_h, s_h = jex.solve_exact_host(jp)
    results = {
        "host": (tex.solve_exact_host(tp), (e_h, s_h)),
        "device": (tex.solve_exact_device(tp, block_a=32, block_b=64,
                                          device="cpu"),
                   jex.solve_exact_device(jp, block_a=32, block_b=64)),
    }
    for planes in ("auto", "off"):
        results[f"fused_{planes}"] = (
            tex.solve_exact_fused(tp, block_a=48, block_b=64, planes=planes,
                                  device="cpu"),
            jex.solve_exact_pallas(jp, block_a=48, block_b=64, planes=planes,
                                   interpret=True))
    for tier, ((e_t, s_t), (e_j, s_j)) in results.items():
        assert e_t == e_j == e_h, tier
        np.testing.assert_array_equal(s_t, s_j, err_msg=tier)
        assert float(tp.energy(s_t)) == e_t


def test_tiers_match_jax_on_planted_wishart():
    """Float couplings: the planted state is the unique ground state up to
    the flip the tiers pin, so every tier returns it."""
    (jp, t, gs), (tp, t2, gs2) = j_wishart(18, 0.5, seed=7), \
        t_wishart(18, 0.5, seed=7)
    assert gs == gs2
    got = [tex.solve_exact_host(tp),
           tex.solve_exact_device(tp, block_a=64, block_b=128, device="cpu"),
           tex.solve_exact_fused(tp, block_a=64, block_b=128, device="cpu")]
    want = [jex.solve_exact_host(jp),
            jex.solve_exact_device(jp, block_a=64, block_b=128),
            jex.solve_exact_pallas(jp, block_a=64, block_b=128,
                                   interpret=True)]
    for (e_t, s_t), (e_j, s_j) in zip(got, want):
        assert e_t == e_j
        assert abs(e_t - gs) <= 1e-9 * abs(gs)
        np.testing.assert_array_equal(s_t, t)
        np.testing.assert_array_equal(s_j, t)


def test_fused_multiplane_and_guards():
    """Couplings near 3e6 need 4 digit planes and pass the f32 window:
    planes='on' (K7) equals the JAX pallas tier and the host tier; 'off'
    (K6) and the device tier refuse with the JAX messages."""
    J, h = _integer(16, 3_000_000, 3)
    jp, tp = _pair(J, h)
    assert float(1 << 24) < tex.exact_energy_bound(J) < float(1 << 29)
    a, b = tex._split(J, h)
    assert ec.int8_planes(tex._b_tables(J, h, a, b, dtype=np.float64)[1]
                          ).shape[0] == 4
    e_h, _ = jex.solve_exact_host(jp)
    e_t, s_t = tex.solve_exact_fused(tp, block_a=64, block_b=128,
                                     planes="on", device="cpu")
    e_j, s_j = jex.solve_exact_pallas(jp, block_a=64, block_b=128,
                                      planes="on", interpret=True)
    assert e_t == e_j == e_h
    np.testing.assert_array_equal(s_t, s_j)
    with pytest.raises(ValueError, match="2\\^24"):
        tex.solve_exact_fused(tp, planes="off", device="cpu")
    with pytest.raises(ValueError, match="2\\^24"):
        tex.solve_exact_device(tp, device="cpu")
    fp, _, _ = t_wishart(14, 0.5, seed=3)
    with pytest.raises(ValueError, match="integer-coupled"):
        tex.solve_exact_fused(fp, planes="on", device="cpu")
    with pytest.raises(ValueError, match="auto\\|on\\|off"):
        tex.solve_exact_fused(fp, planes="yes", device="cpu")


def test_fused_routes_to_k7_or_k6_on_the_cpu(monkeypatch):
    """planes='auto' takes the int8 twin on integer couplings, 'off' the
    f32 twin; on the CPU neither launches a kernel."""
    J, h = _integer(14, 10, 5)
    _, tp = _pair(J, h)
    calls = []
    for name, tag in (("mitm_min_reference", "K6"),
                      ("mitm_min_i8_reference", "K7")):
        def spy(*a, _f=getattr(ec, name), _tag=tag, **k):
            calls.append(_tag)
            return _f(*a, **k)
        monkeypatch.setattr(ec, name, spy)
    before = (ec.mitm_min.launches, ec.mitm_min_i8.launches)
    e7, _ = tex.solve_exact_fused(tp, planes="auto", device="cpu")
    e6, _ = tex.solve_exact_fused(tp, planes="off", device="cpu")
    assert calls == ["K7", "K6"] and e7 == e6
    assert (ec.mitm_min.launches, ec.mitm_min_i8.launches) == before


def test_fused_timings_split_the_wall():
    """A `timings` dict gets the four steps of the fused tier; the result is
    the same with or without it."""
    J, h = _integer(14, 10, 6)
    _, tp = _pair(J, h)
    timings = {}
    e1, s1 = tex.solve_exact_fused(tp, device="cpu", timings=timings)
    e0, s0 = tex.solve_exact_fused(tp, device="cpu")
    assert e1 == e0
    np.testing.assert_array_equal(s1, s0)
    assert sorted(timings) == ["kernel", "tables", "upload", "verify"]
    assert all(v >= 0.0 for v in timings.values())


@pytest.mark.parametrize("n,dev,want", [
    (28, "cuda", "host"), (29, "cuda", "pallas"), (40, "cuda", "pallas"),
    (28, "cpu", "host"), (29, "cpu", "device"), (40, "cpu", "device"),
    (41, "cuda", "pallas"), (41, "cpu", "pallas")])
def test_exact_auto_backend(n, dev, want):
    """`auto` takes the fused kernels from n = 29 to 40 on a CUDA card and
    the JAX command's torch tiles on the CPU; above 40 the fused tier when
    the couplings are not a chimera layout."""
    J, h = _integer(n, 10, n)
    assert cli.auto_exact_backend(TProblem(J, h), torch.device(dev)) == want


def test_exact_auto_backend_takes_the_chimera_dp_above_40():
    jp = synth_chimera(3, 3, seed=4, fields=False)
    tp = TProblem(np.asarray(jp.J), np.asarray(jp.h))
    for dev in ("cuda", "cpu"):
        assert cli.auto_exact_backend(tp, torch.device(dev)) == "chimera"


def test_entry_points_default_to_cuda_and_enum_waits(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prob, _, _ = t_wishart(10, 0.5, seed=1)
    for fn in (tex.solve_exact_device, tex.solve_exact_fused):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(prob)
    # the enumeration tier is host code (numpy, scipy, the g++-built
    # enum.cpp): it needs no card and proves the optimum
    e, s, proved = tex.solve_exact_enum(prob, dm_starts=16, dm_iters=40)
    assert proved and e == tex.solve_exact_host(prob)[0]


@pytest.mark.parametrize("rows,cols,fields", [(1, 2, True), (2, 1, True),
                                              (2, 2, False), (1, 3, True)])
def test_chimera_dp_equals_jax(rows, cols, fields):
    jp = synth_chimera(rows, cols, seed=rows * 10 + cols, fields=fields)
    tp = TProblem(jp.J, jp.h)
    assert tch.chimera_layout(tp.J, rows, cols) == \
        jch.chimera_layout(jp.J, rows, cols) == (rows, cols)
    e_t, s_t = tch.solve_exact_chimera(tp, rows=rows, cols=cols)
    e_j, s_j = jch.solve_exact_chimera(jp, rows=rows, cols=cols)
    assert e_t == e_j
    np.testing.assert_array_equal(s_t, s_j)
    if tp.n <= 24:
        e_h, _ = tex.solve_exact_host(tp)
        assert abs(e_t - e_h) < 1e-9


def test_chimera_layout_rejects_like_jax(rng):
    J = rng.normal(size=(32, 32))
    J = 0.5 * (J + J.T)
    for bad in (J, np.zeros((12, 12))):
        with pytest.raises(ValueError) as j_err:
            jch.chimera_layout(bad)
        with pytest.raises(ValueError) as t_err:
            tch.chimera_layout(bad)
        assert str(t_err.value) == str(j_err.value)
    np.testing.assert_array_equal(tch._S16, jch._S16)


def _write_wishart_folder(folder):
    """Two planted wisharts in the reference's wishart dialect (0-indexed
    `i j w` lines with the loader's sign flip undone, values by repr so
    they load back exactly) and gs_energies.txt; one has float couplings,
    one integer couplings. Returns the instance paths."""
    from nmc_tpu_torch.io.loaders import load_wishart
    folder.mkdir()
    probs = {"wishart_planting_N_14_alpha_0.50_inst_1.txt":
             t_wishart(14, 0.5, seed=2)[0].J}
    J, _ = _integer(14, 3, 4)
    probs["wishart_planting_N_14_alpha_0.50_inst_2.txt"] = J
    gs = []
    for name, J in probs.items():
        iu, ju = np.nonzero(np.triu(J, 1))
        (folder / name).write_text("".join(
            f"{i} {j} {float(-J[i, j])!r}\n" for i, j in zip(iu, ju)))
        prob = load_wishart(str(folder / name))
        np.testing.assert_array_equal(prob.J, J)
        gs.append(f"{name}\t{tex.solve_exact_host(prob)[0]!r}\n")
    (folder / "gs_energies.txt").write_text("".join(gs))
    return [str(folder / name) for name in probs]


def _jax_record(path, backend, out):
    args = type("Args", (), dict(
        path=path, kind="auto", backend=backend, block_a=32, block_b=64,
        interpret=True, planes="auto", save_state=None, out=out, cpu=True))
    assert jcli.cmd_exact(args) == 0


@pytest.mark.parametrize("backend", ["host", "pallas", "device", "auto"])
def test_exact_cli_record_equals_jax(tmp_path, capsys, backend):
    paths = _write_wishart_folder(tmp_path / "wishart_planting_N_14")
    for path in paths:
        out_j, out_t = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
        state = str(tmp_path / "gs.txt")
        _jax_record(path, backend, out_j)
        rc = cli.main(["exact", path, "--backend", backend, "--block-a",
                       "32", "--block-b", "64", "--device", "cpu", "--out",
                       out_t, "--save-state", state])
        assert rc == 0
        rj = json.loads(open(out_j).readlines()[-1])
        rt = json.loads(open(out_t).readlines()[-1])
        assert rt.keys() == rj.keys() == {
            "name", "n", "kind", "backend", "planes", "energy_raw",
            "wall_seconds", "shipped_target", "matches_shipped"}
        rj.pop("wall_seconds"), rt.pop("wall_seconds")
        assert rt == rj
        assert rt["matches_shipped"] is True and rt["kind"] == "wishart"
        assert rt["backend"] == ("host" if backend == "auto" else backend)
        s = np.loadtxt(state)
        assert s.shape == (14,) and s[0] == 1.0
        assert os.path.basename(path) == rt["name"]
    # one line per instance from each command
    assert capsys.readouterr().out.count("matches_shipped") == 4


def test_exact_cli_takes_device_default_cuda(tmp_path, monkeypatch):
    (path, _) = _write_wishart_folder(tmp_path / "w")
    args = cli.build_parser().parse_args(["exact", path])
    assert args.device == "cuda" and args.backend == "auto"
    assert (args.block_a, args.block_b, args.planes) == (512, 4096, "auto")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["exact", path, "--backend", "host"])


def test_exact_cli_auto_takes_the_chimera_dp_above_40(tmp_path):
    """Above N = 40 `auto` routes a chimera layout to the tropical DP, as
    the JAX command does (a 3x3 chimera, 72 spins, written as a wishart
    file without a ground-truth file)."""
    jp = synth_chimera(3, 3, seed=4, fields=False)
    iu, ju = np.nonzero(np.triu(jp.J, 1))
    path = tmp_path / "chimera_72.txt"
    path.write_text("".join(f"{i} {j} {float(-jp.J[i, j])!r}\n"
                            for i, j in zip(iu, ju)))
    out_j, out_t = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    _jax_record(str(path), "auto", out_j)
    assert cli.main(["exact", str(path), "--device", "cpu", "--out",
                     out_t]) == 0
    rj = json.loads(open(out_j).readline())
    rt = json.loads(open(out_t).readline())
    rj.pop("wall_seconds"), rt.pop("wall_seconds")
    assert rt == rj
    assert rt["backend"] == "chimera" and rt["n"] == 72
    assert rt["shipped_target"] is None and rt["matches_shipped"] is None
