"""The port's beam tier (`beam_chimera.py`, `beam_chimera_cuda.py` and the
`beam` command) against nmc_tpu's on numpy-seeded synthetic chimeras.

The host beam, the strip refinement and the orientations are numpy copies:
their results equal JAX's. The device beam is torch's stable sorts in place
of `lax.sort`: on +-J and k/8 couplings, at beams small enough that states
are pruned and energies tie at the beam's edge, its (E_fin, parents,
combos) are array-equal to JAX's `_get_runner` at split 1, 2 and 4, on
grids of one, two and three key words. Then the counterparts of
tests/test_beam_chimera.py on the port, the `beam` command's record and
saved state against JAX's, and its device policy.
"""

import argparse
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmc_tpu import IsingProblem as JProblem
from nmc_tpu import beam_chimera as jbc
from nmc_tpu import beam_chimera_tpu as jbt
from nmc_tpu import cli as jcli
from nmc_tpu_torch import beam_chimera as tbc
from nmc_tpu_torch import beam_chimera_cuda as tbt
from nmc_tpu_torch import cli
from nmc_tpu_torch.core.problem import IsingProblem
from nmc_tpu_torch.exact_chimera import solve_exact_chimera
from nmc_tpu_torch.io.loaders import load_chimera

from test_exact_chimera import synth_chimera


def _pm(rows, cols, seed):
    """+-J couplings and +-1/0 fields on the synthetic chimera's edges."""
    p = synth_chimera(rows, cols, seed)
    return IsingProblem(np.sign(p.J), np.sign(np.round(p.h)))


def _k8(rows, cols, seed):
    """Couplings and fields rounded to multiples of 1/8."""
    p = synth_chimera(rows, cols, seed)
    return IsingProblem(np.round(p.J * 4) / 8, np.round(p.h * 4) / 8)


def _jp(prob):
    return JProblem(prob.J, prob.h)


# ---------------------------------------------------------------- host beam

def test_host_tables_and_keys_equal_jax():
    prob = synth_chimera(3, 4, seed=1)
    J, h = np.asarray(prob.J), np.asarray(prob.h)
    for r in range(3):
        for c in range(4):
            for a, b in zip(tbc._cell_tables(J, h, 3, 4, r, c),
                            jbc._cell_tables(J, h, 3, 4, r, c)):
                np.testing.assert_array_equal(a, b)
    groups = np.random.default_rng(0).integers(0, 16, (50, 21)).astype(
        np.uint8)
    for a, b in zip(tbc._pack_keys(groups), jbc._pack_keys(groups)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.uint64


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_orient_equals_jax(transpose, reverse):
    prob = synth_chimera(2, 3, seed=4)
    J, h = np.asarray(prob.J), np.asarray(prob.h)
    for a, b in zip(tbc._orient(J, h, 2, 3, transpose, reverse),
                    jbc._orient(J, h, 2, 3, transpose, reverse)):
        np.testing.assert_array_equal(a, b)


def test_host_beam_equals_jax():
    """The f32-selected host beam (pruning at beam 64), its best of four
    orientations and the window-2 strip descent from its state: energies,
    states and info equal JAX's."""
    prob = synth_chimera(3, 3, seed=5)
    e, s, info = tbc.solve_beam_chimera(prob, beam=64)
    ej, sj, ij = jbc.solve_beam_chimera(prob, beam=64)
    assert (e, info) == (ej, ij) and not info["exact"]
    np.testing.assert_array_equal(s, sj)
    e, s, info = tbc.solve_beam_chimera_multi(prob, beam=64)
    ej, sj, ij = jbc.solve_beam_chimera_multi(prob, beam=64)
    assert (e, info) == (ej, ij)
    np.testing.assert_array_equal(s, sj)
    e, s, moves = tbc.refine_strips(prob, s, window=2)
    ej, sj, mj = jbc.refine_strips(prob, sj, window=2)
    assert (e, moves) == (ej, mj)
    np.testing.assert_array_equal(s, sj)


def test_pipeline_equals_jax():
    prob = _pm(3, 3, seed=2)
    e, s, info = tbc.solve_chimera_pipeline(prob, beam=32)
    ej, sj, ij = jbc.solve_chimera_pipeline(_jp(prob), beam=32)
    assert (e, info) == (ej, ij) and info["strip_moves"] >= 0
    np.testing.assert_array_equal(s, sj)


# -------------------------------------------------------------- device beam

def _runner_args(prob, rows, cols):
    Jq, hq, _ = tbt.quantize_problem(prob)
    trans = tbt._int_cell_tables(Jq, hq, rows, cols)
    np.testing.assert_array_equal(
        trans, jbt._int_cell_tables(Jq, hq, rows, cols))
    cells = rows * cols
    c_seq = np.arange(cells, dtype=np.int32) % cols
    r_seq = np.arange(cells, dtype=np.int32) // cols
    return trans, (jnp.asarray(trans), jnp.asarray(c_seq),
                   jnp.asarray(r_seq == rows - 1),
                   jnp.asarray(c_seq == cols - 1))


@pytest.mark.parametrize("split", [1, 2, 4])
@pytest.mark.parametrize("make", [_pm, _k8], ids=["pmJ", "k8"])
@pytest.mark.parametrize("rows, cols, M", [(3, 3, 64), (2, 9, 128),
                                           (2, 16, 64)])
def test_device_runner_equals_jax(monkeypatch, make, split, rows, cols, M):
    """E_fin, parents and combos array-equal to `_get_runner(M, G, W,
    split)`. Grids of width 3, 9 and 16 pack one, two and three key words;
    the spy sees states pruned and energies tied at the beam's edge."""
    prob = make(rows, cols, seed=3)
    trans, jargs = _runner_args(prob, rows, cols)
    edges = []
    real = torch.sort

    def spy(key, **kwargs):
        out = real(key, **kwargs)
        if key.dtype == torch.int32 and key.numel() > M:   # the top-M sort
            edges.append(out.values[M - 1:M + 1].tolist())
        return out

    monkeypatch.setattr(torch, "sort", spy)
    E, parents, combos = tbt.run_beam(torch.from_numpy(trans), rows, cols,
                                      M, split)
    Ej, pj, cj = jbt._get_runner(M, cols + 1, cols, split)(*jargs)
    np.testing.assert_array_equal(E.numpy(), np.asarray(Ej))
    np.testing.assert_array_equal(parents.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(combos.numpy(), np.asarray(cj))
    assert E.dtype == torch.int32 and parents.dtype == torch.int32
    assert combos.dtype == torch.uint8
    assert any(b < tbt._INF for _, b in edges)        # a kept key dropped
    assert any(a == b < tbt._INF for a, b in edges)   # a tie at the edge


@pytest.mark.parametrize("beam", [64, 1024])
def test_device_solve_equals_jax(beam):
    prob = _k8(3, 2, seed=4)
    e, s, info = tbt.solve_beam_chimera_cuda(prob, rows=3, cols=2,
                                             beam=beam, device="cpu")
    ej, sj, ij = jbt.solve_beam_chimera_tpu(_jp(prob), rows=3, cols=2,
                                            beam=beam)
    assert (e, info) == (ej, ij)
    np.testing.assert_array_equal(s, sj)


def test_device_solve_default_device(monkeypatch):
    prob = _pm(2, 2, seed=1)
    e, s, info = tbt.solve_beam_chimera_cuda(prob, beam=256, device="cpu")
    assert info["e_int"] == round(e) and info["split"] == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbt.solve_beam_chimera_cuda(prob, beam=256)


# ------------------------- counterparts of tests/test_beam_chimera.py

@pytest.mark.parametrize("rows,cols", [(2, 2), (3, 2), (2, 3)])
def test_beam_exact_when_unpruned(rows, cols):
    prob = synth_chimera(rows, cols, seed=rows * 7 + cols)
    e_ref, _ = solve_exact_chimera(prob, rows=rows, cols=cols)
    cap = 16 ** (cols + 1)
    e, s, info = tbc.solve_beam_chimera(prob, rows=rows, cols=cols,
                                        beam=cap, expand_top=cap * 256)
    assert info["exact"]
    assert abs(e - e_ref) < 1e-9
    assert abs(float(prob.energy(s)) - e) < 1e-9


def test_beam_small_is_valid_upper_bound():
    prob = synth_chimera(3, 3, seed=5)
    e_ref, _ = solve_exact_chimera(prob)
    e, s, info = tbc.solve_beam_chimera(prob, beam=64)
    assert not info["exact"]
    assert abs(float(prob.energy(s)) - e) < 1e-9
    assert e >= e_ref - 1e-9


def test_pad_partial_raster():
    full = synth_chimera(2, 3, seed=3)
    n = full.n - 8
    part = IsingProblem(np.asarray(full.J)[:n, :n].copy(),
                        np.asarray(full.h)[:n].copy())
    padded, rows, cols, n_orig = tbc.pad_to_chimera_grid(part)
    assert (rows, cols, n_orig) == (2, 3, n)
    e_ref, _ = solve_exact_chimera(padded, rows=rows, cols=cols)
    e, s, _ = tbc.solve_beam_chimera(padded, rows=rows, cols=cols,
                                     beam=4096, expand_top=4096 * 256)
    assert abs(e - e_ref) < 1e-9
    assert abs(float(part.energy(s[:n])) - e) < 1e-9


def test_refine_strips_reaches_exact():
    prob = synth_chimera(4, 4, seed=2)
    e_ref, _ = solve_exact_chimera(prob)
    rng = np.random.default_rng(0)
    e, s, n_moves = tbc.refine_strips(
        prob, np.sign(rng.standard_normal(prob.n)), window=3)
    assert abs(float(prob.energy(s)) - e) < 1e-9
    assert e <= e_ref + 1e-9
    assert n_moves >= 1


def test_refine_strips_fixed_point_at_optimum():
    prob = synth_chimera(3, 3, seed=8)
    e_ref, s_ref = solve_exact_chimera(prob)
    e, s, n_moves = tbc.refine_strips(prob, s_ref, window=3)
    assert n_moves == 0 and abs(e - e_ref) < 1e-9


def test_refine_strips_device_sub_solver():
    """The `beam` command's route on a card: strips re-solved by the
    device beam (here on the CPU), a monotone descent to the exact
    optimum."""
    prob = _pm(3, 3, seed=6)
    e_ref, _ = solve_exact_chimera(prob)
    s0 = np.random.default_rng(1).choice([-1.0, 1.0], prob.n)
    sub = (lambda sp, R, w: tbt.solve_beam_chimera_cuda(
        sp, rows=R, cols=w, beam=1 << 12, device="cpu")[:2])
    e, s, n_moves = tbc.refine_strips(prob, s0, window=2, sub_solver=sub)
    assert n_moves >= 1 and abs(float(prob.energy(s)) - e) < 1e-9
    assert e <= float(prob.energy(s0)) and e >= e_ref - 1e-9


def test_device_beam_parity_int_dp():
    p0 = synth_chimera(3, 2, seed=4)
    prob = IsingProblem(np.round(np.asarray(p0.J) * 4) / 8,
                        np.round(np.asarray(p0.h) * 4) / 8)
    _, _, q = tbt.quantize_problem(prob)
    assert q == 8
    e_ref, _ = solve_exact_chimera(prob, rows=3, cols=2)
    e, s, info = tbt.solve_beam_chimera_cuda(prob, rows=3, cols=2,
                                             beam=4096, device="cpu")
    assert abs(e - e_ref) < 1e-9
    assert abs(float(prob.energy(s)) - e) < 1e-9
    assert info["e_int"] == int(round(e_ref * 8))


@pytest.mark.parametrize("split", [2, 4])
def test_device_beam_split_merge_matches_single_pass(split):
    p0 = synth_chimera(3, 2, seed=11)
    prob = IsingProblem(np.round(np.asarray(p0.J) * 4) / 8,
                        np.round(np.asarray(p0.h) * 4) / 8)
    e_ref, _ = solve_exact_chimera(prob, rows=3, cols=2)
    e1, s1, i1 = tbt.solve_beam_chimera_cuda(prob, rows=3, cols=2,
                                             beam=4096, split=1,
                                             device="cpu")
    e2, s2, i2 = tbt.solve_beam_chimera_cuda(prob, rows=3, cols=2,
                                             beam=4096, split=split,
                                             device="cpu")
    assert i1["split"] == 1 and i2["split"] == split
    assert abs(e1 - e_ref) < 1e-9 and abs(e2 - e_ref) < 1e-9
    assert i1["e_int"] == i2["e_int"]
    assert abs(float(prob.energy(s2)) - e2) < 1e-9


def test_device_beam_split_auto_policy():
    """split=None chunks so that no sort exceeds 2^24 elements: the same
    rule as JAX's at every beam."""
    prob = _k8(2, 2, seed=12)
    _, _, info = tbt.solve_beam_chimera_cuda(prob, rows=2, cols=2, beam=256,
                                             device="cpu")
    assert info["split"] == 1
    for log2, want in [(8, 1), (16, 1), (17, 2), (18, 4), (20, 16)]:
        assert tbt.auto_split(1 << log2) == want


def test_device_beam_5decimal_print_rounding():
    p0 = synth_chimera(3, 2, seed=6)
    J7 = np.round(np.asarray(p0.J) * 3.5) / 7.0   # exact k/7 couplings
    h7 = np.round(np.asarray(p0.h) * 3.5) / 7.0
    prob = IsingProblem(np.round(J7, 5), np.round(h7, 5))  # file print
    Jq, hq, q = tbt.quantize_problem(prob)
    assert q == 7
    np.testing.assert_array_equal(Jq, np.round(J7 * 7))   # snap == truth
    e, s, info = tbt.solve_beam_chimera_cuda(prob, rows=3, cols=2,
                                             beam=4096, device="cpu")
    e_ref, _ = solve_exact_chimera(IsingProblem(J7, h7), rows=3, cols=2)
    assert info["e_int"] == int(round(e_ref * 7))
    assert abs(float(prob.energy(s)) - e) < 1e-9


def test_quantize_rejects_irrational():
    prob = synth_chimera(2, 2, seed=1)      # gaussian couplings
    with pytest.raises(ValueError):
        tbt.quantize_problem(prob, q_max=50)


def test_multi_orientation_remap():
    prob = synth_chimera(3, 2, seed=9)
    e_id, _, _ = tbc.solve_beam_chimera(prob, rows=3, cols=2, beam=128)
    e, s, info = tbc.solve_beam_chimera_multi(prob, rows=3, cols=2,
                                              beam=128)
    assert abs(float(prob.energy(s)) - e) < 1e-9
    assert e <= e_id + 1e-9
    assert 1 <= len(info["per_orientation"]) <= 4


# ------------------------------------------------------------ the CLI

def _write_instance(folder):
    """A +-J chimera 3x3 with +-1/0 fields in the reference's chimera
    dialect, with its exact energy in groundstates_otn2d.txt."""
    folder.mkdir()
    prob = _pm(3, 3, seed=7)
    path = folder / "001.txt"
    rows = [f"{i + 1} {i + 1} {float(-prob.h[i])!r}" for i in range(prob.n)
            if prob.h[i]]
    iu, ju = np.nonzero(np.triu(prob.J, 1))
    rows += [f"{i + 1} {j + 1} {float(-prob.J[i, j])!r}"
             for i, j in zip(iu, ju)]
    path.write_text("\n".join(rows) + "\n")
    e, s = solve_exact_chimera(load_chimera(str(path)))
    bits = " ".join(str(int(x)) for x in (s + 1) // 2)
    (folder / "groundstates_otn2d.txt").write_text(f"001.txt : {e} {bits}\n")
    return str(path), e


@pytest.mark.parametrize("route", [[], ["--no-refine"], ["card"]],
                         ids=["pipeline", "no-refine", "card"])
def test_beam_cli_record_equals_jax(tmp_path, capsys, monkeypatch, route):
    """`--device cpu` takes JAX's host routes (the pipeline, `--no-refine`);
    the card's route, JAX's `--device`, is driven here on CPU tensors."""
    path, e_gs = _write_instance(tmp_path / "chimera72")
    card = route == ["card"]
    if card:
        monkeypatch.setattr(cli, "_beam_on_host", lambda device: False)
        route = []
    argv = ["beam", path, "--kind", "chimera", "--beam", "5", *route]
    out_t, out_j = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    st_t, st_j = tmp_path / "t.txt", tmp_path / "j.txt"
    assert cli.main([*argv, "--device", "cpu", "--out", str(out_t),
                     "--save-state", str(st_t)]) == 0
    ns = cli.build_parser().parse_args(
        [*argv, "--out", str(out_j), "--save-state", str(st_j)])
    jns = argparse.Namespace(**{**vars(ns), "device": card, "cpu": False})
    assert jcli.cmd_beam(jns) == 0
    rt = json.loads(out_t.read_text())
    rj = json.loads(out_j.read_text())
    assert rt.keys() == rj.keys() == {
        "name", "n", "kind", "rows", "cols", "beam", "energy_raw", "exact",
        "strip_moves", "wall_seconds", "shipped_target", "reaches_shipped"}
    rt.pop("wall_seconds"), rj.pop("wall_seconds")
    assert rt == rj
    assert rt["shipped_target"] == e_gs and (rt["rows"], rt["cols"]) == (3, 3)
    assert st_t.read_bytes() == st_j.read_bytes()
    s = np.loadtxt(st_t)
    assert float(load_chimera(path).energy(s)) == rt["energy_raw"]
    if route != ["--no-refine"]:
        assert rt["strip_moves"] is not None
    capsys.readouterr()


def test_beam_cli_device_policy(tmp_path, monkeypatch):
    path, _ = _write_instance(tmp_path / "c")
    args = cli.build_parser().parse_args(["beam", path])
    assert args.device == "cuda"
    assert (args.beam, args.orientations, args.refine) == (16, 1, True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["beam", path, "--beam", "5"])
