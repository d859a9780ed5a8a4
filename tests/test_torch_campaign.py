"""The port's campaign (`python -m nmc_tpu_torch campaign`), its ground-truth
readers and folder iterators, and the device policy of every subcommand.

The readers and iterators are copies of nmc_tpu's, held equal on files
written here in the reference's formats. The campaign runs on a small
family that the test writes in the reference's chimera format, with ground
states found by enumeration (N = 16): every arm hits every instance,
write records with the JAX campaign's keys, and a second run resumes (skips
the instances on file), for the pt, nmc, icm, hybrid and icm_host arms.
The spectral arm's records equal JAX's; `--init spectral` seeds JAX's
candidates, `--init file` the files' states; `--presolve` runs on the
2-cores of tree-decorated instances with records in raw units; `--refine
tree` skips a folder run. `--collect-best` and `--summarize` print and
write what JAX's do on the same result files, and the contrived family's
records (no target, then targets from `--best-known`) equal JAX's.
"""

import itertools
import json

import numpy as np
import pytest
import torch

from nmc_tpu import campaign as jcamp
from nmc_tpu import evaluation as jev
from nmc_tpu.io import loaders as jl
from nmc_tpu_torch import campaign as tcamp
from nmc_tpu_torch import cli
from nmc_tpu_torch import evaluation as tev
from nmc_tpu_torch.device import default_device
from nmc_tpu_torch.io import loaders as tl
from nmc_tpu_torch.io.generators import chimera_graph, random_sk
from nmc_tpu_torch.ops.round_cuda import ensemble_round

RECORD_KEYS = {"name", "n", "gs_raw", "found_raw", "residual", "hit",
               "hit_seconds", "hit_sweeps", "rounds_completed",
               "rounds_total", "per_swap", "wall_seconds", "meta"}


def _ground_state(prob):
    states = np.array(list(itertools.product([-1.0, 1.0], repeat=prob.n)))
    e = prob.energy(states)
    k = int(np.argmin(e))
    return float(e[k]), states[k]


def write_chimera_family(folder, count=3, seed=0):
    """`count` chimera 1x2 instances (16 spins, +-1 couplings, small
    fields) in the reference's chimera dialect (1-indexed, diagonal lines
    carry h, values of the un-negated file) with groundstates_otn2d.txt
    from enumeration. Returns {name: raw ground-state energy}."""
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    gs = {}
    lines = []
    for k in range(count):
        prob = chimera_graph(1, 2, seed=seed + k)
        h = rng.choice([-0.5, 0.5], size=prob.n) * (rng.random(prob.n) < 0.3)
        name = f"{k + 1:03d}.txt"
        rows = [f"{i + 1} {i + 1} {-h[i]}" for i in range(prob.n) if h[i]]
        iu, ju = np.nonzero(np.triu(prob.J, 1))
        rows += [f"{i + 1} {j + 1} {-prob.J[i, j]}" for i, j in zip(iu, ju)]
        (folder / name).write_text("\n".join(rows) + "\n")
        loaded = tl.load_chimera(str(folder / name))
        e, s = _ground_state(loaded)
        gs[name] = e
        bits = " ".join(str(int(x)) for x in (s + 1) // 2)
        lines.append(f"{name} : {e} {bits}")
    (folder / "groundstates_otn2d.txt").write_text("\n".join(lines) + "\n")
    return gs


def test_ground_truth_readers_equal(tmp_path):
    gs = tmp_path / "gs_energies.txt"
    gs.write_text("a.txt\t-12.5\nb.txt\t-3\n\n")
    assert tl.read_gs_energies(str(gs)) == jl.read_gs_energies(str(gs))
    otn = tmp_path / "groundstates_otn2d.txt"
    otn.write_text("001.txt : -40.25 0 1 1 0\n002.txt : 7 1 1\njunk\n")
    a, b = tl.read_otn2d_groundstates(str(otn)), \
        jl.read_otn2d_groundstates(str(otn))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k][0] == b[k][0]
        np.testing.assert_array_equal(a[k][1], b[k][1])
        assert a[k][1].dtype == b[k][1].dtype
    sol = tmp_path / "01_sol.txt"
    sol.write_text("min_energy -101.5\nplanted yes\nthree words here\n")
    assert tl.read_dcl_solution(str(sol)) == jl.read_dcl_solution(str(sol))


@pytest.mark.parametrize("kind", ["chimera", "wishart", "dcl"])
def test_folder_iterators_equal(tmp_path, kind):
    folder = tmp_path / kind
    if kind == "chimera":
        write_chimera_family(folder, count=2)
    else:
        folder.mkdir()
        for k in range(3):
            prob = random_sk(6, seed=k)
            iu, ju = np.nonzero(np.triu(prob.J, 1))
            (folder / f"{k:02d}.txt").write_text("\n".join(
                f"{i} {j} {prob.J[i, j]}" for i, j in zip(iu, ju)) + "\n")
        if kind == "wishart":
            (folder / "gs_energies.txt").write_text(
                "00.txt\t-3.5\n02.txt\t-1.25\nmissing.txt\t-1\n")
        else:
            (folder / "00_sol.txt").write_text("min_energy -2.5\n")
            (folder / "01_sol.txt").write_text("other 1\n")
    fn = f"{kind}_folder_instances"
    a = list(getattr(tev, fn)(str(folder)))
    b = list(getattr(jev, fn)(str(folder)))
    assert [x[0] for x in a] == [x[0] for x in b] and a
    for (_, pa, ga), (_, pb, gb) in zip(a, b):
        np.testing.assert_array_equal(pa.J, pb.J)
        np.testing.assert_array_equal(pa.h, pb.h)
        assert ga == gb
    assert len(list(getattr(tev, fn)(str(folder), limit=1))) == 1


def test_families_ladders_and_numbers_equal():
    assert tcamp.FAMILIES.keys() == jcamp.FAMILIES.keys()
    for name, spec in tcamp.FAMILIES.items():
        jspec = jcamp.FAMILIES[name]
        assert (spec["kind"], spec["coloring"]) == \
            (jspec["kind"], jspec["coloring"])
        sub = jspec["folder"].split("/reference/", 1)[1]
        assert spec["folder"].replace("\\", "/").endswith(sub)
    for args in ((0.25, 32.0, 32), (0.1, 5.0, 9), (0.5, 3.5, 2)):
        np.testing.assert_array_equal(tcamp.build_ladder(*args),
                                      jcamp.build_ladder(*args))
    for x in (None, 1.5, float("nan"), float("inf"), -3):
        assert tcamp._num(x) == jcamp._num(x)


def _campaign(folder, out, arm, *extra):
    return cli.main(["campaign", "--kind", "chimera", "--folder", str(folder),
                     "--arm", arm, "--device", "cpu", "--out", str(out),
                     "--replicas", "8", "--sweeps-per-phase", "4",
                     "--num-cycles", "1", "--sweeps", "240",
                     "--chunk-rounds", "2", "--lbp-every", "2",
                     "--nmc-cold", "2", *extra])


@pytest.mark.parametrize("arm", ["nmc", "pt", "icm", "hybrid", "icm_host"])
def test_campaign_cli_hits_every_instance_and_resumes(tmp_path, capsys, arm):
    """The batched arms (pt, nmc through EnsembleNMC; icm, hybrid through
    EnsembleICM) take K4 and stream their hits; icm_host runs apt_icm_run
    per instance (2 sweeps per swap round at these flags). A second run
    skips every instance on file."""
    folder = tmp_path / "family"
    gs = write_chimera_family(folder)
    out = tmp_path / "out" / f"family_{arm}.jsonl"
    _campaign(folder, out, arm, "--trace", "--save-best-states",
              str(tmp_path / "states"))
    text = capsys.readouterr().out
    batched = arm != "icm_host"
    if batched:
        assert "round_path=K4" in text and "device=cpu" in text
        assert ("sub-replicas" in text) == (arm in ("icm", "hybrid"))
    assert ensemble_round.launches == 0          # the CPU runs the twin
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert sorted(r["name"] for r in recs) == sorted(gs)
    per_swap = 12 if batched else 2
    for r in recs:
        assert set(r) == RECORD_KEYS
        assert r["hit"] and r["hit_sweeps"] % per_swap == 0
        assert abs(r["found_raw"] - gs[r["name"]]) <= 1e-9
        assert r["meta"]["arm"] == arm
        assert r["per_swap"] == per_swap and r["n"] == 16
        if not batched:
            continue
        assert r["meta"]["mode"] == "ensemble"
        assert r["meta"]["streamed_hit"] and r["meta"]["batch"] == 3
        state = np.loadtxt(tmp_path / "states" / r["name"])
        loaded = tl.load_chimera(str(folder / r["name"]))
        assert abs(loaded.energy(state) - r["found_raw"]) <= 1e-9
    assert not (tmp_path / "out" / f"family_{arm}.jsonl.partial").exists()
    assert (tmp_path / "out" / f"family_{arm}.jsonl.trace").exists() \
        == batched
    _campaign(folder, out, arm)                  # resume: all done
    text = capsys.readouterr().out
    assert ("all instances done" if batched else "skip 003.txt") in text
    assert len(out.read_text().splitlines()) == 3


def test_cli_icm_prints_the_jax_cli_keys(tmp_path, capsys):
    """The `icm` subcommand prints the JAX command's JSON keys; --device
    defaults to cuda and --device-icm to the size rule."""
    prob = chimera_graph(2, 2, seed=1)
    np.save(tmp_path / "J.npy", prob.J)
    argv = ["icm", "--J", str(tmp_path / "J.npy"), "--coloring",
            "--block-size", "8", "--replicas", "3", "--sweeps", "12",
            "--sweeps-read", "6", "--swap-attempts", "3", "--subreplicas",
            "4"]
    cli.main([*argv, "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the JAX command on the same namespace (its main would also set a
    # global compilation-cache directory)
    from nmc_tpu import cli as jcli
    jcli.cmd_icm(cli.build_parser().parse_args(argv))
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == set(want) == {"Energy", "min_energy", "icm_moves",
                                     "icm_flips"}
    assert len(out["Energy"]) == len(want["Energy"]) == 3
    args = cli.build_parser().parse_args(["icm"])
    assert args.device == "cuda" and args.device_icm is None


def write_contrived_folder(folder, count=3):
    """`count` tree-decorated planted instances
    (`contrived_wishart_backbone(4, 0.5)`: 28 spins, 24 of them on trees)
    in the wishart dialect, named as the wishart folders are, with their
    planted energies in gs_energies.txt. Returns {name: energy}."""
    from nmc_tpu_torch.io.generators import contrived_wishart_backbone
    folder.mkdir(parents=True)
    gs, lines = {}, []
    for k in range(count):
        prob, t, _ = contrived_wishart_backbone(4, alpha=0.5, seed=k)
        name = f"wishart_planting_N_28_alpha_0.50_inst_{k + 1}.txt"
        iu, ju = np.nonzero(np.triu(prob.J, 1))
        (folder / name).write_text("".join(
            f"{i} {j} {float(-prob.J[i, j])!r}\n" for i, j in zip(iu, ju)))
        gs[name] = float(tl.load_wishart(str(folder / name)).energy(t))
        lines.append(f"{name}\t{gs[name]!r}\n")
    (folder / "gs_energies.txt").write_text("".join(lines))
    return gs


def _campaign_jsonls(tmp_path):
    """Two campaign result files: hits, misses with residuals, a record
    with NaN (contrived: no target) gs and residual, and a NaN found_raw."""
    nan = float("nan")
    meta = dict(family="chimera_x", arm="nmc", sweeps=64)
    a = [dict(name="001.txt", n=16, gs_raw=-20.0, found_raw=-20.0,
              residual=0.0, hit=True, hit_seconds=0.5, wall_seconds=3.25,
              meta=meta),
         dict(name="002.txt", n=16, gs_raw=-18.0, found_raw=-17.0,
              residual=1.0, hit=False, hit_seconds=None, wall_seconds=3.25,
              meta=meta),
         dict(name="003.txt", n=16, gs_raw=-30.0, found_raw=-29.0,
              residual=1.0, hit=False, hit_seconds=None, wall_seconds=3.25,
              meta=meta),
         dict(name="004.txt", n=16, gs_raw=-12.0, found_raw=-12.0,
              residual=0.0, hit=True, hit_seconds=1.75, wall_seconds=3.25,
              meta=meta)]
    b = [dict(name="t_1.txt", n=28, gs_raw=nan, found_raw=-40.5,
              residual=nan, hit=False, hit_seconds=None, wall_seconds=1.0,
              meta=dict(family="contrived_n4", arm="spectral", sweeps=0)),
         dict(name="001.txt", n=16, gs_raw=-20.0, found_raw=-21.0,
              residual=-1.0, hit=True, hit_seconds=0.25, wall_seconds=1.0,
              meta=meta),
         dict(name="t_2.txt", n=28, gs_raw=nan, found_raw=nan, residual=nan,
              hit=False, hit_seconds=None, wall_seconds=1.0, meta=meta)]
    paths = []
    for tag, recs in (("a", a), ("b", b)):
        path = tmp_path / f"{tag}_nmc.jsonl"
        path.write_text("".join(json.dumps(r) + "\n" for r in recs))
        paths.append(str(path))
    (tmp_path / "empty.jsonl").write_text("")
    return paths + [str(tmp_path / "empty.jsonl")]


def test_collect_best_equals_jax(tmp_path, capsys):
    """`campaign --collect-best` (in place of the refusal it replaces): the
    minimum found_raw per name over the files, NaN skipped, merged into an
    existing best-known file; the same JSON and line as JAX's."""
    paths = _campaign_jsonls(tmp_path)
    for tag in ("t", "j"):
        (tmp_path / f"{tag}.json").write_text(json.dumps(
            {"002.txt": -17.5, "001.txt": -19.0}))
    cli.main(["campaign", "--collect-best", *paths, "--out",
              str(tmp_path / "t.json"), "--device", "cpu"])
    mine = capsys.readouterr().out
    _jax_campaign(["campaign", "--collect-best", *paths, "--out",
                   str(tmp_path / "j.json")])
    theirs = capsys.readouterr().out
    assert mine.replace("t.json", "j.json") == theirs
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
    assert json.loads((tmp_path / "t.json").read_text()) == {
        "001.txt": -21.0, "002.txt": -17.5, "003.txt": -29.0,
        "004.txt": -12.0, "t_1.txt": -40.5}
    with pytest.raises(SystemExit, match="requires --out"):
        cli.main(["campaign", "--collect-best", *paths])


def test_summarize_equals_jax(tmp_path, capsys):
    """`campaign --summarize` (in place of the refusal it replaces): the
    same table and rows as JAX's, NaN-target records skipped in the miss
    residuals, no instance run."""
    paths = _campaign_jsonls(tmp_path)
    cli.main(["campaign", "--summarize", *paths, "--device", "cpu"])
    mine = capsys.readouterr().out
    _jax_campaign(["campaign", "--summarize", *paths])
    assert mine == capsys.readouterr().out
    rows = tcamp.summarize(paths)
    assert rows == jcamp.summarize(paths)
    assert [(r["hits"], r["instances"]) for r in rows] == [(2, 4), (1, 3)]
    assert rows[0]["tts_p50"] == 1.75 and rows[1]["miss_res_p50"] is None
    capsys.readouterr()


def test_contrived_family_records_equal_jax(tmp_path, capsys):
    """`campaign --kind contrived` (in place of the refusal it replaces) on
    a folder written by `emit_contrived_ensemble`: without a best-known
    file no target (every record a miss with null gs_raw); with
    `--best-known` from `--collect-best` every instance a hit. Spectral
    arm records equal to JAX's, wall clocks apart."""
    from nmc_tpu_torch.io.generators import emit_contrived_ensemble
    paths = emit_contrived_ensemble(str(tmp_path), 3, n_backbone=4,
                                    levels=2, alpha=0.5,
                                    num_cross_connections=4)
    folder = paths[0].rsplit("/", 1)[0]
    argv = ["campaign", "--kind", "contrived", "--folder", folder, "--arm",
            "spectral", "--spectral-dm", "32", "--spectral-dm-iters", "60"]
    best = str(tmp_path / "best.json")
    for tag, extra in (("0", []), ("1", ["--best-known", best])):
        out_t, out_j = tmp_path / f"t{tag}.jsonl", tmp_path / f"j{tag}.jsonl"
        cli.main([*argv, *extra, "--device", "cpu", "--out", str(out_t)])
        _jax_campaign([*argv, *extra, "--out", str(out_j)])
        mine, theirs = _records(out_t), _records(out_j)
        assert [r["name"] for r in mine] == [
            p.rsplit("/", 1)[1] for p in paths] == \
            [r["name"] for r in theirs]
        for a, b in zip(mine, theirs):
            assert set(a) == RECORD_KEYS and a["n"] == 28
            for r in (a, b):
                r.pop("wall_seconds"), r.pop("hit_seconds")
            assert a == b
        if tag == "0":
            assert all(r["gs_raw"] is None and not r["hit"] for r in mine)
            cli.main(["campaign", "--collect-best", str(out_t), "--out",
                      best, "--device", "cpu"])
        else:
            assert all(r["hit"] for r in mine)
    capsys.readouterr()


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.resolve_cli_device("cuda")
    assert cli.resolve_cli_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("sub", ["nmc", "apt", "npt", "icm", "campaign",
                                 "beam", "evaluate"])
def test_every_subcommand_takes_device_default_cuda(sub, monkeypatch,
                                                    tmp_path):
    """--device defaults to cuda on every subcommand; without a card that
    default fails instead of running on the CPU."""
    fam = str(tmp_path / "fam")
    base = {"beam": [sub, fam + "/001.txt"],
            "evaluate": [sub, "--folder", fam]}.get(sub, [sub])
    args = cli.build_parser().parse_args(base)
    assert args.device == "cuda"
    assert cli.build_parser().parse_args([*base, "--device", "cpu"]).device \
        == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    np.save(tmp_path / "J.npy", random_sk(8, seed=1).J)
    write_chimera_family(tmp_path / "fam", count=1)
    argv = {"campaign": ["campaign", "--kind", "chimera", "--folder",
                         fam, "--arm", "pt", "--out",
                         str(tmp_path / "o.jsonl")],
            "beam": [*base, "--kind", "chimera"],
            "evaluate": [*base, "--family", "chimera"]}.get(
        sub, [sub, "--J", str(tmp_path / "J.npy"), "--coloring"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


def _jax_campaign(argv):
    """nmc_tpu's campaign on the port's parsed flags, without its
    compilation-cache setup (which writes outside the test's directory)."""
    import nmc_tpu.utils.compcache as jcc
    ns = cli.build_parser().parse_args(argv)
    ns.cpu = False
    enable = jcc.enable_compilation_cache
    jcc.enable_compilation_cache = lambda *a, **k: None
    try:
        jcamp.run_campaign(ns)
    finally:
        jcc.enable_compilation_cache = enable


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.mark.parametrize("presolve", [False, True])
def test_spectral_arm_records_equal_jax(tmp_path, capsys, presolve):
    """The spectral arm is deterministic host code: the port's records are
    JAX's, record for record (wall clocks apart); with --presolve on the
    2-cores, energies shifted back to raw units."""
    folder = tmp_path / "wishart_planting_N_28_alpha_0.50"
    gs = write_contrived_folder(folder)
    argv = ["campaign", "--kind", "wishart", "--folder", str(folder),
            "--arm", "spectral", "--spectral-dm", "32",
            "--spectral-dm-iters", "60", "--device", "cpu"]
    if presolve:
        argv.append("--presolve")
    cli.main([*argv, "--out", str(tmp_path / "t.jsonl")])
    _jax_campaign([*argv, "--out", str(tmp_path / "j.jsonl")])
    mine, theirs = _records(tmp_path / "t.jsonl"), _records(tmp_path /
                                                           "j.jsonl")
    assert [r["name"] for r in mine] == sorted(gs) == \
        [r["name"] for r in theirs]
    for a, b in zip(mine, theirs):
        assert set(a) == RECORD_KEYS
        for r in (a, b):
            r.pop("wall_seconds"), r.pop("hit_seconds")
        assert a == b
        assert a["gs_raw"] == gs[a["name"]] and a["meta"]["sweeps"] == 0
        assert a["n"] == (4 if presolve else 28)
    assert all(r["hit"] for r in mine)
    capsys.readouterr()


def _spy_init_state(monkeypatch, cls):
    seen = []
    real = cls.init_state

    def spy(self, generator, m0=None):
        seen.append(None if m0 is None else np.array(m0))
        return real(self, generator, m0=m0)

    monkeypatch.setattr(cls, "init_state", spy)
    return seen


@pytest.mark.parametrize("arm", ["nmc", "icm"])
def test_init_spectral_seeds_equal_jax(tmp_path, capsys, monkeypatch, arm):
    """--init spectral seeds the --init-chains coldest chains with JAX's
    spectral_candidates(...)[0][:C] of the normalized (padded) problems;
    the run hits every instance and says how it was seeded."""
    from nmc_tpu.ops.spectral import spectral_candidates
    from nmc_tpu_torch.parallel import EnsembleICM, EnsembleNMC
    folder = tmp_path / "family"
    gs = write_chimera_family(folder)
    seen = _spy_init_state(monkeypatch,
                           EnsembleICM if arm == "icm" else EnsembleNMC)
    out = tmp_path / "o.jsonl"
    _campaign(folder, out, arm, "--init", "spectral", "--init-chains", "3")
    assert "spectral seeding: 3 chains x 3 instances" in \
        capsys.readouterr().out
    want = []
    for name, prob, _ in jev.chimera_folder_instances(str(folder)):
        p, _ = prob.normalized()
        want.append(spectral_candidates(p.J, p.h if np.any(p.h) else None,
                                        seed=0)[0][:3])
    np.testing.assert_array_equal(seen[0], np.stack(want))
    recs = _records(out)
    assert sorted(r["name"] for r in recs) == sorted(gs)
    assert all(r["hit"] and r["meta"]["init"] == "spectral"
               and r["meta"]["init_chains"] == 3 for r in recs)


@pytest.mark.parametrize("arm", ["icm", "pt"])
def test_presolve_records_raw_units_and_states_reverify(tmp_path, capsys,
                                                        arm):
    """--presolve: the engines run on the 4-spin cores of 28-spin
    instances; records are in original raw units, every instance hits its
    planted energy, and each saved full-space state re-verifies in f64."""
    folder = tmp_path / "wishart_planting_N_28_alpha_0.50"
    gs = write_contrived_folder(folder)
    out = tmp_path / "o.jsonl"
    cli.main(["campaign", "--kind", "wishart", "--folder", str(folder),
              "--arm", arm, "--presolve", "--device", "cpu", "--out",
              str(out), "--replicas", "4", "--subreplicas", "2",
              "--sweeps-per-phase", "4", "--num-cycles", "1", "--sweeps",
              "48", "--save-best-states", str(tmp_path / "states")])
    assert "presolve: peeled to cores 4..4 of n=28" in capsys.readouterr().out
    recs = _records(out)
    assert sorted(r["name"] for r in recs) == sorted(gs)
    for r in recs:
        assert r["n"] == 28 and r["gs_raw"] == pytest.approx(gs[r["name"]],
                                                             abs=1e-9)
        assert r["hit"] and r["meta"]["presolve"] == "peel"
        assert r["meta"]["core_n"] == [4, 4, 4]
        state = np.loadtxt(tmp_path / "states" / r["name"])
        prob = tl.load_wishart(str(folder / r["name"]))
        assert state.shape == (28,)
        assert abs(prob.energy(state) - r["found_raw"]) <= 1e-9


def test_init_file_seeds_and_refuses_presolve(tmp_path, capsys, monkeypatch):
    """--init file seeds the coldest chains with each instance's state file
    (repeated over --init-chains) and hits at once from ground states; a
    file of the wrong length raises, and so does --presolve with it."""
    from nmc_tpu_torch.parallel import EnsembleNMC
    folder = tmp_path / "family"
    gs = write_chimera_family(folder)
    states = tmp_path / "states"
    states.mkdir()
    truths = jl.read_otn2d_groundstates(str(folder /
                                            "groundstates_otn2d.txt"))
    for name, (_, spins) in truths.items():
        np.savetxt(states / name, spins, fmt="%d")
    seen = _spy_init_state(monkeypatch, EnsembleNMC)
    out = tmp_path / "o.jsonl"
    _campaign(folder, out, "pt", "--init", "file", "--init-states",
              str(states), "--init-chains", "2")
    assert "file seeding: 2 chains x 3 instances" in capsys.readouterr().out
    for k, name in enumerate(sorted(gs)):
        want = truths[name][1]
        np.testing.assert_array_equal(seen[0][k], np.stack([want, want]))
    recs = _records(out)
    assert all(r["hit"] and r["rounds_completed"] == 2
               and r["meta"]["init"] == "file" for r in recs)
    with pytest.raises(ValueError, match="incompatible with --presolve"):
        _campaign(folder, tmp_path / "p.jsonl", "pt", "--init", "file",
                  "--init-states", str(states), "--presolve")
    np.savetxt(states / "001.txt", np.ones(8), fmt="%d")
    with pytest.raises(ValueError, match="expected 16"):
        _campaign(folder, tmp_path / "q.jsonl", "pt", "--init", "file",
                  "--init-states", str(states))


def test_refine_tree_after_a_folder_run_skips(tmp_path, capsys):
    """--refine tree runs after the arm, on grid families only: a --folder
    run prints the JAX campaign's skip line."""
    folder = tmp_path / "family"
    gs = write_chimera_family(folder)
    out = tmp_path / "o.jsonl"
    _campaign(folder, out, "nmc", "--refine", "tree")
    text = capsys.readouterr().out
    assert f"--refine tree: {folder} is not a grid family; skipping" in text
    assert len(_records(out)) == len(gs)
