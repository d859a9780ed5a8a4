"""The port's figures (utils/plotting.py) against the JAX package's: the
same inputs, made from seeds with numpy, give byte-identical PNG files
under the same filenames (both draw with the same matplotlib); and
`miss_residuals` returns the same list."""

import json

import numpy as np
import pytest

from nmc_tpu.utils import plotting as jp
from nmc_tpu_torch.utils import plotting as tp


@pytest.fixture(autouse=True)
def chdir_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


def _records(rng, family, arm, n=12):
    rs = []
    for i in range(n):
        hit = bool(rng.random() < 0.5)
        rs.append({"name": f"inst{i}", "hit": hit,
                   "hit_seconds": float(rng.random() * 10) if hit else None,
                   "residual": 0.0 if hit else float(rng.random() * 3),
                   "gs_raw": float(-50 - rng.random()),
                   "meta": {"family": family, "arm": arm}})
    rs[0]["gs_raw"] = None          # a record without a usable truth
    return rs


def _write_jsonl(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return str(path)


def _campaign_files(tmp, rng):
    paths = []
    for n in (20, 40):
        for a in (0.3, 0.5):
            for arm in ("icm", "nmc"):
                fam = f"wishart_planting_N_{n}_alpha_{a:.2f}"
                paths.append(_write_jsonl(
                    tmp / f"wishart_n{n}_a{a:.2f}_{arm}.jsonl",
                    _records(rng, fam, arm)))
    return paths


def _same_png(a, b):
    return open(a, "rb").read() == open(b, "rb").read()


def _both(name, draw_t, draw_j, tmp_path):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    draw_t(str(tmp_path / "t" / name))
    draw_j(str(tmp_path / "j" / name))
    assert _same_png(tmp_path / "t" / name, tmp_path / "j" / name)


def test_plot_nmc_results_same_files(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    M = np.sign(rng.normal(size=(60, 2, 9)))
    e = rng.normal(size=(60, 2))
    args = (M, e, np.array([1, 4, 5]), ["C", "NC", "ALL"] * 2, [10] * 6, 1)
    for d, mod in (("t", tp), ("j", jp)):
        (tmp_path / d).mkdir()
        monkeypatch.chdir(tmp_path / d)
        mod.plot_nmc_results(*args)
    for name in ("NMC_spins.png", "NMC_energy.png"):
        assert _same_png(tmp_path / "t" / name, tmp_path / "j" / name)


@pytest.mark.parametrize("name", ["NPT_energy.png", "APT_ICM_energy..png"])
def test_plot_energies_same_file(tmp_path, name):
    rng = np.random.default_rng(1)
    traces = list(rng.normal(size=(4, 20)))
    beta = np.array([0.5, 1.0, 1.5, 2.0])
    _both(name, lambda p: tp.plot_energies(traces, beta, p),
          lambda p: jp.plot_energies(traces, beta, p), tmp_path)


def test_plot_beta_sigma_same_file(tmp_path):
    beta, sigma = [0.5, 0.9, 1.7, 3.1], [2.0, 1.1, 0.6]
    _both("beta_sigma.png", lambda p: tp.plot_beta_sigma(beta, sigma, p),
          lambda p: jp.plot_beta_sigma(beta, sigma, p), tmp_path)


def test_campaign_figures_same_files(tmp_path):
    rng = np.random.default_rng(2)
    files = _campaign_files(tmp_path, rng)
    for fig in ("plot_campaign", "plot_hardness_curve",
                "plot_hardness_surface"):
        out_t, out_j = tmp_path / f"t_{fig}.png", tmp_path / f"j_{fig}.png"
        assert getattr(tp, fig)(files, str(out_t)) == str(out_t)
        getattr(jp, fig)(files, str(out_j))
        assert _same_png(out_t, out_j), fig
    out_t, out_j = tmp_path / "t_tts.png", tmp_path / "j_tts.png"
    tp.plot_hardness_surface(files, str(out_t), metric="tts")
    jp.plot_hardness_surface(files, str(out_j), metric="tts")
    assert _same_png(out_t, out_j)
    with pytest.raises(ValueError):
        tp.plot_hardness_surface([_write_jsonl(tmp_path / "x.jsonl",
                                               _records(rng, "chim", "icm"))],
                                 str(tmp_path / "none.png"))


def test_plot_residual_trace_same_file(tmp_path):
    rng = np.random.default_rng(3)
    paths = []
    for k in range(2):
        rows = [{"sweeps": 2 ** (i + 6), "hits": i,
                 "residual_raw": [float(x) if x > 0.3 else None
                                  for x in rng.random(5 - (i == 3))]}
                for i in range(5)]
        paths.append(_write_jsonl(tmp_path / f"r{k}.jsonl.trace", rows))
    _both("residual_trace.png", lambda p: tp.plot_residual_trace(paths, p),
          lambda p: jp.plot_residual_trace(paths, p), tmp_path)


def test_miss_residuals_same_list():
    rs = _records(np.random.default_rng(4), "f", "a", n=30)
    rs[1].update(hit=False, residual=float("nan"))
    assert tp.miss_residuals(rs) == jp.miss_residuals(rs)
    assert len(tp.miss_residuals(rs)) > 3
