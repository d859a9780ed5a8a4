"""The port's MATLAB-sidecar loaders and metrics helpers against the JAX
package's: `load_chimera_mat`, `read_ground_energies_mat` (.mat files
written with scipy.io.savemat from seeded numpy data), `timed` and
`device_trace` (a torch.profiler trace where JAX takes a jax.profiler
one)."""

import json
import os

import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp

from nmc_tpu.io import loaders as j_loaders
from nmc_tpu.utils import metrics as j_metrics
from nmc_tpu_torch.io import loaders as t_loaders
from nmc_tpu_torch.utils import metrics as t_metrics


def _write_chimera_mat(folder, n=24, seed=0):
    """JJ.mat (csc J, symmetric, zero diagonal) and h.mat, scaled by 1/5
    as chimera512's sidecars are."""
    rng = np.random.default_rng(seed)
    J = np.triu(rng.integers(-3, 4, size=(n, n)) * (rng.random((n, n)) < 0.3),
                1).astype(np.float64)
    J = (J + J.T) / 5.0
    h = rng.integers(-2, 3, size=(n, 1)).astype(np.float64) / 5.0
    sio.savemat(os.path.join(folder, "JJ.mat"), {"J": sp.csc_matrix(J)})
    sio.savemat(os.path.join(folder, "h.mat"), {"h": h})
    return J, h.ravel()


@pytest.mark.parametrize("rescale", [True, False])
def test_load_chimera_mat_matches_jax(tmp_path, rescale):
    J, h = _write_chimera_mat(str(tmp_path), seed=int(rescale))
    ours = t_loaders.load_chimera_mat(str(tmp_path), rescale=rescale)
    ref = j_loaders.load_chimera_mat(str(tmp_path), rescale=rescale)
    scale = 5.0 if rescale else 1.0
    np.testing.assert_array_equal(ours.J, np.asarray(ref.J))
    np.testing.assert_array_equal(ours.h, np.asarray(ref.h))
    np.testing.assert_array_equal(ours.J, scale * J)
    np.testing.assert_array_equal(ours.h, scale * h)
    assert ours.name == ref.name == "001.mat"


@pytest.mark.parametrize("shape", [(1, 7), (7, 1), (7,)])
def test_read_ground_energies_mat_matches_jax(tmp_path, shape):
    rng = np.random.default_rng(3)
    e = -rng.integers(500, 900, size=7).astype(np.float64)
    path = str(tmp_path / "ground_energies.mat")
    sio.savemat(path, {"ground_energies": e.reshape(shape)})
    ours = t_loaders.read_ground_energies_mat(path)
    np.testing.assert_array_equal(ours, j_loaders.read_ground_energies_mat(path))
    np.testing.assert_array_equal(ours, e)
    assert ours.dtype == np.float64 and ours.ndim == 1


@pytest.mark.parametrize("raises", [False, True])
def test_timed_logs_like_jax(tmp_path, raises):
    """Both log one record of the kind with `seconds`, the fields and what
    the section put in its box, also when the section raises; the JSONL
    files hold the same keys."""
    records = {}
    for name, mod in (("jax", j_metrics), ("torch", t_metrics)):
        log = mod.MetricsLogger(path=str(tmp_path / f"{name}.jsonl"))
        try:
            with mod.timed(log, "phase", cycle=3, tag="C") as box:
                box["flips"] = 17
                if raises:
                    raise KeyError("inside")
        except KeyError:
            assert raises
        assert box["seconds"] >= 0.0
        (rec,) = log.of_kind("phase")
        with open(tmp_path / f"{name}.jsonl") as f:
            assert json.loads(f.read()) == rec
        records[name] = rec
    for rec in records.values():
        assert rec["cycle"] == 3 and rec["tag"] == "C" and rec["flips"] == 17
    assert sorted(records["jax"]) == sorted(records["torch"])
    with t_metrics.timed(None, "nothing") as box:
        pass
    assert box["seconds"] >= 0.0


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import torch
    out = tmp_path / "trace"
    with t_metrics.device_trace(str(out)):
        torch.ones((64, 64)).matmul(torch.ones((64, 64))).sum()
    with open(out / "trace.json") as f:
        trace = json.load(f)
    assert trace["traceEvents"]
