"""The port's exact-enumeration tier: `nmc_tpu_torch/native` (a g++ build of
its byte-for-byte copy of enum.cpp) and `exact.solve_exact_enum`, against
nmc_tpu's on numpy-seeded instances.

`exact_enumerate` returns JAX's native results on the same R, W and r2 (f64
and the f32 search mode); `solve_exact_enum` returns JAX's energy, its
state up to a global flip and its proof flag on wisharts N = 20-24, and the
port's `solve_exact_host` energy. The port's loader raises, with the
compiler's output, when the build fails (JAX's returns None).
"""

import filecmp
import os

import numpy as np
import pytest
import scipy.linalg as sla

from nmc_tpu import native as jnat
from nmc_tpu.core.problem import IsingProblem as JProblem
from nmc_tpu.exact import solve_exact_enum as jenum
from nmc_tpu_torch import native as tnat
from nmc_tpu_torch.core.problem import IsingProblem
from nmc_tpu_torch.exact import solve_exact_enum, solve_exact_host
from nmc_tpu_torch.io.generators import wishart_planted


def _integer_instance(n, seed, scale=40):
    J = np.round(scale * np.random.default_rng(seed).normal(size=(n, n)))
    J = np.triu(J, 1)
    return IsingProblem(J + J.T, np.zeros(n))


def _qr_inputs(J):
    """(R, W, order, c0) of solve_exact_enum's factorization."""
    n = J.shape[0]
    w, v = np.linalg.eigh(J)
    lmax = float(w[-1])
    M = np.sqrt(np.maximum(lmax - w, 0.0))[:, None] * v.T
    _, _, piv = sla.qr(M, pivoting=True)
    order = piv[::-1].copy()
    _, R = sla.qr(M[:, order], mode="economic")
    A = np.abs(R)
    W = np.zeros_like(R)
    for k in range(n):
        W[k, k + 1:] = np.cumsum(A[k, k:-1])
    return R, W, order, -0.5 * lmax * n


def test_enum_source_is_the_jax_packages():
    here = os.path.dirname(tnat.__file__)
    there = os.path.dirname(jnat.__file__)
    assert filecmp.cmp(os.path.join(here, "enum.cpp"),
                       os.path.join(there, "enum.cpp"), shallow=False)


@pytest.mark.parametrize("slack", [1.0, 0.0, 25.0])
@pytest.mark.parametrize("use_f32", [False, True])
def test_exact_enumerate_equals_jax(slack, use_f32):
    prob = _integer_instance(18, seed=3)
    e_h, _ = solve_exact_host(prob)
    R, W, order, c0 = _qr_inputs(prob.J)
    r2 = 2.0 * (e_h + slack - c0)
    a = tnat.exact_enumerate(R, W, r2, use_f32=use_f32)
    b = jnat.exact_enumerate(R, W, r2, use_f32=use_f32)
    assert a[0] == b[0] and a[2] == b[2] and a[3] == b[3] and a[4] == b[4]
    np.testing.assert_array_equal(a[1], b[1])
    assert a[4]                                   # the tree was exhausted
    if slack > 0:
        s = np.empty(18)
        s[order] = a[1]
        assert a[0] and prob.energy(s) == e_h
    capped = tnat.exact_enumerate(R, W, r2, max_nodes=50, use_f32=use_f32)
    assert capped[3] >= 50 and not capped[4]
    assert capped[3] == jnat.exact_enumerate(R, W, r2, max_nodes=50,
                                             use_f32=use_f32)[3]


@pytest.mark.parametrize("n, seed", [(20, 0), (22, 1), (24, 2)])
def test_solve_exact_enum_equals_jax_and_host(n, seed):
    prob, t, e_planted = wishart_planted(n, 0.5, seed=seed)
    e, s, proved = solve_exact_enum(prob, dm_starts=32, dm_iters=100)
    je, js, jproved = jenum(JProblem(prob.J, prob.h), dm_starts=32,
                            dm_iters=100)
    assert proved and jproved
    assert e == je
    assert np.array_equal(s, js) or np.array_equal(s, -js)
    e_h, _ = solve_exact_host(prob)
    np.testing.assert_allclose(e, e_h, rtol=0, atol=1e-9)
    np.testing.assert_allclose(e, e_planted, rtol=0, atol=1e-9)
    assert abs(prob.energy(s) - e) < 1e-12


def test_solve_exact_enum_improves_a_bad_incumbent():
    prob = _integer_instance(16, seed=5)
    e_h, _ = solve_exact_host(prob)
    bad = np.ones(16)
    e, s, proved = solve_exact_enum(prob, incumbent=bad)
    je, js, _ = jenum(JProblem(prob.J, prob.h), incumbent=bad)
    assert proved and e == e_h == je and np.array_equal(s, js)
    e2, s2, proved2 = solve_exact_enum(prob, incumbent=bad, max_nodes=5)
    assert not proved2 and e2 <= prob.energy(bad)


def test_solve_exact_enum_rejects_fields():
    J = np.zeros((6, 6))
    J[0, 1] = J[1, 0] = 1.0
    with pytest.raises(ValueError, match="h = 0"):
        solve_exact_enum(IsingProblem(J, np.ones(6)))


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_loader_raises_when_the_build_fails(tmp_path, monkeypatch, compiler):
    """A compiler that is not there, or one that fails: the loader raises
    with what the compiler said, and nothing is cached for the next call."""
    if compiler == "missing":
        cxx = str(tmp_path / "no-such-g++")
    else:
        cxx = tmp_path / "bad-g++"
        cxx.write_text("#!/bin/sh\necho 'enum.cpp:1: error: broken' >&2\n"
                       "exit 3\n")
        cxx.chmod(0o755)
        cxx = str(cxx)
    monkeypatch.setattr(tnat, "_ENUM_LIB", None)
    monkeypatch.setattr(tnat, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnat, "CXX", cxx)
    R, W, _, c0 = _qr_inputs(_integer_instance(8, seed=1).J)
    for call in (tnat.load_enum_library,
                 lambda: tnat.exact_enumerate(R, W, 1.0)):
        with pytest.raises(RuntimeError, match="enum.cpp") as e:
            call()
        if compiler == "failing":
            assert "broken" in str(e.value) and "exit 3" in str(e.value)
    assert tnat._ENUM_LIB is None
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())


def test_library_is_keyed_by_source_flags_and_host(monkeypatch):
    path = tnat.library_path()
    assert path.startswith(tnat.BUILD_DIR) and path.endswith(".so")
    monkeypatch.setattr(tnat, "CXX_FLAGS", [*tnat.CXX_FLAGS, "-g"])
    assert tnat.library_path() != path
    monkeypatch.setattr(tnat, "_host_key", lambda: "another cpu")
    assert tnat.library_path() != path
