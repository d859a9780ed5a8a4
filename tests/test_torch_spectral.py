"""The port's spectral search (`nmc_tpu_torch/ops/spectral.py`) against
nmc_tpu's on numpy-seeded instances.

The host functions are copies: array-equal to the originals at the same
seeds, with and without fields, `top_k`, `num_subspace` and `dm_starts`.
The torch device functions run here on the CPU: `batched_descent_device`
equals JAX's on the same S (f64 and f32, ties to the first index in both);
`difference_map_rounding_device` given JAX's X0 gives JAX's pooled
snapshots; `spectral_candidates_device` reaches JAX's best energy (rtol
1e-5) with every candidate 1-flip stable. Eigenvectors are never compared:
their signs and the order inside degenerate eigenspaces differ between
LAPACK drivers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmc_tpu.ops import spectral as jsp
from nmc_tpu_torch.io.generators import random_sk, wishart_planted
from nmc_tpu_torch.ops import spectral as tsp


def _sym(n, seed, h=False):
    prob = random_sk(n, seed=seed, h_scale=0.7 if h else 0.0)
    return prob.J, (prob.h if h else None)


def _one_flip_stable(J, h, S, tol=1e-9):
    F = S @ J + (0.0 if h is None else h[None, :])
    return bool(np.all(2.0 * S * F >= -tol))


@pytest.mark.parametrize("with_h", [False, True])
def test_greedy_two_flip_and_batched_host_equal_jax(with_h):
    J, h = _sym(18, 1, with_h)
    rng = np.random.default_rng(3)
    S0 = rng.choice([-1.0, 1.0], (9, 18))
    for s0 in S0[:3]:
        for fn in ("greedy_descent", "two_flip_descent"):
            a, fa = getattr(tsp, fn)(J, s0, h)
            b, fb = getattr(jsp, fn)(J, s0, h)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(tsp.batched_descent_host(J, S0, h),
                                  jsp.batched_descent_host(J, S0, h))


def test_auto_subspace_dim_equals_jax():
    for n, seed in ((12, 0), (40, 1), (3, 2), (7, 5)):
        prob, _, _ = wishart_planted(n, 0.5, seed=seed)
        w = np.linalg.eigvalsh(prob.J)
        assert tsp.auto_subspace_dim(w) == jsp.auto_subspace_dim(w)
        assert tsp.auto_subspace_dim(w, min_top_frac=0.5) == \
            jsp.auto_subspace_dim(w, min_top_frac=0.5)


@pytest.mark.parametrize("kw", [dict(), dict(iters=30, snapshot_every=7),
                                dict(iters=5, snapshot_every=20, seed=4)])
def test_difference_map_rounding_equals_jax(kw):
    prob, _, _ = wishart_planted(16, 0.5, seed=2)
    _, v = np.linalg.eigh(prob.J)
    V = v[:, 8:]
    kw = dict(dict(num_starts=32, iters=60), **kw)
    np.testing.assert_array_equal(tsp.difference_map_rounding(V, **kw),
                                  jsp.difference_map_rounding(V, **kw))


CANDIDATE_CASES = [
    ("sk", False, dict()),
    ("sk_h", True, dict()),
    ("sk_top", False, dict(top_k=5)),
    ("sk_h_sub", True, dict(num_subspace=12, subspace_dim=6, seed=3)),
    ("sk_sub_default_dim", False, dict(num_subspace=7)),
    ("wishart_dm", None, dict(dm_starts=24, dm_iters=60, seed=1)),
    ("wishart_dm_dim", None, dict(dm_starts=16, dm_iters=40, dm_dim=7,
                                  top_k=4, num_subspace=3)),
]


@pytest.mark.parametrize("name, with_h, kw", CANDIDATE_CASES,
                         ids=[c[0] for c in CANDIDATE_CASES])
def test_spectral_candidates_equal_jax(name, with_h, kw):
    if with_h is None:
        prob, _, _ = wishart_planted(20, 0.5, seed=6)
        J, h = prob.J, None
    else:
        J, h = _sym(16, 2, with_h)
    Sa, Ea = tsp.spectral_candidates(J, h, **kw)
    Sb, Eb = jsp.spectral_candidates(J, h, **kw)
    np.testing.assert_array_equal(Sa, Sb)
    np.testing.assert_array_equal(Ea, Eb)
    assert _one_flip_stable(J, h, Sa)


@pytest.mark.parametrize("kw", [dict(polish=0), dict(polish=4),
                                dict(dm_starts=32, dm_iters=80, polish=2)])
def test_spectral_search_equals_jax(kw):
    from nmc_tpu.core.problem import IsingProblem as JProblem
    from nmc_tpu_torch.core.problem import IsingProblem
    prob, t, e = wishart_planted(18, 0.4, seed=8)
    h = np.random.default_rng(1).normal(size=18) * 0.2
    for hh in (np.zeros(18), h):
        a = tsp.spectral_search(IsingProblem(prob.J, hh), **kw)
        b = jsp.spectral_search(JProblem(prob.J, hh), **kw)
        np.testing.assert_array_equal(a.best_state, b.best_state)
        assert a.best_energy == b.best_energy
        np.testing.assert_array_equal(a.states, b.states)
        np.testing.assert_array_equal(a.energies, b.energies)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("with_h", [False, True])
def test_batched_descent_device_equals_jax(dtype, with_h):
    """The same S gives the same states: the flip rule (dE < -1e-6, the
    first index on ties) and the field update are JAX's. Integer couplings
    make ties common (the first-index rule decides) and every sum exact."""
    rng = np.random.default_rng(5)
    n, C = 24, 40
    J = rng.integers(-2, 3, (n, n)).astype(np.float64)
    J = np.triu(J, 1) + np.triu(J, 1).T
    h = rng.integers(-1, 2, n).astype(np.float64) if with_h else None
    S0 = rng.choice([-1.0, 1.0], (C, n))
    got = tsp.batched_descent_device(
        torch.as_tensor(J, dtype=getattr(torch, dtype)),
        torch.as_tensor(S0, dtype=getattr(torch, dtype)),
        None if h is None else torch.as_tensor(h, dtype=getattr(torch, dtype)))
    want = jsp.batched_descent_device(
        jnp.asarray(J, dtype), jnp.asarray(S0, dtype),
        None if h is None else jnp.asarray(h, dtype))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _one_flip_stable(J, h, got.double().numpy())
    # max_iters bounds the steps as JAX's loop does
    capped = tsp.batched_descent_device(
        torch.as_tensor(J), torch.as_tensor(S0),
        None if h is None else torch.as_tensor(h), max_iters=2)
    want2 = jsp.batched_descent_device(
        jnp.asarray(J), jnp.asarray(S0),
        None if h is None else jnp.asarray(h), max_iters=2)
    np.testing.assert_array_equal(capped.numpy(), np.asarray(want2))


def test_batched_descent_device_float_couplings_equal_jax():
    prob, _, _ = wishart_planted(30, 0.5, seed=4)
    S0 = np.random.default_rng(2).choice([-1.0, 1.0], (64, 30))
    got = tsp.batched_descent_device(torch.as_tensor(prob.J),
                                     torch.as_tensor(S0))
    want = jsp.batched_descent_device(jnp.asarray(prob.J), jnp.asarray(S0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("iters, every", [(40, 10), (7, 20)])
def test_difference_map_rounding_device_equals_jax_from_its_x0(iters, every):
    """JAX's X0 = normal(key, (C, n)) injected: the pooled snapshots are
    JAX's (f64, few enough steps that no entry of PA sits at a sign)."""
    prob, _, _ = wishart_planted(16, 0.5, seed=3)
    _, v = np.linalg.eigh(prob.J)
    V = v[:, 8:]
    key = jax.random.PRNGKey(11)
    x0 = np.array(jax.random.normal(key, (32, 16), jnp.float64))
    got = tsp.difference_map_rounding_device(
        torch.as_tensor(V), num_starts=32, iters=iters,
        snapshot_every=every, x0=torch.as_tensor(x0))
    want = jsp.difference_map_rounding_device(
        jnp.asarray(V), num_starts=32, iters=iters, snapshot_every=every,
        key=key, dtype=jnp.float64)
    assert got.shape == (max(1, iters // every) * 32, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(np.unique(got.numpy())) <= {-1.0, 1.0}


@pytest.mark.parametrize("case", ["sk", "sk_h", "wishart", "wishart_dm"])
def test_spectral_candidates_device_reaches_jax_best(case):
    """Same best energy as JAX's device search (rtol 1e-5), every returned
    state 1-flip stable in f64, the best state of an h = 0 instance JAX's
    up to a global flip. Where the eigenvalues are distinct the host
    search's best too; on a wishart's near-degenerate top eigenspace f32
    and f64 eigenvectors round differently, and only the difference-map
    pool is held to the planted energy."""
    kw = {}
    if case.startswith("sk"):
        J, h = _sym(20, 9, case == "sk_h")
    else:
        prob, t, e = wishart_planted(24, 0.5, seed=1)
        J, h = prob.J, None
        if case == "wishart_dm":
            kw = dict(dm_starts=256, dm_iters=300, dm_dim=13)
    S, E = tsp.spectral_candidates_device(
        J, h, device="cpu", dtype="float32",
        generator=torch.Generator().manual_seed(0), **kw)
    S64 = S.double().numpy()
    Sj, Ej = jsp.spectral_candidates_device(
        jnp.asarray(J, jnp.float32),
        None if h is None else jnp.asarray(h, jnp.float32), **kw)
    assert S.dtype == torch.float32 and S.device.type == "cpu"
    assert np.all(np.diff(E.numpy()) >= 0)
    np.testing.assert_allclose(float(E[0]), float(Ej[0]), rtol=1e-5)
    assert _one_flip_stable(J, h, S64)
    e64 = -(0.5 * np.einsum("ci,ij,cj->c", S64, J, S64)
            + (0.0 if h is None else S64 @ h))
    np.testing.assert_allclose(E.numpy(), e64, rtol=1e-5, atol=1e-5)
    if h is None:
        b = np.asarray(Sj[0], np.float64)
        assert np.array_equal(S64[0], b) or np.array_equal(S64[0], -b)
    if case.startswith("sk"):       # distinct eigenvalues: host = device
        _, Eh = tsp.spectral_candidates(J, h)
        np.testing.assert_allclose(float(E[0]), Eh[0], rtol=1e-5)
    if case == "wishart_dm":        # the pool finds the planted state
        np.testing.assert_allclose(float(E[0]), e, rtol=1e-5)


def test_device_functions_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    J, _ = _sym(8, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsp.spectral_candidates_device(J)
