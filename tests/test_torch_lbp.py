"""nmc_tpu_torch.ops.lbp against nmc_tpu.ops.lbp (f64).

Marginals, beliefs and messages agree to 1e-10 and iteration counts are
equal. The instances are chosen so the chains converge at different
iterations (the batch must freeze each chain at its own convergence, as
jax.vmap of lax.while_loop does) and so later rungs diverge for some
chains (the per-chain fallback of lbp_convexified_batch)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmc_tpu.io.generators import chimera_graph, random_sk
from nmc_tpu.ops import lbp as jl
from nmc_tpu_torch.ops import lbp as tl

from torch_parity import t64

LADDER = dict(lambda_start=0.5, lambda_end=0.01, lambda_reduction_factor=0.9)
TOL = 1e-10


def _instance(name):
    """(J, h, beta, m_stars [4, N]) with the LBP behaviour noted per case."""
    rng = np.random.default_rng(0)
    if name == "sk12":
        prob, beta = random_sk(12, seed=1, h_scale=0.5), 1.0
        h = prob.h
    else:
        prob, beta = chimera_graph(2, 2, seed=3).normalized()[0], 2.5
        h = prob.h + 0.2 * rng.normal(size=prob.n)
    m_stars = np.where(rng.random((4, prob.n)) < 0.5, -1.0, 1.0)
    return prob.J, h, beta, m_stars


def _eps(J, h):
    return jl.convexification_epsilon(J, h)


@pytest.mark.parametrize("name,max_it", [("sk12", 25), ("chimera_2x2", 40)])
def test_lbp_single_and_batched_match_jax(name, max_it):
    J, h, beta, m_stars = _instance(name)
    u0 = J[None, :, :] * m_stars[:, None, :]
    h0 = np.zeros_like(u0)
    vlbp = jax.vmap(functools.partial(jl.loopy_belief_propagation,
                                      max_iterations=max_it),
                    in_axes=(None, 0, None, 0, 0, None))
    hl = h[None, :] + 0.5 * m_stars * _eps(J, h)[None, :]
    jr = vlbp(jnp.asarray(J), jnp.asarray(hl), beta, jnp.asarray(h0),
              jnp.asarray(u0), TOL)
    tr = tl.loopy_belief_propagation(t64(J), t64(hl), beta, t64(h0), t64(u0),
                                     TOL, max_iterations=max_it)
    np.testing.assert_array_equal(tr.iterations.numpy(),
                                  np.asarray(jr.iterations))
    for f in ("magnetizations", "belief", "h_msgs", "u_msgs",
              "correlations"):
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(jr, f)), rtol=0,
                                   atol=1e-10, err_msg=f)
    # atanh amplifies ulp differences next to saturation (|m| -> 1), so the
    # effective couplings are compared where they are well conditioned
    for f, x in (("h_tilde", "magnetizations"), ("J_tilde", "correlations")):
        ok = np.abs(np.asarray(getattr(jr, x))) < 0.999
        np.testing.assert_allclose(getattr(tr, f).numpy()[ok],
                                   np.asarray(getattr(jr, f))[ok], rtol=0,
                                   atol=1e-8, err_msg=f)
    # single chain (no batch axis) equals its row of the batch
    s = tl.loopy_belief_propagation(t64(J), t64(hl[1]), beta, t64(h0[1]),
                                    t64(u0[1]), TOL, max_iterations=max_it)
    assert int(s.iterations) == int(jr.iterations[1])
    np.testing.assert_allclose(s.belief.numpy(), np.asarray(jr.belief[1]),
                               rtol=0, atol=1e-10)


def test_batch_chains_converge_at_their_own_iteration():
    J, h, beta, m_stars = _instance("sk12")
    hl = h[None, :] + 0.5 * m_stars * _eps(J, h)[None, :]
    u0 = J[None, :, :] * m_stars[:, None, :]
    tr = tl.loopy_belief_propagation(t64(J), t64(hl), beta,
                                     t64(np.zeros_like(u0)), t64(u0), TOL,
                                     max_iterations=25)
    assert len(set(tr.iterations.tolist())) > 1


@pytest.mark.parametrize("name,max_it,chain", [
    ("sk12", 25, 0),           # converges at rung 0, diverges at rung 7
    ("sk12", 40, 2),           # converges on every rung
    ("chimera_2x2", 40, 0),    # diverges at rung 5
])
def test_lbp_convexified_matches_jax(name, max_it, chain):
    J, h, beta, m_stars = _instance(name)
    kw = dict(LADDER, tolerance=TOL, max_iterations=max_it)
    jr = jl.lbp_convexified(jnp.asarray(J), jnp.asarray(h), beta,
                            m_stars[chain], _eps(J, h), keep_history=True,
                            **kw)
    tr = tl.lbp_convexified(t64(J), t64(h), beta, m_stars[chain], _eps(J, h),
                            keep_history=True, **kw)
    np.testing.assert_allclose(tr.marginal, jr.marginal, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tr.belief, jr.belief, rtol=0, atol=1e-10)
    assert list(tr.marginals_all) == list(jr.marginals_all)
    for lam in jr.marginals_all:
        np.testing.assert_allclose(tr.marginals_all[lam],
                                   jr.marginals_all[lam], rtol=0, atol=1e-10)
        ok = np.abs(jr.marginals_all[lam]) < 0.999
        np.testing.assert_allclose(tr.h_tilde_all[lam][ok],
                                   jr.h_tilde_all[lam][ok], rtol=0, atol=1e-8)
        assert abs(tr.mean_marginals_all[lam]
                   - jr.mean_marginals_all[lam]) < 1e-10


@pytest.mark.parametrize("name,max_it", [("sk12", 25), ("sk12", 40)])
def test_lbp_convexified_batch_matches_jax(name, max_it):
    J, h, beta, m_stars = _instance(name)
    kw = dict(LADDER, tolerance=TOL, max_iterations=max_it,
              return_belief=True)
    jm, jb = jl.lbp_convexified_batch(jnp.asarray(J), jnp.asarray(h), beta,
                                      m_stars, _eps(J, h), **kw)
    tm, tb = tl.lbp_convexified_batch(t64(J), t64(h), beta, m_stars,
                                      _eps(J, h), **kw)
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-10)
    single = tl.lbp_convexified(t64(J), t64(h), beta, m_stars[3], _eps(J, h),
                                **{k: v for k, v in kw.items()
                                   if k != "return_belief"})
    np.testing.assert_allclose(tb[3], single.belief, rtol=0, atol=1e-10)


def test_divergence_at_first_rung_raises_in_both():
    J, h, beta, m_stars = _instance("chimera_2x2")   # chain 3 diverges at rung 0
    kw = dict(LADDER, tolerance=TOL, max_iterations=40)
    with pytest.raises(ValueError, match="diverged at initial lambda"):
        jl.lbp_convexified_batch(jnp.asarray(J), jnp.asarray(h), beta,
                                 m_stars, _eps(J, h), **kw)
    with pytest.raises(ValueError, match="diverged at initial lambda"):
        tl.lbp_convexified_batch(t64(J), t64(h), beta, m_stars, _eps(J, h),
                                 **kw)
    for mod, conv in ((jl, jnp.asarray), (tl, t64)):
        with pytest.raises(ValueError, match="diverged at initial lambda"):
            mod.lbp_convexified(conv(J), conv(h), beta, m_stars[3],
                                _eps(J, h), **kw)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_atanh_saturated(dtype):
    x = np.array([-1.0, -0.999999, -0.5, 0.0, 0.3, 0.9999, 1.0], dtype=dtype)
    a = tl.atanh_saturated(torch.as_tensor(x)).numpy()
    b = np.asarray(jl.atanh_saturated(jnp.asarray(x)))
    assert np.isfinite(a).all()
    if dtype == "float32":
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    else:
        # the f64 clip bound tanh(19.06) - eps sits within 1e-15 of 1, where
        # XLA's and torch's f64 tanh round differently; values inside it agree
        inner = np.abs(x) < 1.0
        np.testing.assert_allclose(a[inner], b[inner], rtol=0, atol=1e-12)
        assert np.all(np.abs(a[~inner]) > 17.0)
    assert tl.lambda_ladder(0.5, 0.01, 0.9) == jl.lambda_ladder(0.5, 0.01, 0.9)


def test_f32_tolerance_floor_reports_convergence():
    """In f32 the reference's f64-eps tolerance is floored at 4 eps, so a
    converging solve stops before max_iterations, as in the JAX package."""
    J, h, beta, m_stars = _instance("sk12")
    u0 = (J * m_stars[0][None, :]).astype(np.float32)
    args = (J.astype(np.float32), (h + 0.5 * m_stars[0] * _eps(J, h))
            .astype(np.float32), beta, np.zeros_like(u0), u0,
            float(np.finfo(np.float64).eps))
    tr = tl.loopy_belief_propagation(*(torch.as_tensor(a) if isinstance(
        a, np.ndarray) else a for a in args), max_iterations=200)
    jr = jl.loopy_belief_propagation(*(jnp.asarray(a) if isinstance(
        a, np.ndarray) else a for a in args), max_iterations=200)
    assert int(tr.iterations) < 199 and int(jr.iterations) < 199
    np.testing.assert_allclose(tr.belief.numpy(), np.asarray(jr.belief),
                               atol=1e-4)
