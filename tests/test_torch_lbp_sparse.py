"""nmc_tpu_torch.ops.lbp_sparse against nmc_tpu.ops.lbp_sparse (f64).

Messages, marginals and beliefs agree with the JAX package to 1e-10 and the
iteration counts and convergence flags are equal. On the chimera instance
below, with max_iterations = 40, every chain but one converges at the
first rung and diverges at a later one (rungs 2 to 17), and chain 3
diverges at the first rung, so the ladder's fallback, the batch's
per-chain freezing and the first-rung error are all exercised.
"""

import numpy as np
import pytest
import torch

from nmc_tpu.io.generators import chimera_graph
from nmc_tpu.ops import lbp_sparse as js
from nmc_tpu.ops.lbp import convexification_epsilon
from nmc_tpu_torch.ops import lbp as tl
from nmc_tpu_torch.ops import lbp_sparse as ts

from torch_parity import t64

LADDER = dict(lambda_start=0.5, lambda_end=0.01, lambda_reduction_factor=0.9,
              tolerance=1e-10, max_iterations=40)
BETA = 2.5
CONVERGING_FIRST = [0, 1, 2, 4, 5, 6, 7]   # chains that pass rung 0


def _instance():
    prob = chimera_graph(2, 2, seed=3).normalized()[0]
    rng = np.random.default_rng(0)
    h = prob.h + 0.2 * rng.normal(size=prob.n)
    m_stars = np.where(rng.random((8, prob.n)) < 0.5, -1.0, 1.0)
    return prob.J, h, m_stars


def _sparse_instance(rng, n=30, degree=3):
    """A random sparse graph, as tests/test_lbp_sparse.py builds it."""
    J = np.zeros((n, n))
    for i in range(n):
        for j in rng.choice(n, size=degree, replace=False):
            if i != j and J[i, j] == 0:
                J[i, j] = J[j, i] = rng.normal() * 0.4
    return J, rng.normal(size=n) * 0.3


def test_edge_graph_matches_jax():
    J, _, _ = _instance()
    jg, tg = js.EdgeGraph.from_dense(J), ts.EdgeGraph.from_dense(J)
    for f in ("src", "dst", "weight", "rev"):
        np.testing.assert_array_equal(getattr(tg, f),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    assert tg.n == jg.n and tg.num_edges == jg.num_edges
    E = tg.num_edges
    for i in range(tg.n):            # in-edge table: each node's in-edges
        row = tg.in_edges[i]
        np.testing.assert_array_equal(row[row < E], np.flatnonzero(tg.dst == i))
        assert (row[row >= E] == E).all()


def test_in_edge_sum_equals_index_add():
    J, _, _ = _instance()
    g = ts.EdgeGraph.from_dense(J)
    u = torch.as_tensor(np.random.default_rng(1).normal(size=(3, g.num_edges)))
    want = torch.zeros((3, g.n), dtype=u.dtype).index_add_(
        1, torch.as_tensor(g.dst, dtype=torch.int64), u)
    got = ts._in_sum(u, torch.as_tensor(g.in_edges))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


def test_sparse_lbp_matches_jax_per_chain_and_batched():
    J, h, m_stars = _instance()
    jg, tg = js.EdgeGraph.from_dense(J), ts.EdgeGraph.from_dense(J)
    eps = convexification_epsilon(J, h)
    hl = h[None, :] + 0.5 * m_stars * eps[None, :]
    u0 = tg.weight[None, :] * m_stars[:, tg.dst]
    tr = ts.sparse_lbp(tg.tensors("cpu", torch.float64), t64(hl), BETA,
                       t64(u0), 1e-10, max_iterations=40)
    iters = []
    for r in range(m_stars.shape[0]):
        jr = js.sparse_lbp(jg.src, jg.dst, jg.weight, jg.rev, hl[r], BETA,
                           u0[r], 1e-10, max_iterations=40, num_nodes=jg.n)
        assert int(tr.iterations[r]) == int(jr.iterations)
        assert bool(tr.converged[r]) == bool(jr.converged)
        for f in ("magnetizations", "belief", "u_msgs"):
            np.testing.assert_allclose(getattr(tr, f)[r].numpy(),
                                       np.asarray(getattr(jr, f)), rtol=0,
                                       atol=1e-10, err_msg=f)
        # atanh amplifies ulp differences next to saturation, and the f64
        # saturation bound follows each framework's tanh(19.06) (see
        # tests/test_torch_lbp.py), so h_tilde is compared where the
        # marginal is well conditioned
        ok = np.abs(np.asarray(jr.magnetizations)) < 0.999
        np.testing.assert_allclose(tr.h_tilde[r].numpy()[ok],
                                   np.asarray(jr.h_tilde)[ok], rtol=0,
                                   atol=1e-8)
        iters.append(int(jr.iterations))
    assert len(set(iters)) > 1      # the chains stop at different iterations


@pytest.mark.parametrize("chain", [0, 1, 4, 5])
def test_sparse_lbp_convexified_matches_jax(chain):
    J, h, m_stars = _instance()
    eps = convexification_epsilon(J, h)
    jm, jb = js.sparse_lbp_convexified(js.EdgeGraph.from_dense(J), h, BETA,
                                       m_stars[chain], eps,
                                       return_belief=True, **LADDER)
    tm, tb = ts.sparse_lbp_convexified(ts.EdgeGraph.from_dense(J), t64(h),
                                       BETA, m_stars[chain], eps,
                                       return_belief=True, **LADDER)
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-10)
    assert np.array_equal(tm, ts.sparse_lbp_convexified(
        ts.EdgeGraph.from_dense(J), t64(h), BETA, m_stars[chain], eps,
        **LADDER))


def test_divergence_at_first_rung_raises_in_both():
    J, h, m_stars = _instance()
    eps = convexification_epsilon(J, h)
    with pytest.raises(ValueError, match="diverged at initial lambda"):
        js.sparse_lbp_convexified(js.EdgeGraph.from_dense(J), h, BETA,
                                  m_stars[3], eps, **LADDER)
    g = ts.EdgeGraph.from_dense(J)
    with pytest.raises(ValueError, match="diverged at initial lambda"):
        ts.sparse_lbp_convexified(g, t64(h), BETA, m_stars[3], eps, **LADDER)
    with pytest.raises(ValueError, match="diverged at initial lambda"):
        ts.sparse_lbp_convexified_batch(g, t64(h), BETA, m_stars, eps,
                                        **LADDER)


def test_batch_matches_per_chain_row_for_row():
    """Each chain of the batch leaves it at its own divergence rung and
    keeps its previous marginal, as the per-chain ladder stops there.
    Tolerance 1e-12: torch's CPU atanh may round an element differently
    in a vector lane and in the scalar tail of a loop, so a chain's row can
    differ from the one-chain solve in the last bit."""
    J, h, m_stars = _instance()
    rows = m_stars[CONVERGING_FIRST]
    eps = convexification_epsilon(J, h)
    g = ts.EdgeGraph.from_dense(J)
    bm, bb = ts.sparse_lbp_convexified_batch(g, t64(h), BETA, rows, eps,
                                             return_belief=True, **LADDER)
    for r in range(rows.shape[0]):
        m, b = ts.sparse_lbp_convexified(g, t64(h), BETA, rows[r], eps,
                                         return_belief=True, **LADDER)
        np.testing.assert_allclose(bm[r], m, rtol=0, atol=1e-12)
        np.testing.assert_allclose(bb[r], b, rtol=0, atol=1e-12)
        jm = js.sparse_lbp_convexified(js.EdgeGraph.from_dense(J), h, BETA,
                                       rows[r], eps, **LADDER)
        np.testing.assert_allclose(bm[r], jm, rtol=0, atol=1e-10)


def test_sparse_matches_dense_lbp(rng):
    """The edge recursion is the dense one restricted to nonzero couplings
    (the check tests/test_lbp_sparse.py makes for the JAX package)."""
    J, h = _sparse_instance(rng)
    n = J.shape[0]
    dense = tl.loopy_belief_propagation(
        t64(J), t64(h), 0.8, torch.zeros((n, n), dtype=torch.float64),
        torch.zeros((n, n), dtype=torch.float64), 1e-10, max_iterations=300)
    g = ts.EdgeGraph.from_dense(J)
    sparse = ts.sparse_lbp(g.tensors("cpu", torch.float64), t64(h), 0.8,
                           torch.zeros(g.num_edges, dtype=torch.float64),
                           1e-10, max_iterations=300)
    np.testing.assert_allclose(sparse.magnetizations.numpy(),
                               dense.magnetizations.numpy(), atol=1e-7)
    np.testing.assert_allclose(sparse.h_tilde.numpy(), dense.h_tilde.numpy(),
                               atol=1e-6)

    eps = tl.convexification_epsilon(J, h)
    m_star = np.sign(rng.normal(size=n))
    kw = dict(lambda_start=2.0, lambda_end=0.01, lambda_reduction_factor=0.7,
              tolerance=1e-9, max_iterations=300)
    dense_c = tl.lbp_convexified(t64(J), t64(h), 2.0, m_star, eps, **kw)
    sparse_c = ts.sparse_lbp_convexified(g, t64(h), 2.0, m_star, eps, **kw)
    np.testing.assert_allclose(sparse_c, dense_c.marginal, atol=1e-6)
