"""The port's leaf-peeling presolve (`nmc_tpu_torch/ops/presolve.py`) and its
contrived-instance generators are copies of nmc_tpu's: held array-equal to
the originals on numpy-seeded instances (contrived Wishart backbones,
random trees with fields, an instance with no leaf), with back-substitution
exact in f64: E(full) = E(core) + constant."""

import numpy as np
import pytest

from nmc_tpu.io import generators as jgen
from nmc_tpu.ops import presolve as jpre
from nmc_tpu_torch.io import generators as tgen
from nmc_tpu_torch.ops import presolve as tpre


def _random_tree(n, seed, cross=0):
    """A random tree on n spins (Gaussian couplings and fields), plus
    `cross` extra couplings that close cycles."""
    rng = np.random.default_rng(seed)
    J = np.zeros((n, n))
    for i in range(1, n):
        p = rng.integers(0, i)
        J[i, p] = J[p, i] = rng.normal()
    for _ in range(cross):
        a, b = rng.choice(n, 2, replace=False)
        J[a, b] = J[b, a] = rng.normal()
    return J, rng.normal(size=n)


def _instances():
    out = []
    for seed in (0, 3):
        prob, _, _ = tgen.contrived_wishart_backbone(6, alpha=0.5, seed=seed)
        out.append((f"contrived{seed}", prob.J, prob.h))
    prob, _, _ = tgen.contrived_wishart_backbone(5, alpha=0.4, seed=1,
                                                 tree_depth=3, cross_links=4)
    out.append(("contrived_cross", prob.J, prob.h))
    for seed, cross in ((1, 0), (2, 3), (5, 6)):
        J, h = _random_tree(14, seed, cross)
        out.append((f"tree{seed}_{cross}", J, h))
    sk = tgen.random_sk(9, seed=4, h_scale=0.5)       # dense: no leaf
    out.append(("noleaf", sk.J, sk.h))
    return out


INSTANCES = _instances()


@pytest.mark.parametrize("case", INSTANCES, ids=[c[0] for c in INSTANCES])
def test_peel_leaves_equals_jax(case):
    _, J, h = case
    a, b = tpre.peel_leaves(J, h), jpre.peel_leaves(J, h)
    np.testing.assert_array_equal(a.core, b.core)
    np.testing.assert_array_equal(a.J_core, b.J_core)
    np.testing.assert_array_equal(a.h_core, b.h_core)
    assert a.constant == b.constant and a.n == b.n
    assert a.order == b.order
    if case[0] == "noleaf":
        assert a.core.size == J.shape[0] and a.constant == 0.0


@pytest.mark.parametrize("case", INSTANCES, ids=[c[0] for c in INSTANCES])
def test_back_substitute_equals_jax_and_is_exact(case):
    _, J, h = case
    a, b = tpre.peel_leaves(J, h), jpre.peel_leaves(J, h)
    rng = np.random.default_rng(7)
    for _ in range(4):
        s_core = rng.choice([-1.0, 1.0], a.core.size)
        s = a.back_substitute(s_core)
        np.testing.assert_array_equal(s, b.back_substitute(s_core))
        np.testing.assert_array_equal(s[a.core], s_core)
        e_core = (-0.5 * s_core @ a.J_core @ s_core - a.h_core @ s_core)
        e_full = a.energy(s, J, h)
        assert e_full == b.energy(s, J, h)
        np.testing.assert_allclose(e_full, e_core + a.constant,
                                   rtol=0, atol=1e-12)


def test_forest_presolves_to_its_ground_state():
    J, h = _random_tree(12, seed=11)
    ps = tpre.peel_leaves(J, h)
    assert ps.core.size == 0
    s = ps.back_substitute(np.zeros(0))
    states = 1.0 - 2.0 * ((np.arange(1 << 12)[:, None]
                           >> np.arange(12)) & 1)
    e = -0.5 * np.einsum("ci,ij,cj->c", states, J, states) - states @ h
    assert abs(ps.energy(s, J, h) - e.min()) < 1e-10
    assert abs(ps.constant - e.min()) < 1e-10


@pytest.mark.parametrize("args", [(6, 0.5, 0), (8, 0.2, 3, 2, 5, 0.2),
                                  (4, 0.3, 1, 1)])
def test_contrived_wishart_backbone_equals_jax(args):
    a, ta, ea = tgen.contrived_wishart_backbone(*args)
    b, tb, eb = jgen.contrived_wishart_backbone(*args)
    np.testing.assert_array_equal(a.J, b.J)
    np.testing.assert_array_equal(a.h, b.h)
    np.testing.assert_array_equal(ta, tb)
    assert (ea == eb) or (np.isnan(ea) and np.isnan(eb))
    assert a.name == b.name


@pytest.mark.parametrize("n_backbone, levels", [(3, 1), (5, 2), (4, 3)])
def test_contrived_tree_adjacency_equals_jax(n_backbone, levels):
    np.testing.assert_array_equal(
        tgen.contrived_tree_adjacency(n_backbone, levels),
        jgen.contrived_tree_adjacency(n_backbone, levels))
