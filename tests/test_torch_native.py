"""The port's native union-find (`native/cluster.cpp`, the JAX package's
code, built with g++ at first use) against scipy, the
port's own `find_clusters`, and the JAX package's native path: the same
partitions, listed in the same order (by smallest member, members
ascending)."""

from pathlib import Path

import numpy as np
import pytest
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components

from nmc_tpu import native as j_native
from nmc_tpu_torch import native
from nmc_tpu_torch.ops.clusters import (disagreement_clusters,
                                        disagreement_clusters_adj,
                                        find_clusters)

from conftest import random_sk

ROOT = Path(__file__).resolve().parent.parent


def sparse_J(rng, n=40, degree=3):
    J = np.zeros((n, n))
    for i in range(n):
        for j in rng.choice(n, size=degree, replace=False):
            if i != j:
                J[i, j] = J[j, i] = rng.normal()
    return J


def _scipy_components(J, active):
    """Components of the active subgraph by scipy, by smallest member."""
    idx = np.flatnonzero(active)
    if idx.size == 0:
        return []
    sub = csr_matrix((J[np.ix_(idx, idx)] != 0).astype(np.int8))
    ncomp, labels = connected_components(sub, directed=False)
    comps = [idx[labels == c] for c in range(ncomp)]
    return sorted(comps, key=lambda c: c[0])


def _same(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


def _code(path):
    """The source without its // comments and blank lines."""
    lines = (ln.split("//", 1)[0].rstrip() for ln in path.read_text()
             .splitlines())
    return [ln for ln in lines if ln]


def test_source_is_the_jax_packages_code():
    """The same code as the JAX package's cluster.cpp, line for line; only
    comments differ (they name the port's loader)."""
    ours = _code(ROOT / "nmc_tpu_torch/native/cluster.cpp")
    assert ours == _code(ROOT / "nmc_tpu/native/cluster.cpp")
    assert len(ours) > 80


@pytest.mark.parametrize("density", [0.1, 0.5, 0.9])
def test_connected_components_against_scipy(rng, density):
    J = sparse_J(rng, n=60)
    adj = native.CSRAdjacency(J)
    for _ in range(8):
        active = rng.random(60) < density
        got = native.connected_components_masked(adj, active)
        assert _same(got, _scipy_components(J, active))
        if j_native.available():
            assert _same(got, j_native.connected_components_masked(
                j_native.CSRAdjacency(J), active))


def test_disagreement_clusters_adj_is_the_union_find(rng):
    J = sparse_J(rng)
    adj = native.CSRAdjacency(J)
    for _ in range(10):
        s1 = np.sign(rng.normal(size=40))
        s2 = np.sign(rng.normal(size=40))
        a = disagreement_clusters_adj(adj, s1, s2)
        assert _same(a, disagreement_clusters(J, s1, s2))
        assert _same(a, native.connected_components_masked(adj, s1 * s2 < 0))
    assert disagreement_clusters_adj(adj, s1, s1) == []


def test_dense_and_empty(rng):
    J, _ = random_sk(rng, 20)
    adj = native.CSRAdjacency(J)
    comps = native.connected_components_masked(adj, np.ones(20, bool))
    assert len(comps) == 1 and comps[0].size == 20
    assert native.connected_components_masked(adj, np.zeros(20, bool)) == []


@pytest.mark.parametrize("thresholds", [(0.6, 0.3, 0.01), (0.9, 0.5, 0.05),
                                        (0.99, 0.98, 0.01)])
def test_backbone_clusters_against_find_clusters(rng, thresholds):
    """The native pass claims the members `find_clusters` claims, cluster
    by cluster in seed order."""
    J = sparse_J(rng, n=50)
    adj = native.CSRAdjacency(J)
    for _ in range(5):
        mag = np.tanh(2.5 * rng.normal(size=50))
        ours = native.backbone_clusters(adj, mag, *thresholds)
        ref = find_clusters(J, mag, *thresholds)
        assert sorted(tuple(c.tolist()) for c in ours) == \
            sorted(tuple(sorted(c.tolist())) for c in ref)
        if j_native.available():
            assert _same(ours, j_native.backbone_clusters(
                j_native.CSRAdjacency(J), mag, *thresholds))


def test_library_is_built_once_and_keyed(tmp_path, monkeypatch):
    """The cluster library sits in native/_build, its name keyed by source,
    flags and CPU; a failed build raises with the compiler's output."""
    path = native.library_path(native._CLUSTER_SRC)
    native.load_cluster_library()
    assert Path(path).exists() and Path(path).parent.name == "_build"
    assert Path(path).name.startswith("libnmccluster-")
    assert path != native.library_path()
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="bad.cpp"):
        native._build(str(tmp_path / "bad.so"), str(bad))
