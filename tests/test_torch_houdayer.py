"""The port's Houdayer ops (nmc_tpu_torch/ops/clusters.py) against nmc_tpu's.

  * host: `disagreement_clusters`, `CSRAdjacency` and
    `disagreement_clusters_adj` (scipy) equal the JAX package's (whose
    `_adj` runs its native union-find here when it builds), the same
    components in the same order;
  * device: each backend's labels (dense, sparse, blocked, matmul) equal
    JAX's exactly, uncapped and capped at 1 and 2 iterations, on a colored
    ea_2d, a colored chimera and an uncoloured padded layout, over pairs
    that include an all-agree pair and a cluster larger than n / 2; labels
    are the component minima of the host clusters; a batched call equals
    per-pair calls;
  * the moves from JAX's cluster uniforms: s1, s2, moved and flipped
    equal, the Katzgraber flip included;
  * `NeighborPlanes`: the index table gives JAX's one-hot operands; the
    degree cap raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmc_tpu.core.problem import block_problem, block_sparse_tiles
from nmc_tpu.io.generators import chimera_graph, ea_2d, random_sk
from nmc_tpu.ops import clusters as jc
from nmc_tpu.ops.coloring import color_groups
from nmc_tpu.native import CSRAdjacency as JCSR
from nmc_tpu_torch.ops import clusters as tc

CAPS = [None, 1, 2]


def layout(name):
    """(J [n_pad, n_pad] blocked, active [n_pad], col_idx, J_tiles)."""
    if name == "ea2d_colored":
        prob = ea_2d(6, seed=1)
        b = block_problem(prob, block_size=16, groups=color_groups(prob.J))
    elif name == "chimera_colored":
        prob = chimera_graph(2, 2, seed=3)
        b = block_problem(prob, block_size=16, groups=color_groups(prob.J))
    else:                              # uncoloured, 25 spins in 32
        b = block_problem(ea_2d(5, seed=2), block_size=8)
    n = b.n_pad
    col_idx, J_tiles = block_sparse_tiles(b)
    return b.J_rows.reshape(n, n), b.active, col_idx, J_tiles


def pairs(active, seed=0):
    """[P, n] state pairs: disagreement densities 0.1, 0.45 and 0.9, an
    all-agree pair and an all-disagree pair (one cluster of every active
    spin, above n / 2); padded spins +1 in both."""
    rng = np.random.default_rng(seed)
    n = active.size
    s1, s2 = [], []
    for dens in (0.1, 0.45, 0.9, 0.0, 1.0):
        a = rng.choice([-1.0, 1.0], n)
        b = np.where(rng.random(n) < dens, -a, a)
        if dens == 1.0:
            b = -a
        s1.append(a)
        s2.append(b)
    s1, s2 = np.stack(s1), np.stack(s2)
    s1[:, ~active] = 1.0
    s2[:, ~active] = 1.0
    return s1, s2


def edges(J):
    iu, ju = np.nonzero(np.triu(J, 1))
    return np.concatenate([iu, ju]), np.concatenate([ju, iu])


def jax_labels(backend, ops, s1, s2, cap):
    J, col_idx, J_tiles, planes, src, dst = ops
    out = []
    for a, b in zip(s1, s2):
        if backend == "device":
            x = jc.disagreement_labels_device(jnp.asarray(J), a, b,
                                              num_iters=cap)
        elif backend == "sparse":
            x = jc.disagreement_labels_sparse(src, dst, a, b,
                                              num_nodes=a.size,
                                              num_iters=cap)
        elif backend == "blocked":
            x = jc.disagreement_labels_blocked(col_idx, J_tiles != 0, a, b,
                                               num_iters=cap)
        else:
            x = jc.disagreement_labels_matmul(planes, a, b, num_iters=cap)
        out.append(np.asarray(x))
    return np.stack(out)


def port_labels(backend, ops, s1, s2, cap, stats=None):
    J, col_idx, J_tiles, planes, src, dst = ops
    t1, t2 = torch.as_tensor(s1), torch.as_tensor(s2)
    kw = dict(num_iters=cap, stats=stats)
    if backend == "device":
        return tc.disagreement_labels_device(torch.as_tensor(J), t1, t2, **kw)
    if backend == "sparse":
        return tc.disagreement_labels_sparse(src, dst, t1, t2, **kw)
    if backend == "blocked":
        return tc.disagreement_labels_blocked(
            col_idx, torch.as_tensor(J_tiles != 0), t1, t2, **kw)
    return tc.disagreement_labels_matmul(
        tc.build_neighbor_planes(col_idx, J_tiles), t1, t2, **kw)


def operands(name):
    J, active, col_idx, J_tiles = layout(name)
    src, dst = edges(J)
    return (J, col_idx, J_tiles, jc.build_neighbor_planes(col_idx, J_tiles),
            src, dst), active


@pytest.mark.parametrize("name", ["ea2d_colored", "chimera_colored",
                                  "padded"])
def test_host_clusters_equal(name):
    """The same components in the same order (by smallest member) from
    dense J, from the CSR adjacency over scipy, and from the JAX package."""
    (J, *_), active = operands(name)
    s1, s2 = pairs(active, seed=1)
    adj_j, adj_t = JCSR(J), tc.CSRAdjacency(J)
    np.testing.assert_array_equal(adj_t.indptr, adj_j.indptr)
    np.testing.assert_array_equal(adj_t.indices, adj_j.indices)
    assert adj_t.n == adj_j.n
    for a, b in zip(s1, s2):
        want = jc.disagreement_clusters(J, a, b)
        for got in (tc.disagreement_clusters(J, a, b),
                    tc.disagreement_clusters_adj(adj_t, a, b)):
            assert len(got) == len(want)
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x, y)
        native = jc.disagreement_clusters_adj(adj_j, a, b)
        assert [c.tolist() for c in native] == [c.tolist() for c in want]
    assert tc.disagreement_clusters(J, s1[3], s2[3]) == []


@pytest.mark.parametrize("backend", ["device", "sparse", "blocked",
                                     "matmul"])
@pytest.mark.parametrize("name", ["ea2d_colored", "chimera_colored",
                                  "padded"])
def test_labels_equal_jax(name, backend):
    ops, active = operands(name)
    s1, s2 = pairs(active)
    n = active.size
    for cap in CAPS:
        stats = {}
        got = port_labels(backend, ops, s1, s2, cap, stats).numpy()
        np.testing.assert_array_equal(got, jax_labels(backend, ops, s1, s2,
                                                      cap), err_msg=str(cap))
        assert stats["steps"] >= stats["iterations"] >= 1
        if cap is None:
            # component minima of the host clusters, n elsewhere
            for p in range(s1.shape[0]):
                want = np.full(n, n)
                for c in jc.disagreement_clusters(ops[0], s1[p], s2[p]):
                    want[c] = c.min()
                np.testing.assert_array_equal(got[p], want)
        # a batched call equals per-pair calls, capped ones too
        for p in range(s1.shape[0]):
            one = port_labels(backend, ops, s1[p:p + 1], s2[p:p + 1], cap)
            np.testing.assert_array_equal(one.numpy()[0], got[p])


def test_labels_with_per_instance_operands():
    """Operands with a leading instance axis, picked per pair by `group`,
    equal the shared-operand call on each instance's pairs."""
    ops_a, act = operands("ea2d_colored")
    J_b = ops_a[0].copy()
    iu, ju = np.nonzero(np.triu(J_b, 1))
    J_b[iu[:5], ju[:5]] = J_b[ju[:5], iu[:5]] = 0.0     # 5 couplings fewer
    col_idx = ops_a[1]
    n = act.size
    nB, K, B = ops_a[2].shape[:3]
    tiles_b = np.stack([J_b[i * B:(i + 1) * B].reshape(B, nB, B)[
        :, col_idx[i]].transpose(1, 0, 2) for i in range(nB)])
    s1, s2 = pairs(act, seed=4)
    s1, s2 = np.concatenate([s1, s1]), np.concatenate([s2, s2])
    group = np.repeat([0, 1], s1.shape[0] // 2)
    t1, t2 = torch.as_tensor(s1), torch.as_tensor(s2)
    src_a, dst_a = edges(ops_a[0])
    src_b, dst_b = edges(J_b)
    E = max(src_a.size, src_b.size)
    pad = lambda x: np.concatenate([x, np.full(E - x.size, n - 1)])
    pl = [tc.build_neighbor_planes(col_idx, t, degree=4)
          for t in (ops_a[2], tiles_b)]
    got = {
        "device": tc.disagreement_labels_device(
            torch.as_tensor(np.stack([ops_a[0], J_b])), t1, t2, group=group),
        "sparse": tc.disagreement_labels_sparse(
            np.stack([pad(src_a), pad(src_b)]),
            np.stack([pad(dst_a), pad(dst_b)]), t1, t2, group=group),
        "blocked": tc.disagreement_labels_blocked(
            col_idx, torch.as_tensor(np.stack([ops_a[2], tiles_b]) != 0),
            t1, t2, group=group),
        "matmul": tc.disagreement_labels_matmul(
            tc.NeighborPlanes(col_idx, np.stack([p.index for p in pl]), n,
                              B), t1, t2, group=group)}
    half = s1.shape[0] // 2
    for J, sl in ((ops_a[0], slice(0, half)), (J_b, slice(half, None))):
        want = tc.disagreement_labels_device(torch.as_tensor(J), t1[sl],
                                             t2[sl])
        for k, v in got.items():
            np.testing.assert_array_equal(v[sl].numpy(), want.numpy(),
                                          err_msg=k)


@pytest.mark.parametrize("backend", ["device", "sparse", "blocked",
                                     "matmul"])
def test_moves_equal_jax(backend):
    """Each backend's move from JAX's cluster uniforms uniform(key, (n,)):
    the same s1, s2, moved and flipped; the all-disagree pair flips s1
    (Katzgraber), the all-agree pair stays."""
    ops, active = operands("ea2d_colored")
    J, col_idx, J_tiles, planes, src, dst = ops
    s1, s2 = pairs(active, seed=2)
    keys = [jax.random.PRNGKey(10 + p) for p in range(s1.shape[0])]
    g = torch.as_tensor(np.stack([np.asarray(jax.random.uniform(k, (
        active.size,))) for k in keys]))
    t1, t2 = torch.as_tensor(s1), torch.as_tensor(s2)
    for katz in (True, False):
        want = []
        for a, b, k in zip(s1, s2, keys):
            fn = {"device": lambda: jc.houdayer_move_device(
                      jnp.asarray(J), a, b, k, use_katzgraber=katz),
                  "sparse": lambda: jc.houdayer_move_sparse(
                      src, dst, a, b, k, use_katzgraber=katz),
                  "blocked": lambda: jc.houdayer_move_blocked(
                      col_idx, J_tiles != 0, a, b, k, use_katzgraber=katz),
                  "matmul": lambda: jc.houdayer_move_matmul(
                      planes, a, b, k, use_katzgraber=katz)}[backend]
            want.append([np.asarray(x) for x in fn()])
        kw = dict(g=g, use_katzgraber=katz)
        got = {"device": lambda: tc.houdayer_move_device(
                   torch.as_tensor(J), t1, t2, **kw),
               "sparse": lambda: tc.houdayer_move_sparse(
                   src, dst, t1, t2, **kw),
               "blocked": lambda: tc.houdayer_move_blocked(
                   col_idx, torch.as_tensor(J_tiles != 0), t1, t2, **kw),
               "matmul": lambda: tc.houdayer_move_matmul(
                   tc.build_neighbor_planes(col_idx, J_tiles), t1, t2,
                   **kw)}[backend]()
        for j, name in enumerate(("s1", "s2", "moved", "flipped")):
            np.testing.assert_array_equal(
                got[j].numpy(), np.stack([w[j] for w in want]),
                err_msg=f"{name} katzgraber={katz}")
        assert not got[2][3] and not got[3][3]        # all agree: no move
        assert bool(got[3][4]) == katz                # all disagree
        assert got[2].any()


def test_houdayer_from_labels_and_generator():
    """`_houdayer_from_labels` with JAX's uniforms equals JAX's, with a
    Katzgraber threshold; the generator path draws [P, n] and needs a
    generator or g."""
    ops, active = operands("chimera_colored")
    s1, s2 = pairs(active, seed=5)
    labels = port_labels("sparse", ops, s1, s2, None)
    n = active.size
    for p in range(s1.shape[0]):
        key = jax.random.PRNGKey(p)
        want = jc._houdayer_from_labels(
            jnp.asarray(labels[p].numpy()), s1[p], s2[p], key,
            use_katzgraber=True, katzgraber_threshold=10)
        g = torch.as_tensor(np.array(jax.random.uniform(key, (n,))))
        got = tc._houdayer_from_labels(
            labels[p:p + 1], torch.as_tensor(s1[p:p + 1]),
            torch.as_tensor(s2[p:p + 1]), g[None], use_katzgraber=True,
            katzgraber_threshold=10)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x.numpy()[0], np.asarray(y))
    t1, t2 = torch.as_tensor(s1), torch.as_tensor(s2)
    a = tc.houdayer_move_sparse(ops[4], ops[5], t1, t2,
                                torch.Generator().manual_seed(1))
    b = tc.houdayer_move_sparse(ops[4], ops[5], t1, t2,
                                torch.Generator().manual_seed(1))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="Generator"):
        tc.houdayer_move_sparse(ops[4], ops[5], t1, t2)
    with pytest.raises(ValueError, match="g must be"):
        tc.houdayer_move_sparse(ops[4], ops[5], t1, t2, g=torch.zeros(2, n))


def test_neighbor_planes_equal_jax_and_degree_cap():
    """The index table's one-hot operands equal JAX's gather and planes
    (also with a forced degree); a complete graph exceeds the cap."""
    ops, _ = operands("chimera_colored")
    col_idx, J_tiles = ops[1], ops[2]
    for degree in (None, 9):
        want = jc.build_neighbor_planes(col_idx, J_tiles, degree=degree)
        got = tc.build_neighbor_planes(col_idx, J_tiles, degree=degree)
        assert got.degree == want.degree
        np.testing.assert_array_equal(got.gather, np.asarray(want.gather))
        np.testing.assert_array_equal(
            got.planes, np.asarray(want.planes).astype(np.float32))
    with pytest.raises(ValueError, match="degree"):
        tc.build_neighbor_planes(col_idx, J_tiles, degree=2)
    b = block_problem(random_sk(24, seed=1), block_size=8)
    ci, jt = block_sparse_tiles(b)
    with pytest.raises(ValueError, match="degree"):
        tc.build_neighbor_planes(ci, jt)
    big = tc.NeighborPlanes(np.zeros((1, 1), np.int32),
                            np.zeros((1, 1, 65537), np.int64), 65537 * 2,
                            65537)
    s = torch.ones((1, 65537 * 2))
    with pytest.raises(ValueError, match="65536"):
        tc.disagreement_labels_matmul(big, s, s)
