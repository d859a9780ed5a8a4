"""The port's copies of the host-side modules against nmc_tpu's originals:
problem layout, coloring, generators (wishart_planted included) and loaders
must be array-equal, and
interop must carry a JAX-package layout across unchanged."""

import numpy as np
import pytest
import torch

from nmc_tpu.core import problem as jp
from nmc_tpu.io import generators as jg
from nmc_tpu.io import loaders as jl
from nmc_tpu.ops import coloring as jc
from nmc_tpu_torch import interop
from nmc_tpu_torch.core import problem as tp
from nmc_tpu_torch.io import generators as tg
from nmc_tpu_torch.io import loaders as tl
from nmc_tpu_torch.ops import coloring as tc

BLOCKED_FIELDS = ("J_rows", "J_diag", "h", "active", "perm", "inv_perm")

INSTANCES = {
    "ea2d_4": lambda g: g.ea_2d(4, seed=1),
    "ea2d_4_gauss": lambda g: g.ea_2d(4, seed=2, pm=False, periodic=False),
    "chimera_2x2": lambda g: g.chimera_graph(2, 2, seed=3),
    "chimera_2x3_gauss": lambda g: g.chimera_graph(2, 3, seed=4, pm=False),
    "sk_12": lambda g: g.random_sk(12, seed=5, h_scale=0.5),
}


def _assert_blocked_equal(a, b):
    for f in BLOCKED_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.n, a.block_size, a.colored, a.n_pad) == \
        (b.n, b.block_size, b.colored, b.n_pad)


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_generators_bit_equal(name):
    a, b = INSTANCES[name](jg), INSTANCES[name](tg)
    np.testing.assert_array_equal(a.J, b.J)
    np.testing.assert_array_equal(a.h, b.h)
    assert a.name == b.name


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_coloring_and_layout_equal(name):
    prob_j = INSTANCES[name](jg)
    prob_t = INSTANCES[name](tg)
    gj, gt = jc.color_groups(prob_j.J), tc.color_groups(prob_t.J)
    assert len(gj) == len(gt)
    for a, b in zip(gj, gt):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jc.greedy_coloring(prob_j.J),
                                  tc.greedy_coloring(prob_t.J))
    for groups in (None, gj):
        for dtype in (np.float32, np.float64):
            bj = jp.block_problem(prob_j, block_size=8, groups=groups,
                                  dtype=dtype)
            bt = tp.block_problem(prob_t, block_size=8, groups=groups,
                                  dtype=dtype)
            _assert_blocked_equal(bj, bt)
    for a, b in zip(jp.block_sparse_tiles(bj), tp.block_sparse_tiles(bt)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,alpha,seed,planted", [
    (12, 0.5, 3, False), (40, 0.5, 1, False), (9, 0.25, 0, True)])
def test_wishart_planted_equal(n, alpha, seed, planted):
    t = (np.where(np.random.default_rng(seed).random(n) < 0.5, -1.0, 1.0)
         if planted else None)
    (pa, ta, ga), (pb, tb, gb) = (jg.wishart_planted(n, alpha, seed, t),
                                  tg.wishart_planted(n, alpha, seed, t))
    np.testing.assert_array_equal(pa.J, pb.J)
    np.testing.assert_array_equal(pa.h, pb.h)
    np.testing.assert_array_equal(ta, tb)
    assert ga == gb and pa.name == pb.name


def test_chimera512_layout():
    """The slice's instance: 3 colour classes of 192/192/128, n_pad = 640."""
    prob = tg.chimera_graph(8, 8, seed=0).normalized()[0]
    groups = tc.color_groups(prob.J)
    assert [len(g) for g in groups] == [192, 192, 128]
    b = tp.block_problem(prob, block_size=128, groups=groups)
    assert b.colored and b.n_pad == 640


def test_problem_methods_equal(rng):
    a = jg.random_sk(10, seed=7, h_scale=0.3)
    b = tg.random_sk(10, seed=7, h_scale=0.3)
    m = np.where(rng.random((5, 10)) < 0.5, -1.0, 1.0)
    np.testing.assert_array_equal(a.energy(m), b.energy(m))
    (na, fa), (nb, fb) = a.normalized(), b.normalized()
    np.testing.assert_array_equal(na.J, nb.J)
    assert fa == fb
    np.testing.assert_array_equal(a.symmetrized().J, b.symmetrized().J)
    assert (a.num_edges, a.min_abs_nonzero_J()) == \
        (b.num_edges, b.min_abs_nonzero_J())


@pytest.mark.parametrize("dialect", ["wishart", "dcl", "chimera", "tree"])
def test_loaders_equal(tmp_path, dialect):
    path = tmp_path / "inst.txt"
    lines = ["# comment", "1 2 0.5", "2 3 -1.25", "3 3 0.75", "1 4 2",
             "", "4 1 2"]
    path.write_text("\n".join(lines) + "\n")
    fn = {"wishart": "load_wishart", "dcl": "load_dcl",
          "chimera": "load_chimera", "tree": "load_contrived_tree"}[dialect]
    a = getattr(jl, fn)(str(path))
    b = getattr(tl, fn)(str(path))
    np.testing.assert_array_equal(a.J, b.J)
    np.testing.assert_array_equal(a.h, b.h)
    c = tl.load_edgelist(str(path), index_base=1, negate=False, n=6)
    d = jl.load_edgelist(str(path), index_base=1, negate=False, n=6)
    np.testing.assert_array_equal(c.J, d.J)


def test_interop_blocked_round_trip():
    prob = jg.chimera_graph(2, 2, seed=3)
    bj = jp.block_problem(prob, block_size=8, groups=jc.color_groups(prob.J))
    bt = interop.blocked_from_numpy(bj)
    assert isinstance(bt, tp.BlockedProblem)
    _assert_blocked_equal(bj, bt)
    fields = {f: getattr(bj, f) for f in BLOCKED_FIELDS}
    fields.update(n=bj.n, block_size=bj.block_size, colored=bj.colored)
    _assert_blocked_equal(bj, interop.blocked_from_numpy(fields))
    x = np.arange(prob.n, dtype=np.float64)
    np.testing.assert_array_equal(bt.from_blocked(bt.to_blocked(x)), x)
    np.testing.assert_array_equal(bt.to_blocked(x), bj.to_blocked(x))


def test_interop_problem_and_states():
    prob = jg.random_sk(6, seed=1, h_scale=1.0)
    p = interop.problem_from_numpy(prob.J, prob.h)
    np.testing.assert_array_equal(p.J, prob.J)
    np.testing.assert_array_equal(p.h, prob.h)
    np.testing.assert_array_equal(interop.problem_from_numpy(prob.J).h,
                                  np.zeros(6))
    m = np.array([[1.0, -1.0, 1.0]])
    t = interop.states_from_numpy(m, dtype="float64", device="cpu")
    assert t.dtype == torch.float64 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), m)
