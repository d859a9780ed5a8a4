"""The campaign engine's in-round LBP and backbone masks against nmc_tpu.

`convexified_marginal_dense`, `_sparse` (ops/lbp_jit.py) and `_planes`
(ops/lbp_planes.py) take a batch of C chains in the port; the JAX package
vmaps its per-chain bodies. Fed the same f64 inputs, every chain's belief
logits agree with JAX's to 1e-10 (only summation orders differ). The
ladder below (lambda 0.5 -> 0.01 by 0.9, tolerance 1e-10, 40 iterations,
beta 2.5) makes every chain converge at the first rung and some fail at a
later one while others still converge, so the divergence policy and the
per-chain freezing are exercised. JAX runs its bodies under jit(vmap(.)),
as its engines do. The host functions that build the slot layout are
array-equal to JAX's, and `backbone_mask_device` is equal at the default
thresholds and at a non-default cutoff.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmc_tpu.core.problem import IsingProblem, block_problem
from nmc_tpu.io.generators import chimera_graph, ea_2d, random_sk
from nmc_tpu.ops import clusters as jcl
from nmc_tpu.ops import lbp_jit as jj
from nmc_tpu.ops import lbp_planes as jp
from nmc_tpu.ops.coloring import color_groups
from nmc_tpu.ops.lbp import lambda_ladder
from nmc_tpu.ops.lbp_sparse import EdgeGraph as JEdgeGraph
from nmc_tpu.parallel.ensemble_nmc import _union_tiles as j_union_tiles
from nmc_tpu_torch.ops import clusters as tcl
from nmc_tpu_torch.ops import lbp_jit as tj
from nmc_tpu_torch.ops import lbp_planes as tp
from nmc_tpu_torch.ops.lbp_sparse import EdgeGraph as TEdgeGraph
from nmc_tpu_torch.parallel.ensemble_nmc import _union_tiles

from torch_parity import t64

LADDER = tuple(lambda_ladder(0.5, 0.01, 0.9))
KW = dict(beta=2.5, ladder=LADDER, max_iterations=40, tolerance=1e-10)
C = 8


def _family(drop=False):
    """Two chimera 2x2 instances (block 8, union colouring); with `drop`
    the second lacks two couplings of the union."""
    probs = [chimera_graph(2, 2, seed=s).normalized()[0] for s in (3, 4)]
    if drop:
        J = probs[1].J.copy()
        for a, b in ((0, 4), (9, 13)):
            assert J[a, b] != 0
            J[a, b] = J[b, a] = 0.0
        probs[1] = IsingProblem(J, probs[1].h)
    groups = color_groups(sum(np.abs(p.J) for p in probs))
    return [block_problem(p, block_size=8, groups=groups, dtype=np.float64)
            for p in probs]


def _chains():
    """C chains on the first instance: h with noise, epsilon, clamps."""
    b = _family()[0]
    n = b.n_pad
    rng = np.random.default_rng(0)
    h = np.where(b.active, b.h + 0.2 * rng.normal(size=n), 0.0)
    J = b.J_rows.reshape(n, n)
    eps = np.abs(h) + np.abs(J).sum(1)
    m_stars = np.where(rng.random((C, n)) < 0.5, -1.0, 1.0)
    return b, J, h, eps, m_stars


def _record_convergence(monkeypatch, module):
    """Wrap `module.iterate_per_chain` to record each rung's flags."""
    seen = []
    inner = tj.iterate_per_chain

    def recording(step, carry, max_iterations):
        carry, conv = inner(step, carry, max_iterations)
        seen.append(conv.clone())
        return carry, conv

    monkeypatch.setattr(module, "iterate_per_chain", recording)
    return seen


def _assert_divergence_exercised(seen):
    conv = torch.stack(seen).numpy()                  # [rungs, C]
    assert len(conv) == len(LADDER)
    assert conv[0].all()
    assert (~conv[1:]).any(), "some chain must fail a rung after the first"
    assert conv[1:].any(), "some chain must converge after the first rung"


def _jax_chains(body, m_stars):
    """JAX's per-chain body over the chains, as its engines run it."""
    return np.asarray(jax.jit(jax.vmap(body))(jnp.asarray(m_stars)))


@pytest.mark.parametrize("variant", ["dense", "sparse", "planes"])
def test_matches_jax_per_chain(variant, monkeypatch):
    """Batched port logits against JAX's per-chain bodies, f64, 1e-10."""
    b, J, h, eps, m_stars = _chains()
    n = b.n_pad
    if variant == "dense":
        seen = _record_convergence(monkeypatch, tj)
        got = tj.convexified_marginal_dense(
            t64(J), t64(h).expand(C, n), t64(eps).expand(C, n), t64(m_stars),
            **KW)
        want = _jax_chains(lambda m: jj.convexified_marginal_dense(
            jnp.asarray(J), jnp.asarray(h), jnp.asarray(eps), m, **KW),
            m_stars)
    elif variant == "sparse":
        seen = _record_convergence(monkeypatch, tj)
        tg, jg = TEdgeGraph.from_dense(J), JEdgeGraph.from_dense(J)
        got = tj.convexified_marginal_sparse(
            tg, t64(tg.weight), t64(h).expand(C, n), t64(eps).expand(C, n),
            t64(m_stars), **KW)
        want = _jax_chains(lambda m: jj.convexified_marginal_sparse(
            jg, jnp.asarray(jg.weight), jnp.asarray(h), jnp.asarray(eps), m,
            **KW), m_stars)
    else:
        seen = _record_convergence(monkeypatch, tp)
        col_idx, J_tiles = j_union_tiles([b])
        adj = np.any(J_tiles != 0, axis=0)
        esp_t = tp.build_edge_slot_planes(col_idx, adj)
        esp_j = jp.build_edge_slot_planes(col_idx, adj)
        w = tp.w_slot_from_tiles(esp_t, J_tiles[0])
        got = tp.convexified_marginal_planes(
            esp_t, t64(w), t64(h).expand(C, n), t64(eps).expand(C, n),
            t64(m_stars), **KW)
        want = _jax_chains(lambda m: jp.convexified_marginal_planes(
            esp_j, jnp.asarray(w), jnp.asarray(h), jnp.asarray(eps), m,
            **KW), m_stars)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)
    _assert_divergence_exercised(seen)


@pytest.mark.parametrize("variant", ["dense", "sparse", "planes"])
def test_batched_rows_equal_single_chain_calls(variant):
    """Each row of a batched solve is what the chain alone gives: a chain
    that converged keeps its messages while the others iterate on."""
    b, J, h, eps, m_stars = _chains()
    n = b.n_pad
    args = (t64(h).expand(C, n), t64(eps).expand(C, n), t64(m_stars))
    if variant == "dense":
        def run(hh, ee, mm):
            return tj.convexified_marginal_dense(t64(J), hh, ee, mm, **KW)
    elif variant == "sparse":
        g = TEdgeGraph.from_dense(J)

        def run(hh, ee, mm):
            return tj.convexified_marginal_sparse(g, t64(g.weight), hh, ee,
                                                  mm, **KW)
    else:
        col_idx, J_tiles = _union_tiles([b])
        esp = tp.build_edge_slot_planes(col_idx, np.any(J_tiles != 0, 0))
        w = t64(tp.w_slot_from_tiles(esp, J_tiles[0]))

        def run(hh, ee, mm):
            return tp.convexified_marginal_planes(esp, w, hh, ee, mm, **KW)
    batched = run(*args)
    for c in range(C):
        alone = run(*(a[c:c + 1] for a in args))
        np.testing.assert_allclose(batched[c:c + 1].numpy(), alone.numpy(),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("drop", [False, True])
def test_slot_planes_construction_equals_jax(drop):
    """build_edge_slot_planes and w_slot_from_tiles array-equal to JAX's on
    a union layout (with `drop`, one instance lacks two union couplings, so
    its tiles carry zeros where the union has edges); the port's index
    tables select what JAX's one-hot planes select."""
    blocked = _family(drop)
    col_idx, J_tiles = _union_tiles(blocked)
    jc, jt = j_union_tiles(blocked)
    np.testing.assert_array_equal(col_idx, jc)
    np.testing.assert_array_equal(J_tiles, jt)
    adj = np.any(J_tiles != 0, axis=0)
    et, ej = tp.build_edge_slot_planes(col_idx, adj), \
        jp.build_edge_slot_planes(col_idx, adj)
    for f in ("gather", "rev", "slot_col"):
        np.testing.assert_array_equal(getattr(et, f), getattr(ej, f),
                                      err_msg=f)
    np.testing.assert_array_equal(et.planes, np.asarray(ej.planes, np.float32))
    assert (et.n_pad, et.block_size, et.degree) == \
        (ej.n_pad, ej.block_size, ej.degree)
    for i in range(len(blocked)):
        np.testing.assert_array_equal(tp.w_slot_from_tiles(et, J_tiles[i]),
                                      jp.w_slot_from_tiles(ej, J_tiles[i]))
    # rev[v, d, rev_slot[v, d]] == 1 on real slots; nbr from the planes
    real = et.nbr >= 0
    v, d = np.nonzero(real)
    assert (et.rev[v, d, et.rev_slot[v, d]] == 1).all()
    assert (et.rev.sum(-1)[~real] == 0).all()
    if drop:
        w1 = tp.w_slot_from_tiles(et, J_tiles[1])
        assert (w1[real] == 0).sum() == 4    # two couplings, both directions


def test_slot_planes_refuse_past_the_degree_cap():
    prob = random_sk(40, seed=1)
    b = block_problem(prob, block_size=8, groups=color_groups(prob.J))
    col_idx, J_tiles = _union_tiles([b])
    for build in (tp.build_edge_slot_planes, jp.build_edge_slot_planes):
        with pytest.raises(ValueError, match="degree"):
            build(col_idx, np.any(J_tiles != 0, axis=0))


@pytest.mark.parametrize("logits", [False, True])
def test_backbone_mask_at_default_thresholds(logits):
    """Pure thresholding (the growth ladder is empty at the defaults);
    batched over [I, k, n] with per-instance |J| and the activity mask."""
    rng = np.random.default_rng(3)
    I, k, n = 2, 3, 36
    J_abs = np.stack([np.abs(ea_2d(6, seed=s).J) for s in range(I)])
    x = rng.uniform(-1, 1, (I, k, n))
    x[..., :6] = [0.999999, -0.9999991, 0.99999, 1.0, -1.0, 0.5]
    if logits:
        x = np.arctanh(np.clip(x, -1 + 1e-12, 1 - 1e-12)) * 1.0001
    act = rng.random(n) < 0.9
    got = tcl.backbone_mask_device(t64(x), t64(J_abs), 0.999999, 0.99999,
                                   active=torch.as_tensor(act), logits=logits)
    for i in range(I):
        want = jcl.backbone_mask_device(
            jnp.asarray(x[i]), jnp.asarray(J_abs[i]), 0.999999, 0.99999,
            active=jnp.asarray(act), logits=logits)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def test_backbone_mask_at_nondefault_cutoff():
    """Several growth rungs fire (one masked propagation each): equal to
    JAX's per instance, and to the host find_clusters flat set."""
    rng = np.random.default_rng(5)
    I, n = 3, 64
    probs = [ea_2d(8, seed=11 + s) for s in range(I)]
    J_abs = np.stack([np.abs(p.J) for p in probs])
    mag = rng.uniform(0.5, 1.0, (I, 2, n)) * rng.choice([-1, 1], (I, 2, n))
    init, cutoff, step = 0.95, 0.60, 0.05
    got = tcl.backbone_mask_device(t64(mag), t64(J_abs), init, cutoff, step)
    for i in range(I):
        want = jcl.backbone_mask_device(jnp.asarray(mag[i]),
                                        jnp.asarray(J_abs[i]), init, cutoff,
                                        step)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
        for c in range(2):
            host = tcl.find_clusters(probs[i].J, mag[i, c], init, cutoff,
                                     step)
            flat = np.zeros(n, bool)
            flat[tcl.flatten_clusters(host)] = True
            np.testing.assert_array_equal(got[i, c].numpy(), flat)
    assert got.sum() > (np.abs(mag) >= init).sum()     # growth happened
