"""The whole-round kernels' plain twins (K4, K5) and their wrappers, on the CPU.

The CUDA kernels run only on a card, where chip_smoke.py holds them against
`ensemble_round_reference` and `ensemble_round_sparse_reference`. Here the
plain versions are held against the JAX package's Pallas kernels in
interpret mode, whose PRNG returns u = 0, so the plain versions are fed
zero uniforms (f32: m and m_best exact, e_best and e_carried to 1e-5). The
slot betas mix small values with large ones, which saturate tanh, so the
u = 0 dynamics are a nontrivial greedy descent; with the +-1 couplings
below |beta * phi| stays clear of [8, 9.6], where f32 tanh reaches exactly
1 in one implementation and not in another. The contracts of
tests/test_round_pallas.py (f64 re-evaluation, frozen padding, best <=
carried), K4 = K5 on one layout, the CPU routing and the ctypes signatures
are checked too.
"""

import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from nmc_tpu.core.problem import block_problem
from nmc_tpu.io.generators import chimera_graph, ea_2d
from nmc_tpu.ops.coloring import color_groups
from nmc_tpu.ops.round_pallas import (_phase_list, pallas_ensemble_round,
                                      pallas_ensemble_round_streamed)
from nmc_tpu.parallel.ensemble_nmc import _union_tiles
from nmc_tpu_torch.ops import round_cuda as rc
from nmc_tpu_torch.ops.round_cuda import (ensemble_round,
                                          ensemble_round_reference,
                                          ensemble_round_sparse,
                                          ensemble_round_sparse_reference)

CSRC = Path(rc.__file__).resolve().parent.parent / "csrc"
I, R = 2, 8
BETA = np.array([[0.5, 20, 1.0, 30, 0.7, 25, 1.2, 12],
                 [12, 1.2, 0.4, 15, 25, 0.9, 1.1, 40]], np.float32)
DO_NMC = np.array([[False] * 5 + [True] * 3, [True, False] * 4])


def _launches():
    return (ensemble_round.launches, ensemble_round_sparse.launches)


def _family(kind, seeds, dtype=np.float32):
    """Blocked instances of one topology (union colouring): ea_2d(6) in
    blocks of 16 (n_pad 64, dense K4 layout) or chimera 2x2 in blocks of 8
    (5 row blocks, K = 4, with padding tiles aliasing column block 0)."""
    if kind == "ea":
        probs = [ea_2d(6, seed=s).normalized()[0] for s in seeds]
        block = 16
    else:
        probs = [chimera_graph(2, 2, seed=s).normalized()[0] for s in seeds]
        block = 8
    groups = color_groups(sum(np.abs(p.J) for p in probs))
    blocked = [block_problem(p, block_size=block, groups=groups, dtype=dtype)
               for p in probs]
    assert blocked[0].colored
    return probs, blocked


def _inputs(blocked, seed, cl_frac=0.3):
    n = blocked[0].n_pad
    act = blocked[0].active
    rng = np.random.default_rng(seed)
    m0 = np.where(rng.random((len(blocked), R, n)) < 0.5, -1.0, 1.0)
    m0 = m0.astype(blocked[0].h.dtype)
    m0[..., ~act] = 1.0
    cl = (rng.random(m0.shape) < cl_frac) & act
    h = np.stack([b.h for b in blocked])
    return act, m0, cl, h


def _dense(blocked):
    n = blocked[0].n_pad
    return np.stack([b.J_rows.reshape(n, n) for b in blocked])


def _assert_same(tr, jr, m0):
    np.testing.assert_array_equal(tr.m.numpy(), np.asarray(jr.m))
    np.testing.assert_array_equal(tr.m_best.numpy(), np.asarray(jr.m_best))
    np.testing.assert_allclose(tr.e_best.numpy(), np.asarray(jr.e_best),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tr.e_carried.numpy(),
                               np.asarray(jr.e_carried), rtol=0, atol=1e-5)
    assert (tr.m.numpy() != m0).any() and (tr.m.numpy() == -1).any()


@pytest.mark.parametrize("fuf", [1, 2])
def test_k4_reference_matches_pallas_interpret(fuf):
    """K4 against `pallas_ensemble_round` (u = 0): a mix of NMC and plain
    slots, ~30% backbone, unequal betas, 2 cycles; with
    full_update_frequency 2 the second cycle has no ALL phase."""
    _, blocked = _family("ea", [0, 1])
    act, m0, cl, h = _inputs(blocked, 0)
    J = _dense(blocked)
    P = len(_phase_list(2, fuf))
    kw = dict(num_cycles=2, sweeps_per_phase=3, full_update_frequency=fuf)
    jr = pallas_ensemble_round(J, h, act.astype(np.float32), m0, cl, DO_NMC,
                               BETA, 7, block_size=16, interpret=True, **kw)
    tr = ensemble_round_reference(
        torch.as_tensor(J), torch.as_tensor(h), torch.as_tensor(act),
        torch.as_tensor(m0), torch.as_tensor(cl), torch.as_tensor(DO_NMC),
        torch.as_tensor(BETA), None, block_size=16,
        uniforms=torch.zeros((P, 3, I, R, J.shape[1])), **kw)
    _assert_same(tr, jr, m0)


def test_k5_reference_matches_pallas_interpret_with_aliasing_tiles():
    """K5 against `pallas_ensemble_round_streamed` (u = 0) on a union tile
    layout whose padding tiles alias column block 0 next to a real tile of
    that block."""
    _, blocked = _family("chimera", [3, 4])
    col_idx, J_tiles = _union_tiles(blocked)
    real = np.any(J_tiles != 0, axis=(0, 3, 4))
    assert any(col_idx[r, 0] == 0 and real[r, 0] and not real[r].all()
               for r in range(col_idx.shape[0]))
    act, m0, cl, h = _inputs(blocked, 1)
    kw = dict(num_cycles=2, sweeps_per_phase=3)
    jr = pallas_ensemble_round_streamed(col_idx, J_tiles, h,
                                        act.astype(np.float32), m0, cl,
                                        DO_NMC, BETA, 7, block_size=8,
                                        interpret=True, **kw)
    tr = ensemble_round_sparse_reference(
        torch.as_tensor(col_idx), torch.as_tensor(J_tiles),
        torch.as_tensor(h), torch.as_tensor(act), torch.as_tensor(m0),
        torch.as_tensor(cl), torch.as_tensor(DO_NMC), torch.as_tensor(BETA),
        None, uniforms=torch.zeros((6, 3, I, R, m0.shape[2])), **kw)
    _assert_same(tr, jr, m0)


@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_contracts_with_generator_draws(kernel):
    """With random draws, f64: the reported energies are those of the
    returned states (against the problem's own energy, 1e-9), padding never
    moves, and each slot's best is no worse than its carried state."""
    probs, blocked = _family("ea" if kernel == "K4" else "chimera", [5, 6],
                             np.float64)
    act, m0, cl, h = _inputs(blocked, 2, cl_frac=0.5)
    gen = torch.Generator().manual_seed(3)
    args = (torch.as_tensor(h), torch.as_tensor(act), torch.as_tensor(m0),
            torch.as_tensor(cl), torch.as_tensor(DO_NMC),
            torch.linspace(0.4, 3.0, R).expand(I, R), gen)
    kw = dict(num_cycles=2, sweeps_per_phase=5)
    before = _launches()
    if kernel == "K4":
        res = ensemble_round(torch.as_tensor(_dense(blocked)), *args,
                             block_size=blocked[0].block_size, **kw)
    else:
        col_idx, J_tiles = _union_tiles(blocked)
        res = ensemble_round_sparse(torch.as_tensor(col_idx),
                                    torch.as_tensor(J_tiles), *args, **kw)
    assert _launches() == before
    inv = blocked[0].inv_perm
    for i, p in enumerate(probs):
        np.testing.assert_allclose(
            res.e_carried[i].numpy(), p.energy(res.m[i].numpy()[:, inv]),
            rtol=0, atol=1e-9)
        np.testing.assert_allclose(
            res.e_best[i].numpy(), p.energy(res.m_best[i].numpy()[:, inv]),
            rtol=0, atol=1e-9)
    pad = ~blocked[0].active
    assert pad.any()
    np.testing.assert_array_equal(res.m.numpy()[..., pad], m0[..., pad])
    assert (res.e_best <= res.e_carried + 1e-12).all()
    assert (res.m.numpy() != m0).any()


def test_k4_equals_k5_on_one_layout_and_flips_are_counted():
    """On +-1 couplings phi is integer-valued, so K4 over dense J and K5
    over the same layout's tiles, driven by generators with one seed,
    agree exactly; both count the same flips per slot."""
    _, blocked = _family("ea", [2, 3])
    act, m0, cl, h = _inputs(blocked, 4)
    col_idx, J_tiles = _union_tiles(blocked)
    common = (torch.as_tensor(h), torch.as_tensor(act), torch.as_tensor(m0),
              torch.as_tensor(cl), torch.as_tensor(DO_NMC),
              torch.linspace(0.3, 2.0, R).expand(I, R))
    kw = dict(num_cycles=2, sweeps_per_phase=4, full_update_frequency=2)
    f4 = torch.zeros((I, R), dtype=torch.int32)
    f5 = torch.zeros((I, R), dtype=torch.int32)
    k4 = ensemble_round(torch.as_tensor(_dense(blocked)), *common,
                        torch.Generator().manual_seed(9), block_size=16,
                        flips=f4, **kw)
    k5 = ensemble_round_sparse(torch.as_tensor(col_idx),
                               torch.as_tensor(J_tiles), *common,
                               torch.Generator().manual_seed(9), flips=f5,
                               **kw)
    for x, y in zip(k4, k5):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert torch.equal(f4, f5) and f4.sum() > 0
    # the flips are the spins that changed, summed over the round's sweeps
    assert (f4.sum(1) >= (k4.m != torch.as_tensor(m0)).sum((1, 2))).all()


def test_heated_betas_pinned():
    """The kernels heat by 1 + f32(temp_x_inv - 1), computed in f32 as the
    Pallas kernels compute it; in f32 that is not f32(1 / temp_x), which
    the plain (XLA) round of the engine multiplies by instead."""
    for temp_x in (20.0, 7.0):
        want = np.float32(1.0) + np.float32(1.0 / temp_x - 1.0)
        assert rc.heated_factor(1.0 / temp_x) == float(want)
    assert rc.heated_factor(1.0 / 20.0) != float(np.float32(1.0 / 20.0))


@pytest.mark.parametrize("cycles,fuf", [(1, 1), (3, 1), (3, 2), (4, 3)])
def test_phase_list_equals_jax(cycles, fuf):
    assert rc.phase_list(cycles, fuf) == _phase_list(cycles, fuf)


def test_wrappers_on_cpu_run_plain_versions_and_check_inputs():
    _, blocked = _family("ea", [0, 1])
    act, m0, cl, h = _inputs(blocked, 5)
    J = torch.as_tensor(_dense(blocked))
    args = (torch.as_tensor(h), torch.as_tensor(act), torch.as_tensor(m0),
            torch.as_tensor(cl), torch.as_tensor(DO_NMC),
            torch.as_tensor(BETA))
    kw = dict(num_cycles=1, sweeps_per_phase=2, block_size=16)
    before = _launches()
    a = ensemble_round(J, *args, torch.Generator().manual_seed(1), **kw)
    b = ensemble_round_reference(J, *args, torch.Generator().manual_seed(1),
                                 **kw)
    assert _launches() == before
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    meta = tuple(x.to("meta") for x in args)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ensemble_round(J.to("meta"), *meta, None, **kw)
    with pytest.raises(ValueError, match="Generator"):
        ensemble_round(J, *args, None, **kw)
    with pytest.raises(ValueError, match="uniforms must be"):
        ensemble_round(J, *args, None, uniforms=torch.zeros((2, 2, I, R, 4)),
                       **kw)
    with pytest.raises(ValueError, match="sweeps_per_phase"):
        ensemble_round(J, *args, torch.Generator(), num_cycles=1,
                       sweeps_per_phase=0, block_size=16)


@pytest.mark.parametrize("fn", ["ensemble_round_f32",
                                "ensemble_round_sparse_f32"])
def test_ctypes_binding_matches_each_entry_point(fn):
    """Every parameter of each C entry point gets its ctypes type: pointers
    as c_void_p (a c_int would cut a 64-bit pointer), float as c_float."""
    src = (CSRC / "ensemble_round.cu").read_text()
    sig = re.search(rf"int {fn}\((.*?)\)\s*\{{", src, re.S).group(1)
    params = [p.strip() for p in sig.split(",")]
    fake = types.SimpleNamespace(**{fn: types.SimpleNamespace()})
    argtypes = getattr(rc._bind(fake, fn), fn).argtypes
    assert len(argtypes) == len(params)
    for p, t in zip(params, argtypes):
        expected = (ctypes.c_void_p if "*" in p else
                    ctypes.c_float if p.startswith("float") else ctypes.c_int)
        assert t is expected, p
