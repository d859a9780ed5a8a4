"""K1, the colored sweep kernel: its plain twins and its wrapper, on the CPU.

The CUDA kernel (an entry point of the neighbour-list body in
csrc/colored_sweeps_nbr.cu, P replicas per CTA) runs only on a card;
chip_smoke.py holds it against `colored_sweeps_reference` and, bit for bit,
against `neighbor_sweeps_reference` there. Here the dense reference is held
against the JAX package's Pallas kernel (interpret mode) and XLA Jacobi
sweeps; the plain sweeps over the neighbour layout (beta_row = 1) against
the dense reference (bit for bit on +-J chimera 8x8 and ea_2d L = 32,
within 1e-5 on Gaussian couplings); the engine on a K1 layout against the
Pallas kernel with the scalar beta_spin and one-row mask it now passes;
the launch rule `k1_launch`; the wrapper's argument forms, CPU routing and
ctypes binding.
"""

import ctypes
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmc_tpu.core.problem import block_problem
from nmc_tpu.io.generators import chimera_graph, ea_2d
from nmc_tpu.ops.coloring import color_groups
from nmc_tpu.ops.sweeps import run_sweeps as j_run_sweeps
from nmc_tpu.ops.sweeps_pallas import pallas_colored_sweeps
from nmc_tpu_torch import interop
from nmc_tpu_torch.ops import engine as t_engine
from nmc_tpu_torch.ops import sweeps_cuda
from nmc_tpu_torch.ops.engine import SweepEngine
from nmc_tpu_torch.ops.sweeps_cuda import (colored_sweeps,
                                           colored_sweeps_reference)

from torch_parity import jax_sweep_uniforms, t64


def _colored(prob, R, seed, dtype, block_size=8):
    b = block_problem(prob, block_size=block_size,
                      groups=color_groups(prob.J), dtype=dtype)
    assert b.colored
    rng = np.random.default_rng(seed)
    m0 = np.where(rng.random((R, b.n_pad)) < 0.5, -1.0, 1.0).astype(dtype)
    m0[:, ~b.active] = 1.0
    J = b.J_rows.reshape(b.n_pad, b.n_pad)
    phi0 = (m0 @ J + b.h).astype(dtype)
    return b, J, m0, phi0, rng


def test_interpret_pallas_prng_is_zero():
    """The premise of the next test: the Pallas interpreter's PRNG returns
    zeros, so every draw is u = 0 (tests/test_pallas.py relies on it too).
    With beta = 0, p_up = 1/2 > 0 everywhere and every free spin turns +1."""
    prob = ea_2d(4, seed=1)
    b, J, m0, phi0, _ = _colored(prob, 3, 0, np.float32)
    mask = np.broadcast_to(b.active, m0.shape)
    res = pallas_colored_sweeps(
        jnp.asarray(J), jnp.asarray(b.h), m0, phi0, 7,
        np.zeros(2, np.float32), np.ones_like(m0), mask, num_sweeps=2,
        block_size=8, interpret=True)
    np.testing.assert_array_equal(np.asarray(res.m), np.ones_like(m0))


@pytest.mark.parametrize("prob_name", ["ea2d_4", "chimera_2x2"])
def test_reference_matches_pallas_interpret_zero_uniforms(prob_name):
    """(a) K1 in interpret mode (u = 0) against the plain twin fed zeros,
    f32. Large beta makes tanh saturate to -1 for negative fields, so the
    u = 0 dynamics are a nontrivial greedy descent."""
    prob = {"ea2d_4": ea_2d(4, seed=1),
            "chimera_2x2": chimera_graph(2, 2, seed=3)}[prob_name]
    R, T = 4, 6
    b, J, m0, phi0, rng = _colored(prob, R, 2, np.float32)
    beta = np.array([20.0, 0.5, 20.0, 30.0, 1.0, 20.0], np.float32)
    bs = np.where(rng.random(m0.shape) < 0.3, 0.05, 1.0).astype(np.float32)
    mask = (rng.random(m0.shape) < 0.8) & b.active
    jr = pallas_colored_sweeps(
        jnp.asarray(J), jnp.asarray(b.h), m0, phi0, 3, beta, bs, mask,
        num_sweeps=T, block_size=8, interpret=True)
    tr = colored_sweeps_reference(
        torch.as_tensor(J), torch.as_tensor(b.h), torch.as_tensor(m0),
        torch.as_tensor(phi0), None, torch.as_tensor(beta),
        torch.as_tensor(bs), torch.as_tensor(mask), num_sweeps=T,
        block_size=8, uniforms=torch.zeros((T, R, b.n_pad)))
    np.testing.assert_array_equal(tr.m.numpy(), np.asarray(jr.m))
    np.testing.assert_array_equal(tr.m_best.numpy(), np.asarray(jr.m_best))
    np.testing.assert_allclose(tr.phi.numpy(), np.asarray(jr.phi), atol=1e-5)
    np.testing.assert_allclose(tr.energies.numpy(), np.asarray(jr.energies),
                               atol=1e-5)
    np.testing.assert_allclose(tr.e_best.numpy(), np.asarray(jr.e_best),
                               atol=1e-5)
    assert (tr.m.numpy() == -1.0).any() and (tr.m.numpy() != m0).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_matches_jax_jacobi_sweeps(seed):
    """(b) The plain twin against the JAX XLA Jacobi sweeps with JAX's own
    uniforms injected, f64, with a frozen mask and heated spins."""
    prob = chimera_graph(2, 3, seed=seed, pm=False)
    R, T = 6, 12
    b, J, m0, phi0, rng = _colored(prob, R, seed, np.float64)
    beta = np.full(T, 1.3)
    heated = rng.random(m0.shape) < 0.4
    bs = np.where(heated, 1.0 / 20.0, 1.0)
    mask = heated & b.active          # an NMC C phase: the rest is frozen
    key = jax.random.PRNGKey(seed + 5)
    jr = j_run_sweeps(jnp.asarray(b.J_rows), jnp.asarray(b.J_diag),
                      jnp.asarray(b.h), jnp.asarray(m0), jnp.asarray(phi0),
                      key, jnp.asarray(beta), jnp.asarray(bs),
                      jnp.asarray(mask), num_sweeps=T, within_block="jacobi")
    u = torch.as_tensor(jax_sweep_uniforms(key, T, R, b.n_pad))
    before = colored_sweeps.launches
    tr = colored_sweeps(t64(J), t64(b.h), t64(m0), t64(phi0), None, t64(beta),
                        t64(bs), torch.as_tensor(mask), num_sweeps=T,
                        block_size=8, uniforms=u)
    assert colored_sweeps.launches == before
    np.testing.assert_array_equal(tr.m.numpy(), np.asarray(jr.m))
    np.testing.assert_array_equal(tr.m_best.numpy(), np.asarray(jr.m_best))
    np.testing.assert_allclose(tr.phi.numpy(), np.asarray(jr.phi), atol=1e-10)
    np.testing.assert_allclose(tr.energies.numpy(), np.asarray(jr.energies),
                               atol=1e-10)
    np.testing.assert_array_equal(tr.m.numpy()[~mask], m0[~mask])
    assert (tr.m.numpy()[mask] != m0[mask]).any()


def test_wrapper_on_cpu_runs_plain_version_uncounted():
    """(c) On CPU tensors the wrapper is the plain version (same generator
    stream, same result) and launches nothing."""
    prob = ea_2d(4, seed=2)
    b, J, m0, phi0, _ = _colored(prob, 4, 3, np.float32)
    args = (torch.as_tensor(J), torch.as_tensor(b.h), torch.as_tensor(m0),
            torch.as_tensor(phi0))
    rest = (torch.full((5,), 0.9), torch.ones(()),
            torch.as_tensor(b.active).expand(4, b.n_pad))
    before = colored_sweeps.launches
    a = colored_sweeps(*args, torch.Generator().manual_seed(3), *rest,
                       num_sweeps=5, block_size=8)
    r = colored_sweeps_reference(*args, torch.Generator().manual_seed(3),
                                 *rest, num_sweeps=5, block_size=8)
    assert colored_sweeps.launches == before
    for x, y in zip(a, r):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    with pytest.raises(ValueError):
        colored_sweeps(*(t.to("meta") for t in args), None,
                       *(t.to("meta") for t in rest), num_sweeps=5,
                       block_size=8)
    with pytest.raises(ValueError):
        colored_sweeps(*args, None, *rest, num_sweeps=5, block_size=8)


def test_broadcast_arguments_are_materialised():
    """What a kernel reads as [R, n_pad] (a heated beta_spin, a per-chain
    mask) is handed to it contiguous, whatever view it came as."""
    bs = sweeps_cuda._broadcast("beta_spin", torch.ones(()), (3, 8),
                                torch.float32, torch.device("cpu"))
    assert bs.shape == (3, 8) and bs.is_contiguous() and bs.stride() == (8, 1)
    mask = torch.tensor([True, False] * 4).expand(3, 8)
    assert mask.stride() == (0, 1)
    out = sweeps_cuda._broadcast("update_mask", mask, (3, 8), torch.bool,
                                 torch.device("cpu"))
    assert out.is_contiguous() and torch.equal(out, mask)
    with pytest.raises(TypeError):
        sweeps_cuda._broadcast("beta_spin", torch.ones((), dtype=torch.float64),
                               (3, 8), torch.float32, torch.device("cpu"))
    with pytest.raises(ValueError):
        sweeps_cuda._check("J", torch.ones(4, 4).t()[:, :2], (4, 2),
                           torch.float32, torch.device("cpu"))


def test_ctypes_binding_matches_kernel_signature():
    """Every parameter of the C entry point gets a ctypes type, pointers as
    c_void_p (a c_int would cut a 64-bit pointer)."""
    src = (Path(sweeps_cuda.__file__).resolve().parent.parent / "csrc"
           / "colored_sweeps_nbr.cu").read_text()
    sig = re.search(r"int colored_sweeps_f32\((.*?)\)\s*\{", src, re.S).group(1)
    params = [p.strip() for p in sig.split(",")]
    fake = types.SimpleNamespace(colored_sweeps_f32=types.SimpleNamespace())
    argtypes = sweeps_cuda._bind(fake).colored_sweeps_f32.argtypes
    assert len(argtypes) == len(params)
    for p, t in zip(params, argtypes):
        expected = (ctypes.c_void_p if "*" in p else
                    ctypes.c_uint if p.startswith("unsigned") else
                    ctypes.c_int)
        assert t is expected, p


@pytest.mark.parametrize("n_pad", [32, 640, 1024, 1536])
def test_k1_launch_rule(n_pad):
    """k1_launch is a pure function of (R, n_pad, SMs): P replicas per CTA
    in K1_REPLICAS_PER_CTA whose shared memory (6 P n_pad bytes) fits a
    CTA, the fewest that need at most one CTA per SM, and a width in
    K1_WIDTHS of at least 32 P (warp p sums replica p's energy); K2/K3's
    width rule is not touched by it."""
    sc = sweeps_cuda
    for sms in (132, 114, 16):
        for R in list(range(1, 600, 13)) + [2048, 2049, 4096]:
            P, width = sc.k1_launch(R, n_pad, sms)
            assert (P, width) == sc.k1_launch(R, n_pad, sms)
            assert P in sc.K1_REPLICAS_PER_CTA and width in sc.K1_WIDTHS
            assert width >= 32 * P
            assert sc._shared_bytes_nbr(n_pad, P) <= sc.MAX_SHARED_BYTES
            # the fewest replicas per CTA that need at most one CTA per SM,
            # else the most that fit
            if -(-R // P) <= sms:
                assert P == 1 or -(-R // (P // 2)) > sms
            else:
                nxt = 2 * P
                assert nxt > 8 or sc._shared_bytes_nbr(n_pad, nxt) \
                    > sc.MAX_SHARED_BYTES
    assert sc._shared_bytes_nbr(n_pad, 8) == 48 * n_pad
    # the main path's R = 256 and the throughput shape's R = 2048 on an
    # H100's 132 SMs
    want = {4: 1, 132: 1, 133: 2, 256: 2, 264: 2, 265: 4, 528: 4, 529: 8,
            2048: 8}
    for R, P in want.items():
        assert sc.k1_launch(R, n_pad, 132) == (P, 512), R
    assert [sc.sweep_threads(R, 132) for R in (2, 264, 265, 528, 529, 2048)] \
        == [1024, 1024, 512, 512, 256, 256]


def _k1_layout(name, pm=True):
    """(JAX problem, block size) of a K1 layout at the main path's widths:
    chimera 8x8 (n_pad 640, 3 colour classes) or ea_2d L = 32 (n_pad 1024,
    2 classes)."""
    return {"chimera_8x8": (chimera_graph(8, 8, seed=0, pm=pm), 128),
            "ea2d_32": (ea_2d(32, seed=1, pm=pm), 128)}[name]


def _k1_cases(b, R, T, rng):
    """(beta, beta_spin, mask) of the chip's two K1 cases: every active spin
    at beta 1 (a scalar beta_spin, the active row as the mask), and an NMC
    C phase with a heated backbone and a per-chain mask."""
    cl = (rng.random((R, b.n_pad)) < 0.5) & b.active
    return {"all": (torch.ones(T), torch.ones(()),
                    torch.as_tensor(b.active)[None]),
            "heated_masked": (torch.full((T,), 2.5),
                              torch.as_tensor(np.where(cl, 1 / 20, 1.0),
                                              dtype=torch.float32),
                              torch.as_tensor(cl))}


@pytest.mark.parametrize("case", ["all", "heated_masked"])
@pytest.mark.parametrize("name,pm", [("chimera_8x8", True),
                                     ("ea2d_32", True),
                                     ("chimera_8x8", False)])
def test_neighbor_reference_is_k1s_function(name, pm, case):
    """The plain sweeps over K1's neighbour layout with beta_row = 1 (the
    kernel's steps and FMA chain) against the dense block-by-block
    reference (the TPU kernel's function) from the same uniforms, f32: bit
    for bit on +-J couplings (phi integer-valued); on Gaussian couplings m
    and m_best exact, phi to 1e-5 and the energies (sums of 640 terms,
    about -700 here) to a relative 1e-6, some 8 f32 ulps, as the dense row
    sums and the energy sum round in another order."""
    prob, B = _k1_layout(name, pm)
    R, T = 4, 6
    b, J, m0, phi0, rng = _colored(prob, R, 3, np.float32, block_size=B)
    nbrs = sweeps_cuda.sweep_neighbors_from_dense(torch.as_tensor(b.J_rows))
    assert sweeps_cuda.steps_are_independent(nbrs)
    beta, bs, mask = _k1_cases(b, R, T, rng)[case]
    u = torch.as_tensor(rng.random((T, R, b.n_pad)), dtype=torch.float32)
    args = (torch.as_tensor(b.h), torch.as_tensor(m0), torch.as_tensor(phi0),
            None, beta)
    dense = colored_sweeps_reference(torch.as_tensor(J), *args, bs, mask,
                                     num_sweeps=T, block_size=B, uniforms=u)
    spin_bs = None if bs.ndim == 0 else bs
    nbr = sweeps_cuda.neighbor_sweeps_reference(
        nbrs, *args, torch.ones(R), mask, spin_bs, num_sweeps=T, uniforms=u)
    assert (dense.m != torch.as_tensor(m0)).any()
    if pm:
        for x, y in zip(nbr, dense):
            assert torch.equal(x, y)
    else:
        assert torch.equal(nbr.m, dense.m)
        assert torch.equal(nbr.m_best, dense.m_best)
        torch.testing.assert_close(nbr.phi, dense.phi, rtol=0, atol=1e-5)
        torch.testing.assert_close(nbr.energies, dense.energies, rtol=1e-6,
                                   atol=0)


def test_k1_arguments_take_the_body_forms():
    """K1's beta_spin as the body's (beta_row, beta_spin): a scalar, 0-d or
    [R, 1] factor becomes beta_row with no per-spin factor, anything else
    beta_row = 1 and [R, n_pad]; a mask that repeats one row (stride 0) is
    passed as one row. The plain sweeps over the layout in those forms
    equal the dense reference in K1's form bit for bit (+-J chimera)."""
    sc, cpu, R, n = sweeps_cuda, torch.device("cpu"), 3, 8
    row, spin = sc._k1_betas(torch.tensor(0.7), R, n, cpu)
    assert spin is None and torch.equal(row, torch.full((R,), 0.7))
    row, spin = sc._k1_betas(0.7, R, n, cpu)
    assert spin is None and torch.equal(row, torch.full((R,), 0.7))
    col = torch.tensor([[0.5], [1.0], [2.0]])
    row, spin = sc._k1_betas(col, R, n, cpu)
    assert spin is None and torch.equal(row, col[:, 0])
    per_spin = torch.linspace(0.1, 1.0, n)
    row, spin = sc._k1_betas(per_spin, R, n, cpu)
    assert torch.equal(row, torch.ones(R)) and spin.shape == (R, n)
    assert spin.is_contiguous() and torch.equal(spin, per_spin.expand(R, n))
    with pytest.raises(TypeError):
        sc._k1_betas(torch.ones((), dtype=torch.float64), R, n, cpu)
    active = torch.tensor([True, False] * 4)
    for view in (active.expand(R, n), active[None], active):
        mask, rows = sc._mask_rows(view, R, n, cpu)
        assert rows == 1 and mask.shape == (1, n) and torch.equal(mask[0],
                                                                  active)
    chain = torch.rand((R, n), generator=torch.Generator().manual_seed(0)) < .5
    mask, rows = sc._mask_rows(chain, R, n, cpu)
    assert rows == R and torch.equal(mask, chain)

    prob = chimera_graph(2, 2, seed=3)
    R, T = 5, 6
    b, J, m0, phi0, rng = _colored(prob, R, 4, np.float32)
    nbrs = sc.sweep_neighbors_from_dense(torch.as_tensor(b.J_rows))
    u = torch.as_tensor(rng.random((T, R, b.n_pad)), dtype=torch.float32)
    args = (torch.as_tensor(b.h), torch.as_tensor(m0), torch.as_tensor(phi0),
            None, torch.full((T,), 0.9))
    active = torch.as_tensor(b.active)
    for bs in (torch.tensor(1.3), torch.linspace(0.4, 2.0, R)[:, None]):
        dense = colored_sweeps_reference(
            torch.as_tensor(J), *args, bs, active.expand(R, b.n_pad),
            num_sweeps=T, block_size=8, uniforms=u)
        row, spin = sc._k1_betas(bs, R, b.n_pad, cpu)
        mask, _ = sc._mask_rows(active.expand(R, b.n_pad), R, b.n_pad, cpu)
        nbr = sc.neighbor_sweeps_reference(nbrs, *args, row, mask, spin,
                                           num_sweeps=T, uniforms=u)
        for x, y in zip(nbr, dense):
            assert torch.equal(x, y)


@pytest.mark.parametrize("prob_name", ["ea2d_4", "chimera_2x2"])
def test_engine_k1_matches_pallas_interpret_zero_uniforms(prob_name,
                                                          monkeypatch):
    """SweepEngine on a K1 layout (carried over from the JAX package) hands
    colored_sweeps its neighbour layout, a scalar beta_spin and the active
    row as a one-row mask; on the CPU that runs the dense reference, which
    matches K1 in interpret mode (u = 0), f32."""
    prob = {"ea2d_4": ea_2d(4, seed=1),
            "chimera_2x2": chimera_graph(2, 2, seed=3)}[prob_name]
    R, T = 4, 6
    b, J, m0, phi0, _ = _colored(prob, R, 2, np.float32)
    teng = SweepEngine.from_blocked_problem(
        interop.blocked_from_numpy(b),
        interop.problem_from_numpy(prob.J, prob.h), device="cpu")
    assert teng.sweep_kernel == "colored_sweeps"
    seen = []
    inner = t_engine.colored_sweeps

    def recording(*a, **k):
        seen.append((a, k))
        return inner(*a, **k)
    monkeypatch.setattr(t_engine, "colored_sweeps", recording)
    beta = np.array([20.0, 0.5, 20.0, 30.0, 1.0, 20.0], np.float32)
    before = colored_sweeps.launches
    tr = teng.run(torch.as_tensor(m0), None, T, torch.as_tensor(beta),
                  blocked_input=True, blocked_output=True,
                  uniforms=torch.zeros((T, R, b.n_pad)))
    assert colored_sweeps.launches == before
    (a, k), = seen
    assert a[6].ndim == 0 and tuple(a[7].shape) == (1, b.n_pad)
    assert k["nbrs"] is teng.sweep_nbrs
    jr = pallas_colored_sweeps(
        jnp.asarray(J), jnp.asarray(b.h), m0, phi0, 3, beta,
        np.ones_like(m0), np.broadcast_to(b.active, m0.shape), num_sweeps=T,
        block_size=8, interpret=True)
    np.testing.assert_array_equal(tr.m.numpy(), np.asarray(jr.m))
    np.testing.assert_array_equal(tr.m_best.numpy(), np.asarray(jr.m_best))
    np.testing.assert_allclose(tr.phi.numpy(), np.asarray(jr.phi), atol=1e-5)
    np.testing.assert_allclose(tr.energies.numpy(), np.asarray(jr.energies),
                               atol=1e-5)
    assert (tr.m.numpy() != m0).any()


def test_k1_wrapper_on_cpu_ignores_the_launch_arguments():
    """On CPU tensors K1's wrapper runs the dense reference whatever `nbrs`,
    `threads` and `replicas_per_cta` say (values the card would refuse
    here), and counts no launch."""
    prob = ea_2d(4, seed=2)
    R, T = 3, 4
    b, J, m0, phi0, _ = _colored(prob, R, 5, np.float32)
    args = (torch.as_tensor(J), torch.as_tensor(b.h), torch.as_tensor(m0),
            torch.as_tensor(phi0))
    rest = (torch.full((T,), 0.9), torch.ones(()),
            torch.as_tensor(b.active)[None])
    before = colored_sweeps.launches
    a = colored_sweeps(*args, torch.Generator().manual_seed(3), *rest,
                       num_sweeps=T, block_size=8, nbrs="not a layout",
                       threads=96, replicas_per_cta=3)
    r = colored_sweeps_reference(*args, torch.Generator().manual_seed(3),
                                 *rest, num_sweeps=T, block_size=8)
    assert colored_sweeps.launches == before
    for x, y in zip(a, r):
        assert torch.equal(x, y)
