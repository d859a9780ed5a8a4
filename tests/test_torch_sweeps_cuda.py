"""The colored sweep kernel's plain twin and its wrapper, on the CPU.

The CUDA kernel itself runs only on a card; chip_smoke.py holds it against
`colored_sweeps_reference` there. Here the reference is held against the
JAX package's Pallas kernel (interpret mode) and XLA Jacobi sweeps, and the
wrapper's CPU routing and ctypes binding are checked.
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
from nmc_tpu_torch.ops import sweeps_cuda
from nmc_tpu_torch.ops.sweeps_cuda import (colored_sweeps,
                                           colored_sweeps_reference)

from torch_parity import jax_sweep_uniforms, t64


def _colored(prob, R, seed, dtype):
    b = block_problem(prob, block_size=8, groups=color_groups(prob.J),
                      dtype=dtype)
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
    """The engine passes beta_spin as a 0-d tensor and the mask as an
    expand view; the wrapper hands the kernel contiguous [R, n_pad]."""
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
           / "colored_sweeps.cu").read_text()
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
