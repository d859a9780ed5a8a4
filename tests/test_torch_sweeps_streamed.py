"""The streamed sweep kernels' plain twins (K2, K3) and the engine's routing.

The CUDA kernels run only on a card, where chip_smoke.py holds them against
`colored_sweeps_streamed_reference` and `colored_sweeps_sparse_reference`.
Here those plain versions are held against the JAX package's Pallas kernels
in interpret mode (whose PRNG returns u = 0, so the plain versions are fed
zeros; f32, m and m_best exact, phi and energies to 1e-5) and against the
JAX XLA Jacobi sweeps with JAX's uniforms injected (f64: m exact, phi and
energies to 1e-10). The engine's K1/K2/K3 routing, `beta_replica`, the CPU
routing of the wrappers and the ctypes signatures are checked too.
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

from nmc_tpu.core.problem import block_problem, block_sparse_tiles
from nmc_tpu.io.generators import chimera_graph
from nmc_tpu.ops.coloring import color_groups
from nmc_tpu.ops.engine import SweepEngine as JaxEngine
from nmc_tpu.ops.sweeps import run_sweeps as j_run_sweeps
from nmc_tpu.ops.sweeps_pallas import (pallas_colored_sweeps_sparse,
                                       pallas_colored_sweeps_streamed)
from nmc_tpu_torch import interop
from nmc_tpu_torch.core.problem import IsingProblem
from nmc_tpu_torch.io.generators import chimera_graph as t_chimera_graph
from nmc_tpu_torch.ops import sweeps_cuda
from nmc_tpu_torch.ops.engine import SweepEngine
from nmc_tpu_torch.ops.sweeps_cuda import (
    colored_sweeps, colored_sweeps_sparse,
    colored_sweeps_sparse_reference, colored_sweeps_streamed,
    colored_sweeps_streamed_reference)

from torch_parity import jax_sweep_uniforms, t64

CSRC = Path(sweeps_cuda.__file__).resolve().parent.parent / "csrc"
COUNTED = (colored_sweeps, colored_sweeps_streamed, colored_sweeps_sparse)


def _launches():
    return [f.launches for f in COUNTED]


def _layout(R, seed, dtype):
    """chimera 2x2 (N = 32) in blocks of 8: 5 row blocks, K = 4 tiles, and
    row blocks 2 and 3 carry a real tile at column block 0 as well as zero
    padding tiles that alias it."""
    prob = chimera_graph(2, 2, seed=3)
    b = block_problem(prob, block_size=8, groups=color_groups(prob.J),
                      dtype=dtype)
    assert b.colored
    col_idx, J_tiles = block_sparse_tiles(b)
    real = np.any(J_tiles != 0, axis=(2, 3))
    aliased = [r for r in range(b.num_blocks)
               if col_idx[r, 0] == 0 and real[r, 0] and not real[r].all()]
    assert aliased, "the layout must have a padding tile aliasing block 0"
    rng = np.random.default_rng(seed)
    m0 = np.where(rng.random((R, b.n_pad)) < 0.5, -1.0, 1.0).astype(dtype)
    m0[:, ~b.active] = 1.0
    phi0 = (m0 @ b.J_rows.reshape(b.n_pad, b.n_pad) + b.h).astype(dtype)
    return b, col_idx, J_tiles, m0, phi0, rng


def _cases(b, R, rng, dtype):
    """(beta_row, mask, beta_spin) per case: both mask shapes, with and
    without beta_spin, beta_row never all equal. With the sweep betas of
    the interpret test and |phi| <= 6, every |beta * phi| stays clear of
    [8, 9.6], where f32 tanh reaches exactly 1 in one implementation and
    not in another."""
    beta_row = np.linspace(0.5, 1.25, R).astype(dtype)
    chain_mask = (rng.random((R, b.n_pad)) < 0.7) & b.active
    heated = np.where(rng.random((R, b.n_pad)) < 0.3, 0.01, 1.0).astype(dtype)
    return {
        "activity_mask": (beta_row, b.active[None, :], None),
        "chain_mask": (beta_row, chain_mask, None),
        "chain_mask_beta_spin": (beta_row, chain_mask, heated),
        "activity_mask_beta_spin": (beta_row, b.active[None, :], heated),
    }


@pytest.mark.parametrize("case", ["activity_mask", "chain_mask",
                                  "chain_mask_beta_spin",
                                  "activity_mask_beta_spin"])
@pytest.mark.parametrize("kernel", ["streamed", "sparse"])
def test_reference_matches_pallas_interpret_zero_uniforms(kernel, case):
    """K2 and K3 in interpret mode (u = 0) against the plain twins fed
    zeros, f32; large sweep betas make tanh saturate, so the u = 0 dynamics
    are a nontrivial greedy descent."""
    R, T = 4, 4
    b, col_idx, J_tiles, m0, phi0, rng = _layout(R, 2, np.float32)
    beta_row, mask, bs = _cases(b, R, rng, np.float32)[case]
    beta = np.array([20.0, 0.5, 30.0, 1.0], np.float32)
    common = (jnp.asarray(b.h), m0, phi0, 3, beta, beta_row,
              mask.astype(np.float32), None if bs is None else bs)
    if kernel == "streamed":
        jr = pallas_colored_sweeps_streamed(
            jnp.asarray(b.J_rows), *common, num_sweeps=T, block_size=8,
            interpret=True)
        tr = colored_sweeps_streamed_reference(
            torch.as_tensor(b.J_rows), torch.as_tensor(b.h),
            torch.as_tensor(m0), torch.as_tensor(phi0), None,
            torch.as_tensor(beta), torch.as_tensor(beta_row),
            torch.as_tensor(mask), None if bs is None else torch.as_tensor(bs),
            num_sweeps=T, uniforms=torch.zeros((T, R, b.n_pad)))
    else:
        jr = pallas_colored_sweeps_sparse(
            jnp.asarray(col_idx), jnp.asarray(J_tiles), *common,
            num_sweeps=T, block_size=8, interpret=True)
        tr = colored_sweeps_sparse_reference(
            torch.as_tensor(col_idx), torch.as_tensor(J_tiles),
            torch.as_tensor(b.h), torch.as_tensor(m0), torch.as_tensor(phi0),
            None, torch.as_tensor(beta), torch.as_tensor(beta_row),
            torch.as_tensor(mask), None if bs is None else torch.as_tensor(bs),
            num_sweeps=T, uniforms=torch.zeros((T, R, b.n_pad)))
    np.testing.assert_array_equal(tr.m.numpy(), np.asarray(jr.m))
    np.testing.assert_array_equal(tr.m_best.numpy(), np.asarray(jr.m_best))
    np.testing.assert_allclose(tr.phi.numpy(), np.asarray(jr.phi), atol=1e-5)
    np.testing.assert_allclose(tr.energies.numpy(), np.asarray(jr.energies),
                               atol=1e-5)
    np.testing.assert_allclose(tr.e_best.numpy(), np.asarray(jr.e_best),
                               atol=1e-5)
    assert (tr.m.numpy() != m0).any()
    frozen = ~np.broadcast_to(mask, m0.shape)
    np.testing.assert_array_equal(tr.m.numpy()[frozen], m0[frozen])


@pytest.mark.parametrize("case", ["per_replica_beta", "beta_spin"])
@pytest.mark.parametrize("kernel", ["streamed", "sparse"])
def test_reference_matches_jax_jacobi_sweeps(kernel, case):
    """The plain twins against the JAX XLA Jacobi sweeps with JAX's own
    uniforms injected, f64. The XLA sweeps take one beta multiplier, so the
    cases are beta_row alone (as [R, 1]) and beta_spin with beta_row = 1,
    where (beta_t * beta_row) * beta_spin is the same product."""
    R, T = 5, 10
    b, col_idx, J_tiles, m0, phi0, rng = _layout(R, 7, np.float64)
    beta = np.full(T, 1.3)
    heated = rng.random(m0.shape) < 0.4
    if case == "per_replica_beta":
        beta_row, bs, mask = np.linspace(0.4, 2.5, R), None, b.active[None]
        j_bs = beta_row[:, None]
    else:
        beta_row, mask = np.ones(R), heated & b.active
        bs = np.where(heated, 1.0 / 20.0, 1.0)
        j_bs = bs
    key = jax.random.PRNGKey(11)
    jr = j_run_sweeps(jnp.asarray(b.J_rows), jnp.asarray(b.J_diag),
                      jnp.asarray(b.h), jnp.asarray(m0), jnp.asarray(phi0),
                      key, jnp.asarray(beta), jnp.asarray(j_bs),
                      jnp.asarray(np.broadcast_to(mask, m0.shape)),
                      num_sweeps=T, within_block="jacobi")
    u = torch.as_tensor(jax_sweep_uniforms(key, T, R, b.n_pad))
    rest = (t64(m0), t64(phi0), None, t64(beta), t64(beta_row),
            torch.as_tensor(mask), None if bs is None else t64(bs))
    before = _launches()
    if kernel == "streamed":
        tr = colored_sweeps_streamed(t64(b.J_rows), t64(b.h), *rest,
                                     num_sweeps=T, uniforms=u)
    else:
        tr = colored_sweeps_sparse(torch.as_tensor(col_idx), t64(J_tiles),
                                   t64(b.h), *rest, num_sweeps=T, uniforms=u)
    assert _launches() == before
    np.testing.assert_array_equal(tr.m.numpy(), np.asarray(jr.m))
    np.testing.assert_array_equal(tr.m_best.numpy(), np.asarray(jr.m_best))
    np.testing.assert_allclose(tr.phi.numpy(), np.asarray(jr.phi), atol=1e-10)
    np.testing.assert_allclose(tr.energies.numpy(), np.asarray(jr.energies),
                               atol=1e-10)
    np.testing.assert_allclose(tr.e_best.numpy(), np.asarray(jr.e_best),
                               atol=1e-10)


def test_three_kernels_agree_on_one_generator_stream():
    """On +-J couplings phi is integer-valued, so K1, K2 and K3 compute the
    same function exactly; their plain twins, driven by generators with
    one seed, agree bit for bit (chip_smoke.py checks the kernels so)."""
    R, T = 3, 6
    b, col_idx, J_tiles, m0, phi0, _ = _layout(R, 4, np.float32)
    J = torch.as_tensor(b.J_rows.reshape(b.n_pad, b.n_pad))
    h, m, phi = (torch.as_tensor(x) for x in (b.h, m0, phi0))
    beta = torch.full((T,), 0.7)
    mask = torch.as_tensor(b.active)
    k1 = colored_sweeps(J, h, m, phi, torch.Generator().manual_seed(9), beta,
                        torch.ones(()), mask.expand(R, b.n_pad),
                        num_sweeps=T, block_size=8)
    k2 = colored_sweeps_streamed(torch.as_tensor(b.J_rows), h, m, phi,
                                 torch.Generator().manual_seed(9), beta,
                                 torch.ones(R), mask[None], num_sweeps=T)
    k3 = colored_sweeps_sparse(torch.as_tensor(col_idx),
                               torch.as_tensor(J_tiles), h, m, phi,
                               torch.Generator().manual_seed(9), beta,
                               torch.ones(R), mask[None], num_sweeps=T)
    for other in (k2, k3):
        for x, y in zip(k1, other):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_wrappers_on_cpu_run_plain_versions_and_check_inputs():
    R = 3
    b, col_idx, J_tiles, m0, phi0, _ = _layout(R, 5, np.float32)
    args = (torch.as_tensor(b.h), torch.as_tensor(m0), torch.as_tensor(phi0),
            torch.Generator().manual_seed(2), torch.full((3,), 0.9),
            torch.ones(R), torch.as_tensor(b.active)[None])
    before = _launches()
    a = colored_sweeps_sparse(torch.as_tensor(col_idx),
                              torch.as_tensor(J_tiles), *args, num_sweeps=3)
    args = args[:3] + (torch.Generator().manual_seed(2),) + args[4:]
    r = colored_sweeps_sparse_reference(torch.as_tensor(col_idx),
                                        torch.as_tensor(J_tiles), *args,
                                        num_sweeps=3)
    assert _launches() == before
    for x, y in zip(a, r):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    meta = tuple(t.to("meta") if isinstance(t, torch.Tensor) else None
                 for t in args)
    with pytest.raises(ValueError, match="cuda or cpu"):
        colored_sweeps_streamed(torch.as_tensor(b.J_rows).to("meta"), *meta,
                                num_sweeps=3)
    with pytest.raises(ValueError, match="1 or 3 rows"):
        sweeps_cuda._mask_rows(torch.ones((2, b.n_pad), dtype=torch.bool), R,
                               b.n_pad, torch.device("cpu"))
    with pytest.raises(ValueError, match="shared memory"):
        sweeps_cuda._check_shared("colored_sweeps_sparse",
                                  sweeps_cuda.MAX_SHARED_BYTES + 1)


@pytest.mark.parametrize("fn,source", [
    ("colored_sweeps_f32", "colored_sweeps_nbr.cu"),
    ("colored_sweeps_streamed_f32", "colored_sweeps_nbr.cu"),
    ("colored_sweeps_sparse_f32", "colored_sweeps_nbr.cu"),
])
def test_ctypes_binding_matches_each_entry_point(fn, source):
    """Every parameter of each C entry point gets a ctypes type, pointers as
    c_void_p (a c_int would cut a 64-bit pointer)."""
    src = (CSRC / source).read_text()
    sig = re.search(rf"int {fn}\((.*?)\)\s*\{{", src, re.S).group(1)
    params = [p.strip() for p in sig.split(",")]
    fake = types.SimpleNamespace(**{fn: types.SimpleNamespace()})
    argtypes = getattr(sweeps_cuda._bind(fake, fn), fn).argtypes
    assert len(argtypes) == len(params)
    for p, t in zip(params, argtypes):
        expected = ctypes.c_void_p if "*" in p else ctypes.c_int
        assert t is expected, p


def _regular3(N, seed=0):
    """The union of three random perfect matchings with +-1 weights."""
    rng = np.random.default_rng(seed)
    J = np.zeros((N, N))
    for _ in range(3):
        p = rng.permutation(N)
        a, c = p[:N // 2], p[N // 2:]
        w = rng.choice([-1.0, 1.0], size=N // 2)
        J[a, c] = w
        J[c, a] = w
    return IsingProblem(J, np.zeros(N))


@pytest.mark.parametrize("name,kernel", [
    ("chimera_8x8", "colored_sweeps"),
    ("chimera_16x16", "colored_sweeps_sparse"),
    ("regular3_2048", "colored_sweeps_streamed"),
])
def test_engine_routes_each_layout(name, kernel):
    """The layout decision alone: K1 up to n_pad 1536, then K3 when every
    row block touches at most nB/2 column tiles, else K2."""
    prob = {"chimera_8x8": lambda: t_chimera_graph(8, 8, seed=0),
            "chimera_16x16": lambda: t_chimera_graph(16, 16, seed=0),
            "regular3_2048": lambda: _regular3(2048)}[name]()
    eng = SweepEngine(prob, use_coloring=True, device="cpu")
    assert eng.sweep_kernel == kernel
    assert (eng.stream_tiles is not None) == (kernel == "colored_sweeps_sparse")
    if kernel == "colored_sweeps_sparse":
        col_idx, J_tiles = eng.stream_tiles
        assert col_idx.shape[1] <= eng.blocked.num_blocks // 2
        assert J_tiles.shape[1:] == (col_idx.shape[1], 128, 128)


@pytest.mark.parametrize("name", ["chimera_2x2_block8", "chimera_16x16",
                                  "regular3_2048"])
def test_engine_beta_replica_matches_jax(name):
    """engine.run(beta_replica=...) against the JAX engine with its uniforms
    replayed, f64, on the K1, K3 and K2 routes; the CPU launches nothing."""
    prob, block = {
        "chimera_2x2_block8": (chimera_graph(2, 2, seed=1), 8),
        "chimera_16x16": (chimera_graph(16, 16, seed=0), 128),
        "regular3_2048": (_regular3(2048, seed=1), 128)}[name]
    jeng = JaxEngine(prob, block_size=block, use_coloring=True,
                     dtype=jnp.float64)
    teng = SweepEngine.from_blocked_problem(
        interop.blocked_from_numpy(jeng.blocked),
        interop.problem_from_numpy(prob.J, prob.h), dtype="float64",
        device="cpu")
    R, T = 3, 2
    rng = np.random.default_rng(0)
    m0 = np.where(rng.random((R, prob.n)) < 0.5, -1.0, 1.0)
    beta_rep = np.array([0.3, 1.1, 2.4])
    key = jax.random.PRNGKey(4)
    jr = jeng.run(m0, key, T, 1.0, beta_replica=beta_rep)
    u = torch.as_tensor(jax_sweep_uniforms(key, T, R, teng.n_pad))
    before = _launches()
    tr = teng.run(m0, None, T, 1.0, beta_replica=beta_rep, uniforms=u)
    assert _launches() == before
    np.testing.assert_array_equal(tr.m.numpy(), np.asarray(jr.m))
    np.testing.assert_array_equal(tr.m_best.numpy(), np.asarray(jr.m_best))
    np.testing.assert_allclose(tr.energies.numpy(), np.asarray(jr.energies),
                               rtol=0, atol=1e-10)
    with pytest.raises(ValueError, match="not both"):
        teng.run(m0, None, T, 1.0, beta_replica=beta_rep,
                 beta_spin=np.ones(prob.n), uniforms=u)
