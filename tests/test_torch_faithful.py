"""The port's faithful host kernel (`compat/faithful.py`) against the JAX
package's, and the port's sweeps against it draw for draw.

`mcmc_sequential` is a numpy copy: for one numpy seed it returns the
array JAX's returns, element for element (random scan, fixed scan with
injected uniforms, anneal ramps, the LRU hash-table path). The port's
engine fed the same uniforms runs the host kernel's fixed-order chain
(states equal; energies within 1e-12 in f64, 1e-4 in f32), through the
engine at one spin per block and through the plain sweeps with the
sequential kernel's association over its layout (the kernel's
function)."""

import numpy as np
import pytest
import torch

from nmc_tpu.compat.faithful import LRUFieldCache as JLRU
from nmc_tpu.compat.faithful import mcmc_sequential as j_mcmc
from nmc_tpu_torch.compat.faithful import LRUFieldCache, mcmc_sequential
from nmc_tpu_torch.core.problem import IsingProblem
from nmc_tpu_torch.ops import sweeps_cuda as sc
from nmc_tpu_torch.ops.engine import SweepEngine

from conftest import random_sk


@pytest.mark.parametrize("kw", [
    dict(), dict(anneal=True, sweeps_per_beta=2, initial_beta=0.1),
    dict(incremental=False), dict(scan_order="fixed")],
    ids=["random", "anneal", "direct", "fixed"])
def test_mcmc_sequential_array_equal_to_jax(kw):
    rng = np.random.default_rng(5)
    J, h = random_sk(rng, 11)
    m0 = np.sign(rng.normal(size=11))
    a = mcmc_sequential(9, m0, 1.1, J, h, rng=np.random.default_rng(42),
                        **kw)
    b = j_mcmc(9, m0, 1.1, J, h, rng=np.random.default_rng(42), **kw)
    assert a.shape == (11, 9)
    np.testing.assert_array_equal(a, b)


def test_hash_table_path_array_equal_to_jax():
    rng = np.random.default_rng(6)
    J, h = random_sk(rng, 8)
    m0 = np.sign(rng.normal(size=8))
    t, jt = LRUFieldCache(maxsize=30), JLRU(maxsize=30)
    a = mcmc_sequential(6, m0, 0.9, J, h, hash_table=t, use_hash_table=True,
                        rng=np.random.default_rng(3))
    b = j_mcmc(6, m0, 0.9, J, h, hash_table=jt, use_hash_table=True,
               rng=np.random.default_rng(3))
    np.testing.assert_array_equal(a, b)
    assert (t.hits, t.misses, len(t)) == (jt.hits, jt.misses, len(jt))
    # the cached and the incremental trajectories are the same chain
    np.testing.assert_array_equal(
        a, mcmc_sequential(6, m0, 0.9, J, h, rng=np.random.default_rng(3)))


def test_lru_eviction():
    table = LRUFieldCache(maxsize=2)
    for i in range(4):
        table.store(np.array([float(i)]), np.array([i]))
    assert len(table) == 2
    assert table.lookup(np.array([0.0])) is None
    assert table.lookup(np.array([3.0])) is not None
    assert (table.hits, table.misses) == (1, 1)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_engine_matches_host_kernel_fixed_order(dtype):
    """block_size = 1 and no padding: the engine's sweep is the host
    kernel's 0..n-1 scan, so with the same uniforms both visit the same
    states (K1's CPU twin, in f64 and f32)."""
    rng = np.random.default_rng(7)
    n, T, beta = 12, 15, 1.3
    J, h = random_sk(rng, n)
    prob = IsingProblem(J, h).normalized()[0]
    eng = SweepEngine(prob, block_size=1, dtype=dtype, device="cpu")
    assert eng.n_pad == n
    # one-spin blocks are trivially independent sets, so the layout is
    # "colored" and the route K1's (its steps: runs of uncoupled spins)
    assert eng.sweep_kernel == "colored_sweeps"
    m0 = np.sign(rng.normal(size=(1, n)))
    u = rng.random((T, n))
    res = eng.run(m0, None, num_sweeps=T, beta=beta, record_m=True,
                  uniforms=torch.as_tensor(u[:, None, :], dtype=dtype))
    M_host = mcmc_sequential(T, m0[0], beta, prob.J, prob.h,
                             uniforms=u.astype(np.float32).astype(np.float64)
                             if dtype == torch.float32 else u,
                             scan_order="fixed")
    np.testing.assert_array_equal(res.M[:, 0, :].numpy(), M_host.T)
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    np.testing.assert_allclose(res.energies[:, 0].numpy(),
                               prob.energy(M_host.T), rtol=0, atol=tol)


def test_layout_twin_matches_host_kernel():
    """The plain sweeps with the sequential kernel's association over its
    layout visit the host kernel's states."""
    rng = np.random.default_rng(8)
    n, T, beta = 20, 10, 0.9
    J, h = random_sk(rng, n)
    prob = IsingProblem(J, h).normalized()[0]
    eng = SweepEngine(prob, block_size=4, dtype=torch.float64, device="cpu")
    nbrs = sc.sequential_neighbors(eng.J_rows)
    m0 = np.sign(rng.normal(size=n))
    mb = eng.to_blocked(torch.as_tensor(m0[None]))
    u = rng.random((T, n))
    res = sc.sequential_sweeps_reference(
        nbrs, eng.J_diag[None], eng.h[None], mb[None], eng.fields(mb)[None],
        None, torch.full((T,), beta, dtype=torch.float64),
        torch.ones((1, 1), dtype=torch.float64), eng.active[None, None],
        num_sweeps=T, record_m=True,
        uniforms=eng.to_blocked(torch.as_tensor(u[:, None]))[:, None])
    # the blocked layout permutes nothing here: spin i sits at column i
    M_host = mcmc_sequential(T, m0, beta, prob.J, prob.h, uniforms=u,
                             scan_order="fixed")
    np.testing.assert_array_equal(eng.from_blocked(res.M[0])[:, 0].numpy(),
                                  M_host.T)
