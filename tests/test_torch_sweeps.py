"""nmc_tpu_torch.ops.sweeps against nmc_tpu.ops.sweeps.

The JAX engine's own uniforms are rebuilt from its key and injected into
the port, so both run the same chain draw for draw (f64: m and m_best
equal, phi and energies within 1e-10)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmc_tpu.core.problem import IsingProblem, block_problem
from nmc_tpu.io.generators import chimera_graph, ea_2d, random_sk
from nmc_tpu.ops.coloring import color_groups
from nmc_tpu.ops.sweeps import anneal_schedule as j_anneal
from nmc_tpu.ops.sweeps import run_sweeps as j_run_sweeps
from nmc_tpu_torch.ops.engine import SweepEngine
from nmc_tpu_torch.ops.sweeps import anneal_schedule, run_sweeps

from torch_parity import jax_sweep_uniforms, t64

CASES = {
    # name: (problem, colored layout, within_block, record_m)
    "chimera_jacobi": (lambda: chimera_graph(2, 2, seed=3), True, "jacobi",
                       False),
    "ea2d_jacobi_record": (lambda: ea_2d(4, seed=1, pm=False), True, "jacobi",
                           True),
    "sk_sequential": (lambda: random_sk(12, seed=2, h_scale=0.7), False,
                      "sequential", False),
    "sk_sequential_record": (lambda: random_sk(10, seed=4, h_scale=0.3),
                             False, "sequential", True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_sweeps_matches_jax(name):
    make, colored, within, record = CASES[name]
    prob = make()
    groups = color_groups(prob.J) if colored else None
    b = block_problem(prob, block_size=8, groups=groups, dtype=np.float64)
    assert b.colored == colored
    R, T = 5, 9
    rng = np.random.default_rng(11)
    m0 = np.where(rng.random((R, b.n_pad)) < 0.5, -1.0, 1.0)
    m0[:, ~b.active] = 1.0
    J = b.J_rows.reshape(b.n_pad, b.n_pad)
    phi0 = m0 @ J + b.h
    beta = np.linspace(0.3, 1.7, T)
    heated = rng.random((R, b.n_pad)) < 0.3
    bs = np.where(heated, 0.05, 1.0)
    mask = (rng.random((R, b.n_pad)) < 0.8) & b.active
    key = jax.random.PRNGKey(17)

    jr = j_run_sweeps(jnp.asarray(b.J_rows), jnp.asarray(b.J_diag),
                      jnp.asarray(b.h), jnp.asarray(m0), jnp.asarray(phi0),
                      key, jnp.asarray(beta), jnp.asarray(bs),
                      jnp.asarray(mask), num_sweeps=T, within_block=within,
                      record_m=record)
    u = torch.as_tensor(jax_sweep_uniforms(key, T, R, b.n_pad))
    tr = run_sweeps(t64(b.J_rows), t64(b.J_diag), t64(b.h), t64(m0),
                    t64(phi0), None, t64(beta), t64(bs), torch.as_tensor(mask),
                    num_sweeps=T, within_block=within, record_m=record,
                    uniforms=u)
    np.testing.assert_array_equal(tr.m.numpy(), np.asarray(jr.m))
    np.testing.assert_array_equal(tr.m_best.numpy(), np.asarray(jr.m_best))
    np.testing.assert_allclose(tr.phi.numpy(), np.asarray(jr.phi), atol=1e-10)
    np.testing.assert_allclose(tr.energies.numpy(), np.asarray(jr.energies),
                               atol=1e-10)
    np.testing.assert_allclose(tr.e_best.numpy(), np.asarray(jr.e_best),
                               atol=1e-10)
    if record:
        np.testing.assert_array_equal(tr.M.numpy(), np.asarray(jr.M))
    else:
        assert tr.M is None and jr.M is None
    # the sweeps moved something and froze what the mask froze
    assert (tr.m.numpy() != m0).any()
    np.testing.assert_array_equal(tr.m.numpy()[~mask], m0[~mask])


@pytest.mark.parametrize("num_sweeps,beta,initial_beta,spb", [
    (20, 2.5, 0.0, 1), (17, 3.0, 0.5, 4), (5, 1.0, 0.2, 10), (1, 2.0, 0.0, 1)])
def test_anneal_schedule_matches_jax(num_sweeps, beta, initial_beta, spb):
    a = anneal_schedule(num_sweeps, beta, initial_beta, spb,
                        dtype=torch.float64).numpy()
    b = np.asarray(j_anneal(num_sweeps, beta, initial_beta, spb,
                            dtype=jnp.float64))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def jax_block_orders(key, num_sweeps, nB):
    """The block permutations nmc_tpu.ops.sweeps.run_sweeps draws under
    block_order='random': split(key, T), then split(key_t)[1], then
    permutation(., nB) per sweep."""
    return np.stack([np.asarray(jax.random.permutation(
        jax.random.split(k)[1], nB)) for k in jax.random.split(key, num_sweeps)])


@pytest.mark.parametrize("within,colored,record", [
    ("sequential", False, False), ("sequential", False, True),
    ("jacobi", True, False)])
def test_random_block_order_matches_jax(within, colored, record):
    """block_order='random' with JAX's uniforms and permutations injected:
    the same chain draw for draw (f64: m, m_best and M equal, phi and
    energies within 1e-10)."""
    prob = (chimera_graph(2, 2, seed=5) if colored
            else random_sk(20, seed=6, h_scale=0.5))
    groups = color_groups(prob.J) if colored else None
    b = block_problem(prob, block_size=4, groups=groups, dtype=np.float64)
    assert b.colored == colored and b.num_blocks >= 3
    R, T = 4, 7
    rng = np.random.default_rng(3)
    m0 = np.where(rng.random((R, b.n_pad)) < 0.5, -1.0, 1.0)
    m0[:, ~b.active] = 1.0
    phi0 = m0 @ b.J_rows.reshape(b.n_pad, b.n_pad) + b.h
    beta = np.linspace(0.4, 1.5, T)
    mask = np.broadcast_to(b.active, (R, b.n_pad)).copy()
    key = jax.random.PRNGKey(23)
    jr = j_run_sweeps(jnp.asarray(b.J_rows), jnp.asarray(b.J_diag),
                      jnp.asarray(b.h), jnp.asarray(m0), jnp.asarray(phi0),
                      key, jnp.asarray(beta), 1.0, jnp.asarray(mask),
                      num_sweeps=T, within_block=within, block_order="random",
                      record_m=record)
    orders = jax_block_orders(key, T, b.num_blocks)
    assert len({tuple(o) for o in orders}) > 1
    tr = run_sweeps(t64(b.J_rows), t64(b.J_diag), t64(b.h), t64(m0),
                    t64(phi0), None, t64(beta), 1.0, torch.as_tensor(mask),
                    num_sweeps=T, within_block=within, block_order="random",
                    record_m=record,
                    uniforms=torch.as_tensor(jax_sweep_uniforms(
                        key, T, R, b.n_pad)),
                    block_orders=torch.as_tensor(orders))
    np.testing.assert_array_equal(tr.m.numpy(), np.asarray(jr.m))
    np.testing.assert_array_equal(tr.m_best.numpy(), np.asarray(jr.m_best))
    np.testing.assert_allclose(tr.phi.numpy(), np.asarray(jr.phi), atol=1e-10)
    np.testing.assert_allclose(tr.energies.numpy(), np.asarray(jr.energies),
                               atol=1e-10)
    if record:
        np.testing.assert_array_equal(tr.M.numpy(), np.asarray(jr.M))
    # the generator route draws its own permutations, and differs from
    # the fixed order on the same uniforms
    gen = run_sweeps(t64(b.J_rows), t64(b.J_diag), t64(b.h), t64(m0),
                     t64(phi0), torch.Generator().manual_seed(0), t64(beta),
                     1.0, torch.as_tensor(mask), num_sweeps=T,
                     within_block=within, block_order="random")
    assert torch.isin(gen.m, torch.tensor([-1.0, 1.0],
                                          dtype=torch.float64)).all()
    with pytest.raises(ValueError):
        run_sweeps(t64(b.J_rows), t64(b.J_diag), t64(b.h), t64(m0),
                   t64(phi0), None, t64(beta), 1.0, torch.as_tensor(mask),
                   num_sweeps=T, block_order="random",
                   uniforms=torch.zeros((T, R, b.n_pad), dtype=torch.float64))


@pytest.mark.parametrize("use_coloring,block_size", [(True, 8), (False, 2)])
def test_plain_path_matches_boltzmann(use_coloring, block_size):
    """Enumerated 4-cycle with fields: the visited-state law of the plain
    path (colored Jacobi, and the sequential scan) is Boltzmann."""
    rng = np.random.default_rng(1234)
    n, beta = 4, 0.8
    J = np.zeros((n, n))
    for i in range(n):
        j = (i + 1) % n
        J[i, j] = J[j, i] = rng.normal()
    prob = IsingProblem(J, 0.3 * rng.normal(size=n))
    states = np.array(list(itertools.product([-1, 1], repeat=n)), float)
    p = np.exp(-beta * prob.energy(states))
    p /= p.sum()
    weights = 2 ** np.arange(n)[::-1]
    target = np.zeros(2 ** n)
    target[(((states + 1) / 2) @ weights).astype(int)] = p

    eng = SweepEngine(prob, block_size=block_size, use_coloring=use_coloring,
                      dtype="float64", device="cpu")
    assert eng.within_block == ("jacobi" if use_coloring else "sequential")
    gen = torch.Generator().manual_seed(0)
    m0 = eng.from_blocked(eng.init_states(gen, 256))
    res = eng.run(m0, gen, num_sweeps=300, beta=beta, record_m=True)
    M = res.M.numpy()[50:].reshape(-1, n)
    counts = np.bincount((((M + 1) / 2) @ weights).astype(int),
                         minlength=2 ** n).astype(float)
    counts /= counts.sum()
    assert np.abs(counts - target).sum() / 2 < 0.05
