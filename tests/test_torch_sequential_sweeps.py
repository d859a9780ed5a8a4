"""The sequential route's layout and plain twin, on the CPU.

`sequential_sweeps` runs JAX's blocked sequential sweep in its own kernel
(csrc/sequential_sweeps.cu): per row block an in-block chain through the
diagonal tile J_diag, then one phi update over the block's couplings
(`sequential_neighbors`, the union layout over blocks of B). Here, with
inputs made from seeds with numpy:
  * the pair rule (`_pair_steps`) is the dense rule of `sweep_steps`
    (the colored layouts' steps);
  * the layout holds every coupling of J once, by row block, sources
    ascending per target;
  * the plain sweeps with the kernel's association
    (`sequential_sweeps_reference`) equal `run_sweeps(within_block=
    "sequential")` bit for bit on +-1 couplings (f32: m, phi, energies,
    M), with the same states on Gaussian couplings (phi to 1e-4 in f32),
    and JAX's sequential sweep with JAX's uniforms in f64 (to 1e-10);
  * the wrapper runs its plain twin on CPU tensors and launches nothing;
  * `SweepEngine` takes the route for f32 uncoloured sequential fixed-order
    layouts (recorded or not), and the plain sweeps for f64, random order
    and uncoloured Jacobi; recorded colored runs go through K1-K3's twins.
The kernel itself runs only on a card (chip_smoke.py's sequential_kernel
phase holds it against these plain sweeps; tests/test_torch_sequential_kernel.py
has the twin against JAX under masks, heating and per-replica beta, and
the batched wrapper).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmc_tpu.core.problem import block_problem as j_block_problem
from nmc_tpu.io.generators import random_sk as j_random_sk
from nmc_tpu.ops.sweeps import run_sweeps as j_run_sweeps
from nmc_tpu_torch.core.problem import IsingProblem
from nmc_tpu_torch.io.generators import chimera_graph, ea_2d, random_sk
from nmc_tpu_torch.ops import engine as t_engine
from nmc_tpu_torch.ops import sweeps_cuda as sc
from nmc_tpu_torch.ops.engine import SweepEngine
from nmc_tpu_torch.ops.sweeps import run_sweeps

from torch_parity import jax_sweep_uniforms, t64


def _pm_sk(n, seed):
    """Dense SK with +-1 couplings and no fields (every sum exact in f32)."""
    rng = np.random.default_rng(seed)
    J = np.triu(rng.choice([-1.0, 1.0], size=(n, n)), 1)
    return IsingProblem(J + J.T, np.zeros(n))


FAMILIES = {
    "sk_pm_40": (lambda: _pm_sk(40, 0), True),
    "sk_gauss_30": (lambda: random_sk(30, seed=1, h_scale=0.5), False),
    "chimera_2x2_pm": (lambda: chimera_graph(2, 2, seed=2), True),
    "chimera_3x3_gauss": (lambda: chimera_graph(3, 3, seed=3, pm=False),
                          False),
    "ea2d_6_pm": (lambda: ea_2d(6, seed=4), True),
}


def _engine(name, block_size=16):
    make, pm = FAMILIES[name]
    return SweepEngine(make(), block_size=block_size, device="cpu"), pm


def _dense_steps(adj):
    """The step rule on a dense block pattern, spelled out."""
    adj = np.asarray(adj, bool)
    adj = adj | adj.T
    bounds = [0]
    for c in range(1, adj.shape[0]):
        if adj[c, bounds[-1]:c].any():
            bounds.append(c)
    return bounds + [adj.shape[0]]


@pytest.mark.parametrize("seed", range(4))
def test_pair_steps_is_the_dense_rule(seed):
    rng = np.random.default_rng(seed)
    nB = 30
    adj = rng.random((nB, nB)) < [0.02, 0.08, 0.2, 0.5][seed]
    b, c = np.nonzero(adj)
    assert sc._pair_steps(torch.as_tensor(b), torch.as_tensor(c), nB) \
        == _dense_steps(adj) == sc.sweep_steps(adj)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_sequential_layout_holds_every_coupling_by_block(name):
    """The engine's layout is J's couplings by row block of B, rank by
    rank: per block b, each target j with its sources k in the block in
    ascending order (offsets k - b B) and weight J[k, j], then zero-weight
    padding; a dense block (SK) holds rank d = offset d for every target,
    weight J[b B + d, j] (zero included). Every nonzero of J once."""
    eng, _ = _engine(name)
    nbrs = eng.sweep_nbrs
    assert eng.sweep_kernel == "sequential_sweeps"
    B, n_pad = eng.blocked.block_size, eng.n_pad
    assert nbrs.block_size == B and nbrs.w.shape[0] == 1
    J = eng.J_full
    seen = torch.zeros_like(J)
    tgt_ptr, ell_ptr = nbrs.tgt_ptr.tolist(), nbrs.ell_ptr.tolist()
    assert len(tgt_ptr) == len(ell_ptr) == n_pad // B + 1
    for b in range(n_pad // B):
        nt = tgt_ptr[b + 1] - tgt_ptr[b]
        D = (ell_ptr[b + 1] - ell_ptr[b]) // max(nt, 1)
        assert D * nt == ell_ptr[b + 1] - ell_ptr[b]
        src = nbrs.src[ell_ptr[b]:ell_ptr[b + 1]].long().reshape(D, nt)
        w = nbrs.w[0, ell_ptr[b]:ell_ptr[b + 1]].reshape(D, nt)
        tgt = nbrs.tgt[tgt_ptr[b]:tgt_ptr[b + 1]].long()
        if nbrs.dense[b]:
            assert torch.equal(src, torch.arange(D)[:, None].expand(D, nt))
            assert torch.equal(w, J[b * B:b * B + D][:, tgt])
            assert int((J[b * B + D:(b + 1) * B] != 0).sum()) == 0
            seen[b * B:b * B + D][:, tgt] += (w != 0).to(seen.dtype)
            continue
        for i in range(nt):
            live = w[:, i] != 0
            count = int(live.sum())
            assert bool(live[:count].all()) and not bool(live[count:].any())
            k = src[:count, i]
            assert bool((k[1:] > k[:-1]).all()) and bool((k < B).all())
            assert bool((src[count:, i] == 0).all())
            assert torch.equal(w[:count, i], J[b * B + k, tgt[i]])
            seen[b * B + k, tgt[i]] += 1
    assert torch.equal(seen, (J != 0).to(seen.dtype))
    dense = name.startswith("sk")
    assert bool(nbrs.dense.bool().all()) == dense


def _twin(eng, m0, phi0, beta, mask, T, u, beta_row=None, beta_spin=None):
    """`sequential_sweeps_reference` of one instance, outputs without the
    instance axis."""
    R = m0.shape[0]
    res = sc.sequential_sweeps_reference(
        eng.sweep_nbrs, eng.J_diag[None], eng.h[None], m0[None], phi0[None],
        None, beta, torch.ones(1, R) if beta_row is None else beta_row[None],
        mask[None], None if beta_spin is None else beta_spin[None],
        num_sweeps=T, uniforms=u[:, None], record_m=True)
    return type(res)(*(x[0] for x in res))


def _case(eng, R, T, seed):
    rng = np.random.default_rng(seed)
    n_pad = eng.n_pad
    m0 = eng.init_states(torch.Generator().manual_seed(seed), R)
    phi0 = eng.fields(m0)
    u = torch.as_tensor(rng.random((T, R, n_pad)), dtype=torch.float32)
    beta = torch.as_tensor(np.linspace(0.4, 2.0, T), dtype=torch.float32)
    return m0, phi0, u, beta


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_layout_twin_is_the_sequential_sweep(name):
    """The plain sweeps with the kernel's association over its layout (the
    kernel's function) equal run_sweeps' sequential sweep draw for draw:
    bit for bit on +-1 couplings, the same states (phi within 1e-4, f32)
    on Gaussian ones."""
    eng, pm = _engine(name)
    R, T = 6, 5
    m0, phi0, u, beta = _case(eng, R, T, 7)
    mask = eng.active.expand(R, eng.n_pad)
    seq = run_sweeps(eng.J_rows, eng.J_diag, eng.h, m0, phi0, None, beta,
                     torch.ones(()), mask, num_sweeps=T,
                     within_block="sequential", uniforms=u, record_m=True)
    nbr = _twin(eng, m0, phi0, beta, mask, T, u)
    assert torch.equal(seq.m, nbr.m) and torch.equal(seq.M, nbr.M)
    assert torch.equal(seq.m_best, nbr.m_best)
    assert torch.equal(nbr.M[-1], nbr.m)
    if pm:
        for x in ("phi", "energies", "e_best"):
            assert torch.equal(getattr(seq, x), getattr(nbr, x)), x
    else:
        torch.testing.assert_close(nbr.phi, seq.phi, rtol=0, atol=1e-4)
        torch.testing.assert_close(nbr.energies, seq.energies, rtol=0,
                                   atol=1e-3)
    assert (seq.m != m0).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_layout_twin_matches_jax_sequential_f64(seed):
    """f64, Gaussian SK with fields, JAX's uniforms injected: the plain
    sweeps with the kernel's association follow JAX's sequential sweep
    (states equal, phi and energies within 1e-10)."""
    prob = j_random_sk(24, seed=seed, h_scale=0.4)
    b = j_block_problem(prob, block_size=8, dtype=np.float64)
    R, T = 4, 6
    rng = np.random.default_rng(seed)
    m0 = np.where(rng.random((R, b.n_pad)) < 0.5, -1.0, 1.0)
    m0[:, ~b.active] = 1.0
    phi0 = m0 @ b.J_rows.reshape(b.n_pad, b.n_pad) + b.h
    beta = np.linspace(0.5, 1.8, T)
    mask = np.broadcast_to(b.active, (R, b.n_pad)).copy()
    key = jax.random.PRNGKey(31 + seed)
    jr = j_run_sweeps(jnp.asarray(b.J_rows), jnp.asarray(b.J_diag),
                      jnp.asarray(b.h), jnp.asarray(m0), jnp.asarray(phi0),
                      key, jnp.asarray(beta), 1.0, jnp.asarray(mask),
                      num_sweeps=T, within_block="sequential", record_m=True)
    nbrs = sc.sequential_neighbors(t64(b.J_rows))
    tr = sc.sequential_sweeps_reference(
        nbrs, t64(b.J_diag)[None], t64(b.h)[None], t64(m0)[None],
        t64(phi0)[None], None, t64(beta),
        torch.ones((1, R), dtype=torch.float64), torch.as_tensor(mask)[None],
        num_sweeps=T, record_m=True,
        uniforms=torch.as_tensor(jax_sweep_uniforms(key, T, R, b.n_pad))[:, None])
    np.testing.assert_array_equal(tr.m[0].numpy(), np.asarray(jr.m))
    np.testing.assert_array_equal(tr.M[0].numpy(), np.asarray(jr.M))
    np.testing.assert_allclose(tr.phi[0].numpy(), np.asarray(jr.phi),
                               atol=1e-10)
    np.testing.assert_allclose(tr.energies[0].numpy(),
                               np.asarray(jr.energies), atol=1e-10)


def test_wrapper_on_cpu_runs_the_plain_version_uncounted():
    eng, _ = _engine("chimera_3x3_gauss")
    R, T = 3, 4
    m0, phi0, u, beta = _case(eng, R, T, 3)
    mask = eng.active.expand(R, eng.n_pad)
    before = sc.sequential_sweeps.launches
    a = sc.sequential_sweeps(eng.J_rows, eng.J_diag, eng.h, m0, phi0,
                             torch.Generator().manual_seed(5), beta,
                             torch.ones(()), mask, num_sweeps=T,
                             record_m=True, nbrs=eng.sweep_nbrs,
                             replicas_per_cta=8)
    r = run_sweeps(eng.J_rows, eng.J_diag, eng.h, m0, phi0,
                   torch.Generator().manual_seed(5), beta, torch.ones(()),
                   mask, num_sweeps=T, within_block="sequential",
                   record_m=True)
    assert sc.sequential_sweeps.launches == before
    for x, y in zip(a, r):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        sc.sequential_sweeps(*(t.to("meta") for t in (
            eng.J_rows, eng.J_diag, eng.h, m0, phi0)), None, beta.to("meta"),
            torch.ones((), device="meta"), mask.to("meta"), num_sweeps=T)


def test_ctypes_signature_has_the_record_pointer():
    """Every entry point of the colored body and of the sequential kernel
    takes 21 pointers (M the last) and its ints, as its ctypes signature
    says."""
    csrc = t_engine.__file__.rsplit("/ops/", 1)[0] + "/csrc/"
    for lib, sigs in (("colored_sweeps_nbr", sc._SIGNATURES),
                      ("sequential_sweeps", sc._SEQ_SIGNATURES)):
        text = open(csrc + lib + ".cu").read()
        for fn, kinds in sigs.items():
            body = text[text.index(f"int {fn}("):]
            params = body[body.index("(") + 1:body.index(")")].split(",")
            assert len(params) == len(kinds) + 1, fn   # + the stream
            assert "float* M" in params[len(kinds) - kinds.count("i") - 1], fn


@pytest.mark.parametrize("record", [False, True])
def test_engine_takes_the_route_recorded_or_not(record, monkeypatch):
    """f32 uncoloured sequential fixed order: every run goes through the
    wrapper with the engine's layout, recorded runs too; f64, random order
    and uncoloured Jacobi run the plain sweeps."""
    seen = []
    inner = t_engine.sequential_sweeps

    def recording(*a, **k):
        seen.append((k["nbrs"], k["record_m"]))
        return inner(*a, **k)
    monkeypatch.setattr(t_engine, "sequential_sweeps", recording)
    prob = random_sk(20, seed=9, h_scale=0.3)
    eng = SweepEngine(prob, block_size=8, device="cpu")
    m = np.ones((3, prob.n))
    res = eng.run(m, torch.Generator().manual_seed(1), 4, 1.2,
                  record_m=record)
    assert seen == [(eng.sweep_nbrs, record)]
    assert (res.M is not None) == record
    if record:
        assert res.M.shape == (4, 3, prob.n)
        assert torch.equal(res.M[-1], res.m)
    for kw in (dict(dtype=torch.float64), dict(block_order="random"),
               dict(within_block="jacobi")):
        other = SweepEngine(prob, block_size=8, device="cpu", **kw)
        assert other.sweep_kernel is None and other.sweep_nbrs is None
        other.run(m, torch.Generator().manual_seed(1), 2, 1.2,
                  record_m=record)
    assert len(seen) == 1


@pytest.mark.parametrize("name,kernel", [
    ("chimera_4x4", "colored_sweeps"), ("chimera_16x16",
                                        "colored_sweeps_sparse")])
def test_engine_records_through_the_colored_routes(name, kernel, monkeypatch):
    """Recorded colored runs take K1 / K3 (their plain twins on the CPU)
    and return the same M as the plain Jacobi sweeps from the same
    generator."""
    calls = []
    inner = getattr(t_engine, kernel)

    def recording(*a, **k):
        calls.append(k["record_m"])
        return inner(*a, **k)
    monkeypatch.setattr(t_engine, kernel, recording)
    size = 4 if name == "chimera_4x4" else 16
    prob = chimera_graph(size, size, seed=1)
    eng = SweepEngine(prob, use_coloring=True, device="cpu")
    assert eng.sweep_kernel == kernel
    m = np.ones((2, prob.n))
    res = eng.run(m, torch.Generator().manual_seed(3), 3, 1.5, record_m=True)
    assert calls == [True]
    m0 = torch.where(eng.active, eng.to_blocked(torch.as_tensor(m)), 1.0)
    plain = run_sweeps(eng.J_rows, eng.J_diag, eng.h, m0, eng.fields(m0),
                       torch.Generator().manual_seed(3),
                       torch.full((3,), 1.5), torch.ones(()),
                       eng.active.expand(2, eng.n_pad), num_sweeps=3,
                       within_block="jacobi", record_m=True)
    assert torch.equal(res.M, eng.from_blocked(plain.M))
    assert torch.equal(res.m, eng.from_blocked(plain.m))

