"""The sequential kernel's plain twins and wrappers on the CPU.

csrc/sequential_sweeps.cu runs JAX's blocked sequential sweep: per row
block an in-block chain through the diagonal tile J_diag (corr in flip
order), then phi[j] += the block's products summed from 0 over the
sources in ascending k. `sequential_sweeps_reference` is that association
in plain torch (the kernel's bit-for-bit twin on the card); here, with
inputs made from seeds with numpy:
  * the twin against JAX's run_sweeps(within_block="sequential") with
    JAX's uniforms in f64, on Gaussian SK with fields, uncoloured Gaussian
    chimera and +-J SK, with masks, per-spin heating and per-replica beta
    and recorded states: states equal, phi and energies within 1e-10
    (Gaussian: the product's order differs from XLA's), bit for bit on +-J;
  * the twin against the port's run_sweeps in f32 on +-J SK under the same
    cases, bit for bit (every sum exact);
  * the twin over an ensemble's union layout equals the per-instance
    twins over their own layouts bit for bit (a union edge an instance
    lacks adds fmaf(dm, 0, acc) = acc);
  * `sequential_sweeps_batched` on CPU tensors equals `sequential_sweeps`
    instance after instance bit for bit, from injected uniforms and from
    one generator, and launches nothing;
  * the launch rule (`sequential_launch`), the kernel's limits, the
    routes at any block size (sub-blocks of at most 128 spins, which run
    the same sweep), and each spin's next coupled spin and the rule by
    which a round keeps a run of flips, in a plain model.
The kernel itself runs only on a card (chip_smoke.py's sequential_kernel
phase holds it against this twin).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmc_tpu.core.problem import IsingProblem as JProblem
from nmc_tpu.core.problem import block_problem as j_block_problem
from nmc_tpu.ops.sweeps import run_sweeps as j_run_sweeps
from nmc_tpu_torch.core.problem import IsingProblem
from nmc_tpu_torch.io.generators import chimera_graph, random_sk
from nmc_tpu_torch.ops import sweeps_cuda as sc
from nmc_tpu_torch.ops.engine import SweepEngine
from nmc_tpu_torch.ops.sweeps import run_sweeps
from nmc_tpu_torch.parallel import EnsembleConfig, EnsemblePT

from torch_parity import jax_sweep_uniforms, t64


def _pm_sk(n, seed):
    rng = np.random.default_rng(seed)
    J = np.triu(rng.choice([-1.0, 1.0], size=(n, n)), 1)
    return IsingProblem(J + J.T, np.zeros(n))


# (problem, block size, +-1 couplings)
FAMILIES = {
    "sk_gauss_h": (lambda: random_sk(28, seed=2, h_scale=0.4), 8, False),
    "chimera_3x3_gauss": (lambda: chimera_graph(3, 3, seed=3, pm=False), 16,
                          False),
    "sk_pm": (lambda: _pm_sk(36, 1), 16, True),
}
CASES = ("all", "beta_row", "heated_masked")


def _case_args(case, R, n_pad, active, rng, dtype):
    """(beta_row [R], per-spin beta [R, n_pad] or None, mask [R, n_pad]) of
    a case; JAX's beta_spin is beta_row[:, None] or the per-spin factor."""
    mask = np.broadcast_to(active, (R, n_pad)).copy()
    beta_row = np.ones(R)
    spin = None
    if case == "beta_row":
        beta_row = np.geomspace(0.4, 2.5, R)
    elif case == "heated_masked":
        spin = np.where(rng.random((R, n_pad)) < 0.3, 0.2, 1.0)
        mask &= rng.random((R, n_pad)) < 0.75
    conv = (lambda x: None if x is None
            else torch.as_tensor(x, dtype=dtype))
    return conv(beta_row), conv(spin), torch.as_tensor(mask)


def _one(res):
    return type(res)(*(None if x is None else x[0] for x in res))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_twin_matches_jax_sequential_f64(name, case):
    make, B, pm = FAMILIES[name]
    prob = make()
    b = j_block_problem(JProblem(np.asarray(prob.J), np.asarray(prob.h)),
                        block_size=B, dtype=np.float64)
    R, T = 5, 6
    rng = np.random.default_rng(len(name) + len(case))
    m0 = np.where(rng.random((R, b.n_pad)) < 0.5, -1.0, 1.0)
    m0[:, ~b.active] = 1.0
    phi0 = m0 @ b.J_rows.reshape(b.n_pad, b.n_pad) + b.h
    beta = np.linspace(0.5, 2.2, T)
    beta_row, spin, mask = _case_args(case, R, b.n_pad, b.active, rng,
                                      torch.float64)
    j_spin = (beta_row.numpy()[:, None] if spin is None else spin.numpy())
    key = jax.random.PRNGKey(11)
    jr = j_run_sweeps(jnp.asarray(b.J_rows), jnp.asarray(b.J_diag),
                      jnp.asarray(b.h), jnp.asarray(m0), jnp.asarray(phi0),
                      key, jnp.asarray(beta), jnp.asarray(j_spin),
                      jnp.asarray(mask.numpy()), num_sweeps=T,
                      within_block="sequential", record_m=True)
    u = torch.as_tensor(jax_sweep_uniforms(key, T, R, b.n_pad))
    tr = _one(sc.sequential_sweeps_reference(
        sc.sequential_neighbors(t64(b.J_rows)), t64(b.J_diag)[None],
        t64(b.h)[None], t64(m0)[None], t64(phi0)[None], None, t64(beta),
        beta_row[None], mask[None], None if spin is None else spin[None],
        num_sweeps=T, uniforms=u[:, None], record_m=True))
    for x in ("m", "M", "m_best"):
        np.testing.assert_array_equal(getattr(tr, x).numpy(),
                                      np.asarray(getattr(jr, x)), err_msg=x)
    for x in ("phi", "energies", "e_best"):
        if pm:
            np.testing.assert_array_equal(getattr(tr, x).numpy(),
                                          np.asarray(getattr(jr, x)), x)
        else:
            np.testing.assert_allclose(getattr(tr, x).numpy(),
                                       np.asarray(getattr(jr, x)), rtol=0,
                                       atol=1e-10, err_msg=x)
    assert (tr.m.numpy() != m0).any()


@pytest.mark.parametrize("case", CASES)
def test_twin_equals_run_sweeps_f32_on_pm(case):
    """+-J SK in f32: every sum is an exact integer, so the kernel's
    association and run_sweeps' agree bit for bit on every output."""
    eng = SweepEngine(_pm_sk(40, 3), block_size=16, device="cpu")
    R, T = 6, 5
    rng = np.random.default_rng(5)
    m0 = eng.init_states(torch.Generator().manual_seed(4), R)
    phi0 = eng.fields(m0)
    u = torch.as_tensor(rng.random((T, R, eng.n_pad)), dtype=torch.float32)
    beta = torch.as_tensor(np.linspace(0.3, 2.0, T), dtype=torch.float32)
    beta_row, spin, mask = _case_args(case, R, eng.n_pad, eng.active.numpy(),
                                      rng, torch.float32)
    plain = run_sweeps(eng.J_rows, eng.J_diag, eng.h, m0, phi0, None, beta,
                       beta_row[:, None] if spin is None else spin, mask,
                       num_sweeps=T, within_block="sequential", uniforms=u,
                       record_m=True)
    twin = _one(sc.sequential_sweeps_reference(
        eng.sweep_nbrs, eng.J_diag[None], eng.h[None], m0[None], phi0[None],
        None, beta, beta_row[None], mask[None],
        None if spin is None else spin[None], num_sweeps=T,
        uniforms=u[:, None], record_m=True))
    for x, y, f in zip(twin, plain, twin._fields):
        assert torch.equal(x, y), f
    assert (twin.m != m0).any()


def _family(I=3, n=40, R=4, seed=0):
    """I Gaussian SK instances (f32, their own coupling sets thinned to
    differ) with states, fields and the slot betas of an EnsemblePT."""
    probs = []
    rng = np.random.default_rng(seed)
    for i in range(I):
        p = random_sk(n, seed=seed + i, h_scale=0.3)
        keep = np.triu(rng.random((n, n)) < 0.7, 1)
        keep = keep | keep.T
        probs.append(IsingProblem(np.asarray(p.J) * keep, p.h))
    ens = EnsemblePT(probs, np.geomspace(0.3, 2.0, R),
                     EnsembleConfig(num_replicas=R, block_size=16),
                     device="cpu")
    st = ens.init_state(torch.Generator().manual_seed(seed))
    phi = ens.h[:, None, :] + torch.bmm(st.m, ens.J_full)
    return ens, st.m, phi


def test_union_twin_equals_per_instance_twins():
    ens, m, phi = _family()
    I, R, n_pad = m.shape
    T = 4
    u = torch.rand((T, I, R, n_pad), generator=torch.Generator().manual_seed(2))
    beta = torch.linspace(0.5, 1.5, T)
    beta_row = torch.rand((I, R), generator=torch.Generator().manual_seed(3))
    mask = ens.active.expand(I, R, n_pad)
    union = sc.sequential_sweeps_reference(
        ens.sweep_nbrs, ens.J_diag, ens.h, m, phi, None, beta, beta_row,
        mask, num_sweeps=T, uniforms=u, record_m=True)
    for i in range(I):
        own = sc.sequential_sweeps_reference(
            sc.sequential_neighbors(ens.J_rows[i]), ens.J_diag[i:i + 1],
            ens.h[i:i + 1], m[i:i + 1], phi[i:i + 1], None, beta,
            beta_row[i:i + 1], mask[i:i + 1], num_sweeps=T,
            uniforms=u[:, i:i + 1].contiguous(), record_m=True)
        for x, y, f in zip(union, own, union._fields):
            assert torch.equal(x[i], y[0]), (i, f)
    assert ens.sweep_nbrs.w.shape[0] == I
    # the union holds a coupling some instance lacks, with weight 0 there
    assert bool((ens.sweep_nbrs.w == 0).any())


@pytest.mark.parametrize("draws", ["uniforms", "generator"])
def test_batched_cpu_is_the_per_instance_calls(draws):
    ens, m, phi = _family(seed=4)
    I, R, n_pad = m.shape
    T = 3
    beta_slot = torch.rand((I, R, 1), generator=torch.Generator().manual_seed(6))
    args = (ens.J_rows, ens.J_diag, ens.h, m, phi)
    u = (torch.rand((T, I, R, n_pad), generator=torch.Generator().manual_seed(7))
         if draws == "uniforms" else None)
    gen = torch.Generator().manual_seed(8) if u is None else None
    before = (sc.sequential_sweeps.launches,
              sc.sequential_sweeps_batched.launches)
    bat = sc.sequential_sweeps_batched(
        *args, gen, torch.ones(T), beta_slot, ens.active, num_sweeps=T,
        uniforms=u, nbrs=ens.sweep_nbrs, record_m=True)
    gen = torch.Generator().manual_seed(8) if u is None else None
    for i in range(I):
        one = sc.sequential_sweeps(
            ens.J_rows[i], ens.J_diag[i], ens.h[i], m[i], phi[i], gen,
            torch.ones(T), beta_slot[i], ens.active.expand(R, n_pad),
            num_sweeps=T, record_m=True,
            uniforms=None if u is None else u[:, i])
        for x, y, f in zip(bat, one, bat._fields):
            assert torch.equal(x[i], y), (i, f)
    assert bat.energies.shape == (I, T, R) and bat.M.shape == (I, T, R, n_pad)
    assert (sc.sequential_sweeps.launches,
            sc.sequential_sweeps_batched.launches) == before
    with pytest.raises(ValueError, match="seeds"):
        sc.sequential_sweeps_batched(
            *args, None, torch.ones(T), beta_slot, ens.active, num_sweeps=T,
            seeds=torch.zeros((I, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="cuda or cpu"):
        sc.sequential_sweeps_batched(
            *(x.to("meta") for x in args), None, torch.ones(T, device="meta"),
            beta_slot.to("meta"), ens.active.to("meta"), num_sweeps=T)


@pytest.mark.parametrize("I,R,n_pad,B,sms,want", [
    (100, 64, 1024, 128, 132, (16, 2)),   # EnsemblePT, SK-1000 x 64
    (1, 64, 1024, 128, 132, (1, 2)),      # one instance, R = 64
    (1, 320, 128, 128, 132, (4, 2)),      # the contrived ICM round
    (1, 256, 512, 128, 132, (2, 2)),      # uncoloured chimera 8x8
    (1, 32, 32768, 128, 132, (1, 1)),     # the int16 layout's limit
    (4, 64, 8192, 128, 132, (2, 2)),
    (1, 64, 24576, 128, 132, (1, 1)),
    (1, 6, 48, 16, 132, (1, 2)),          # small blocks
])
def test_sequential_launch_rule(I, R, n_pad, B, sms, want):
    assert sc.sequential_launch(I, R, n_pad, B, sms) == want
    P, n_buf = want
    assert sc._seq_shared_bytes(n_pad, B, P, n_buf) <= sc.MAX_SHARED_BYTES
    if n_buf == 1:
        assert sc._seq_shared_bytes(n_pad, B, P, 2) > sc.MAX_SHARED_BYTES


def test_kernel_limit_and_the_routes_past_it():
    """Blocks above SEQ_MAX_BLOCK run in sub-blocks, so only n_pad limits
    the kernel; the engine and EnsemblePT take the kernel's route at any
    block size (on a CUDA device a layout past the limit raises at
    setup)."""
    assert sc.sequential_kernel_limit(1024, 128) is None
    assert sc.sequential_kernel_limit(32768, 128) is None
    assert sc.sequential_kernel_limit(1024, 256) is None
    assert "int16" in sc.sequential_kernel_limit(40960, 128)
    with pytest.raises(ValueError, match="int16"):
        sc.sequential_launch(1, 8, 40960, 128, 132)
    assert (sc.sequential_launch(1, 8, 1024, 256, 132)
            == sc.sequential_launch(1, 8, 1024, 128, 132))
    prob = random_sk(300, seed=1)
    big = SweepEngine(prob, block_size=256, device="cpu")
    assert big.sweep_kernel == "sequential_sweeps"
    assert big.sweep_nbrs.block_size == 128
    ens = EnsemblePT([prob, random_sk(300, seed=2)], [0.5, 1.0],
                     EnsembleConfig(num_replicas=2, block_size=256),
                     device="cpu")
    assert ens.sweep_kernel == "sequential_sweeps_batched"
    assert ens.sweep_nbrs.block_size == 128
    st = ens.run(ens.init_state(torch.Generator().manual_seed(0)), 1)
    assert np.isfinite(ens.best_energies(st)).all()


@pytest.mark.parametrize("B,want", [(256, 128), (192, 96), (130, 65),
                                    (128, 128), (64, 64), (131, 1)])
def test_sequential_block_is_the_largest_divisor_in_reach(B, want):
    assert sc.sequential_block(B) == want


@pytest.mark.parametrize("pm", [True, False])
def test_sub_blocks_are_the_same_sweep(pm):
    """A layout in blocks of 256 runs in sub-blocks of 128: the sub-blocks'
    diagonal tiles are J's, and the twin over them follows run_sweeps at
    block size 256 in f64 (states equal; phi and energies bit for bit on
    +-J, within 1e-10 on Gaussian couplings)."""
    prob = _pm_sk(300, 2) if pm else random_sk(300, seed=2, h_scale=0.3)
    b = j_block_problem(JProblem(np.asarray(prob.J), np.asarray(prob.h)),
                        block_size=256, dtype=np.float64)
    J_rows, J_diag = t64(b.J_rows), t64(b.J_diag)
    rows, tiles = sc._sub_blocks(J_rows, J_diag)
    assert rows.shape == (4, 128, b.n_pad) and tiles.shape == (4, 128, 128)
    for k in range(4):
        assert torch.equal(tiles[k], rows[k][:, 128 * k:128 * (k + 1)])
    nbrs = sc.sequential_neighbors(J_rows)
    assert nbrs.block_size == 128 and nbrs.tgt_ptr.shape == (5,)
    R, T = 3, 2
    rng = np.random.default_rng(4)
    m0 = np.where(rng.random((R, b.n_pad)) < 0.5, -1.0, 1.0)
    m0[:, ~b.active] = 1.0
    phi0 = t64(m0 @ b.J_rows.reshape(b.n_pad, b.n_pad) + b.h)
    m0 = t64(m0)
    u = t64(rng.random((T, R, b.n_pad)))
    beta = t64(np.linspace(0.5, 1.5, T))
    mask = torch.as_tensor(b.active).expand(R, b.n_pad)
    plain = run_sweeps(J_rows, J_diag, t64(b.h), m0, phi0, None, beta,
                       torch.ones(()), mask, num_sweeps=T,
                       within_block="sequential", uniforms=u, record_m=True)
    twin = _one(sc.sequential_sweeps_reference(
        nbrs, J_diag[None], t64(b.h)[None], m0[None], phi0[None], None,
        beta, torch.ones((1, R), dtype=torch.float64), mask[None],
        num_sweeps=T, uniforms=u[:, None], record_m=True))
    for x in ("m", "M", "m_best"):
        assert torch.equal(getattr(twin, x), getattr(plain, x)), x
    for x in ("phi", "energies", "e_best"):
        if pm:
            assert torch.equal(getattr(twin, x), getattr(plain, x)), x
        else:
            torch.testing.assert_close(getattr(twin, x), getattr(plain, x),
                                       rtol=0, atol=1e-10)
    assert (twin.m != m0).any()


def _runs_chain(tile, next_coupled, x, m, beta, u, cand):
    """The kernel's in-block chain over one block (a plain model of
    csrc/sequential_sweeps.cu's chain_block): each round evaluates the
    remaining spins from corr and keeps their flips in spin order while
    they lie before stop, the first spin coupled to a kept flip (byte s of
    next_coupled[l]: spin kS l + s's), applying them to corr. Returns (the
    block's new m, rounds that flipped)."""
    B = len(x)
    kS = -(-B // 32)
    nxt = [(int(next_coupled[k // kS]) >> (8 * (k % kS))) & 0xff
           for k in range(B)]
    corr = np.zeros(B)
    m = m.copy()
    pos, rounds = -1, 0
    while pos + 1 < B:
        ev = [k for k in range(pos + 1, B) if cand[k]]
        fl = [k for k in ev
              if (1.0 if u[k] < 0.5 * (1 + np.tanh(beta * (x[k] + corr[k])))
                  else -1.0) != m[k]]
        if not fl:
            break
        rounds += 1
        stop = B
        for k in fl:
            if k >= stop:
                break
            corr += -2.0 * m[k] * tile[k]
            m[k] = -m[k]
            stop = min(stop, nxt[k])
        pos = stop - 1
    return m, rounds


@pytest.mark.parametrize("name,B", [("chimera", 128), ("chimera", 48),
                                    ("sk", 64)])
def test_chain_runs_are_the_spin_by_spin_chain(name, B):
    """Each spin's next coupled spin (`next_coupled`) and the rule by which
    a round keeps a run of flips: the plain model of the kernel's chain
    (`_runs_chain`) over each block of a layout gives the spin-by-spin
    chain's states on uncoloured Gaussian chimera 4x4 and Gaussian SK
    (f64, 20 draws a block), in fewer flipping rounds than flips on the
    chimera and one a flip on the SK (every pair coupled)."""
    prob = (chimera_graph(4, 4, seed=3, pm=False) if name == "chimera"
            else random_sk(128, seed=3))
    b = j_block_problem(JProblem(np.asarray(prob.J), np.asarray(prob.h)),
                        block_size=B, dtype=np.float64)
    nbrs = sc.sequential_neighbors(t64(b.J_rows))
    assert nbrs.next_coupled.shape == (b.num_blocks, 32)
    kS = -(-B // 32)
    for blk in range(b.num_blocks):
        for k in range(B):
            word = int(nbrs.next_coupled[blk, k // kS])
            got = (word >> (8 * (k % kS))) & 0xff
            after = np.nonzero(b.J_diag[blk][k, k + 1:])[0]
            assert got == (k + 1 + after[0] if after.size else B), (blk, k)
    rng = np.random.default_rng(B)
    rounds = flips = 0
    for blk in range(b.num_blocks):
        tile = b.J_diag[blk]
        for _ in range(20):
            m = np.where(rng.random(B) < 0.5, -1.0, 1.0)
            x = rng.normal(size=B)
            u = rng.random(B)
            cand = rng.random(B) < 0.9
            beta = rng.choice([0.3, 1.0, 3.0])
            want, corr = m.copy(), np.zeros(B)
            for k in range(B):
                if not cand[k]:
                    continue
                nw = (1.0 if u[k] < 0.5 * (1 + np.tanh(beta * (x[k]
                                                                + corr[k])))
                      else -1.0)
                if nw != want[k]:
                    corr += (nw - want[k]) * tile[k]
                    want[k] = nw
            got, r = _runs_chain(tile, nbrs.next_coupled[blk].numpy(), x, m,
                                 beta, u, cand)
            np.testing.assert_array_equal(got, want)
            rounds += r
            flips += int((want != m).sum())
    assert flips > 0
    assert (rounds < flips) == (name == "chimera")
