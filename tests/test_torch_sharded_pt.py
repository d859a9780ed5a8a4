"""nmc_tpu_torch.parallel.ShardedNPT against nmc_tpu.parallel.ShardedNPT.

The JAX engine runs on a 1-device and on a 4-device 'replica' mesh; the
port runs at world size 1 on the CPU from the same initial state (carried
over with `interop.sharded_pt_state_from_numpy`) and replays the JAX
engine's draws (tests/torch_parity.sharded_npt_replay: the label swaps'
Gumbels and uniforms; the phase uniforms of every device's key, stacked
over the ladder). Compared after the rounds: m, the label maps,
do_nmc_slot, the backbone masks of the NMC slots (the port solves LBP for
NMC slots only and leaves the other slots' masks empty, which no phase
reads), e_best, the last round's slot energies, and m_best through its
energy.

  * kernel route, f32: the port's K4 (its plain twin on the CPU) fed zero
    uniforms against JAX's round_kernel="on" (the Pallas kernel in
    interpret mode, whose PRNG gives zeros), R = 8 per device (JAX's
    sublane gate). lbp_tolerance is 1e-4, far above the f32 LBP
    relative-change plateau, as in tests/test_torch_ensemble_nmc.py.
    Exact (tolerance 0) on +-J couplings. With zero uniforms a spin turns
    -1 only where f32 tanh(beta * phi) is -1, which XLA reaches from
    |beta * phi| ~ 7.9 and torch from ~ 9.0, so the ladder and global_beta
    keep beta * k (k = 1..4, the fields of ea_2d) out of [7.8, 9.1];
  * phase route, f64: the C / NC / ALL phases through the port's sweep
    engine (K1's plain twin on a coloured layout, `run_sweeps` for the
    uncoloured sequential sweep) against JAX's XLA phases. The +-J
    coloured layout is exact; the Gaussian SK layout compares e_best and
    the slot energies within 1e-10 (the fields' f64 products associate
    differently).
Each LBP mode (dense, sparse, planes) runs on both routes on the 1-device
mesh, and one mode of each route on the 4-device mesh (the modes share the
round; the mesh changes only the keys).

Also here, the kernels' plain twins with the sharding offsets: each sweep
wrapper (K1, K2, K3, the sequential route) and each round wrapper (K4, K5;
replica and instance halves) run on two halves of its rows with their
offsets equals the whole launch bit for bit (the CPU draws the whole
ensemble's uniforms and keeps the slice's), as `chip_smoke.py`
sharded_offsets checks the kernels on the card.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from nmc_tpu.io.generators import ea_2d, random_sk
from nmc_tpu.parallel.sharded_pt import ShardedNPT as JShardedNPT
from nmc_tpu.parallel.sharded_pt import ShardedNPTConfig as JConfig
from nmc_tpu.parallel.sharded_pt import ShardedPTState as JState
from nmc_tpu_torch import interop
from nmc_tpu_torch.core.problem import IsingProblem
from nmc_tpu_torch.parallel import (RoundMetrics, ShardedNPT,
                                    ShardedNPTConfig, ShardedPTState)

from torch_parity import sharded_npt_replay

ROUNDS = 3


def safe_ladder(R):
    """R betas from 0.3 to 6 with no beta * k (k = 1..4) in [7.8, 9.1]."""
    c = [b for b in np.geomspace(0.3, 6.0, 400)
         if not any(7.8 <= b * k <= 9.1 for k in (1, 2, 3, 4))]
    return np.asarray(c)[np.linspace(0, len(c) - 1, R).round().astype(int)]


def config(**kw):
    base = dict(sweeps_per_phase=3, num_cycles=2, full_update_frequency=2,
                num_swapping_pairs=2, block_size=16, global_beta=2.5,
                lbp_max_iterations=30, lbp_tolerance=1e-4, lbp_every=2,
                lambda_reduction_factor=0.25)
    base.update(kw)
    return base


def run_both(prob, R, kw, n_dev, *, plain, dtype):
    beta = safe_ladder(R)
    doNMC = [False] * (R - 2) + [True] * 2
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("replica",))
    jnpt = JShardedNPT(prob, beta, doNMC, JConfig(**kw), mesh=mesh)
    tnpt = ShardedNPT(IsingProblem(prob.J, prob.h), beta, doNMC,
                      ShardedNPTConfig(**kw), device="cpu")
    assert jnpt._use_round_kernel != plain
    assert tnpt.round_path == ("phases" if plain else "K4")
    js0 = jnpt.init_state(jax.random.PRNGKey(0))
    ts0 = interop.sharded_pt_state_from_numpy(js0, torch.Generator(),
                                              dtype=dtype, device="cpu")
    js, jm = jnpt.run(js0, ROUNDS)
    draws = sharded_npt_replay(js0.key, tnpt.cfg, R, tnpt.n_pad, n_dev,
                               plain=plain,
                               dtype=np.dtype(str(dtype).split(".")[-1]))
    ts, tm = tnpt.run(ts0, ROUNDS, draws=draws)
    return js, jm, ts, tm, tnpt


def assert_match(js, jm, ts, tm, tnpt, prob, atol, backbone=True):
    for f in ("m", "beta_to_slot", "slot_to_beta", "do_nmc_slot"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    dn = ts.do_nmc_slot.numpy()
    np.testing.assert_array_equal(ts.cl.numpy()[dn], np.asarray(js.cl)[dn])
    assert not ts.cl.numpy()[~dn].any()
    if backbone:   # the masks hold spins (and leave some out)
        assert ts.cl.numpy()[dn].any() and (~ts.cl.numpy()[dn]).any()
    np.testing.assert_allclose(ts.e_best.numpy(), np.asarray(js.e_best),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(tm.slot_energies.numpy(),
                               np.asarray(jm.slot_energies), rtol=0,
                               atol=atol)
    np.testing.assert_array_equal(tm.accepted.numpy(),
                                  np.asarray(jm.accepted))
    inv = np.asarray(tnpt.blocked.inv_perm)
    for r in range(ts.m_best.shape[0]):
        assert abs(prob.energy(ts.m_best[r].numpy()[inv])
                   - float(ts.e_best[r])) <= 1e-4
    e, m = tnpt.best(ts)
    assert e == float(ts.e_best.min()) and abs(prob.energy(m) - e) <= 1e-4
    assert ts.round_index == ROUNDS
    assert not torch.equal(ts.beta_to_slot, torch.arange(len(dn)))


@pytest.mark.parametrize("lbp_mode,n_dev", [("dense", 1), ("sparse", 1),
                                            ("planes", 1), ("dense", 4)])
def test_kernel_route_matches_jax(lbp_mode, n_dev):
    prob = ea_2d(6, seed=2).normalized()[0]
    kw = config(lbp_mode=lbp_mode, use_coloring=True, dtype="float32",
                round_kernel="on")
    out = run_both(prob, 8 * n_dev, kw, n_dev, plain=False,
                   dtype=torch.float32)
    assert (out[-1].edge_slots is not None) == (lbp_mode == "planes")
    assert (out[-1].edge_graph is not None) == (lbp_mode == "sparse")
    assert_match(*out, prob, atol=0)


@pytest.mark.parametrize("lbp_mode,n_dev", [("dense", 1), ("sparse", 1),
                                            ("planes", 1), ("planes", 4)])
def test_phase_route_matches_jax_colored(lbp_mode, n_dev):
    prob = ea_2d(6, seed=3).normalized()[0]
    kw = config(lbp_mode=lbp_mode, use_coloring=True, dtype="float64",
                round_kernel="off", lbp_tolerance=1e-7)
    out = run_both(prob, 8, kw, n_dev, plain=True, dtype=torch.float64)
    assert out[-1].engine.sweep_kernel == "colored_sweeps"
    assert_match(*out, prob, atol=0)


@pytest.mark.parametrize("n_dev", [1, 4])
def test_phase_route_matches_jax_sequential(n_dev):
    prob = random_sk(16, seed=1).normalized()[0]
    kw = config(lbp_mode="dense", block_size=8, dtype="float64",
                lbp_tolerance=1e-7)
    out = run_both(prob, 8, kw, n_dev, plain=True, dtype=torch.float64)
    assert out[-1].engine.sweep_kernel is None       # f64: run_sweeps
    # SK at global_beta 2.5 has no backbone at the shipped thresholds
    assert_match(*out, prob, atol=1e-10, backbone=False)


def test_state_and_metrics_fields_match_jax():
    assert set(ShardedPTState._fields) == (set(JState._fields) - {"key"}) \
        | {"generator"}
    from nmc_tpu.parallel.sharded_pt import RoundMetrics as JMetrics
    assert RoundMetrics._fields == JMetrics._fields
    assert set(JConfig.__dataclass_fields__) - {"precision"} == \
        set(ShardedNPTConfig.__dataclass_fields__)


def test_replicas_that_do_not_divide_raise(monkeypatch):
    from nmc_tpu_torch.parallel import distributed
    monkeypatch.setattr(distributed, "group_shape", lambda group=None: (3, 0))
    prob = random_sk(8, seed=0)
    with pytest.raises(ValueError, match="must divide over 3 ranks"):
        ShardedNPT(IsingProblem(prob.J, prob.h), np.ones(4), [False] * 4,
                   ShardedNPTConfig(block_size=8), device="cpu")


def test_uncoloured_jacobi_phase_route_has_no_sweep_kernel():
    """The layout ShardedNPT refuses on a card (its phases must take a
    kernel there): an uncoloured block-Jacobi sweep, whose engine has no
    sweep kernel and runs the plain sweeps on the CPU."""
    prob = random_sk(16, seed=1).normalized()[0]
    npt = ShardedNPT(IsingProblem(prob.J, prob.h), np.ones(4), [False] * 4,
                     ShardedNPTConfig(block_size=8, within_block="jacobi"),
                     device="cpu")
    assert npt.round_path == "phases" and npt.engine.sweep_kernel is None



def _halves(call, n_rows):
    """(whole launch, its two halves), each from a generator seeded alike;
    call(lo, hi, offset) runs rows [lo, hi), offset None = unsliced."""
    h = n_rows // 2
    return call(0, n_rows, None), [call(0, h, 0), call(h, n_rows, h)]


@pytest.mark.parametrize("name", ["colored_sweeps", "colored_sweeps_streamed",
                                  "colored_sweeps_sparse",
                                  "sequential_sweeps"])
def test_plain_twins_slice_the_whole_ladders_draws(name):
    """On the CPU a sweep wrapper given a replica offset and the ladder's
    size draws the whole ladder's uniforms, sweep by sweep as the whole
    launch does, and keeps its rows: two halves equal the whole launch,
    and a half launched without its offset does not."""
    from nmc_tpu_torch.core.problem import block_sparse_tiles
    from nmc_tpu_torch.ops import sweeps_cuda as sc
    from nmc_tpu_torch.ops.engine import SweepEngine
    prob = ea_2d(6, seed=4).normalized()[0]
    eng = SweepEngine(IsingProblem(prob.J, prob.h), block_size=8,
                      use_coloring=name != "sequential_sweeps",
                      dtype=torch.float64, device="cpu")
    R, T = 8, 3
    m0 = eng.init_states(torch.Generator().manual_seed(1), R)
    phi0 = eng.fields(m0)
    beta = torch.linspace(0.3, 2.0, R, dtype=torch.float64)
    mask = eng.active.expand(R, eng.n_pad)
    col_idx, J_tiles = (torch.as_tensor(x) for x in
                        block_sparse_tiles(eng.blocked))

    def call(lo, hi, off):
        kw = dict(num_sweeps=T)
        if off is not None:
            kw.update(replica_offset=off, replicas_total=R)
        a = (m0[lo:hi], phi0[lo:hi], torch.Generator().manual_seed(9),
             torch.ones(T, dtype=torch.float64))
        if name == "colored_sweeps":
            return sc.colored_sweeps(eng.J_full, eng.h, *a, beta[lo:hi, None],
                                     mask[lo:hi], block_size=8, **kw)
        if name == "colored_sweeps_streamed":
            return sc.colored_sweeps_streamed(eng.J_rows, eng.h, *a,
                                              beta[lo:hi], mask[lo:hi], **kw)
        if name == "colored_sweeps_sparse":
            return sc.colored_sweeps_sparse(col_idx, J_tiles, eng.h, *a,
                                            beta[lo:hi], mask[lo:hi], **kw)
        return sc.sequential_sweeps(eng.J_rows, eng.J_diag, eng.h, *a,
                                    beta[lo:hi, None], mask[lo:hi], **kw)

    whole, parts = _halves(call, R)
    for f in ("m", "phi", "m_best", "e_best"):
        assert torch.equal(getattr(whole, f),
                           torch.cat([getattr(p, f) for p in parts])), f
    assert torch.equal(whole.energies,
                       torch.cat([p.energies for p in parts], 1))
    assert not torch.equal(call(R // 2, R, None).m, whole.m[R // 2:])


def _dense_tiles(J_full, B):
    """(col_idx [nB, nB], J_tiles [I, nB, nB, B, B]): every column tile of
    every row block, a valid (zero-padded) K5 tile layout."""
    I, n, _ = J_full.shape
    nB = n // B
    tiles = J_full.reshape(I, nB, B, nB, B).permute(0, 1, 3, 2, 4)
    col_idx = torch.arange(nB, dtype=torch.int32).expand(nB, nB)
    return col_idx.contiguous(), tiles.contiguous()


@pytest.mark.parametrize("axis", ["replica", "instance"])
@pytest.mark.parametrize("sparse", [False, True])
def test_round_twins_slice_the_whole_ensembles_draws(axis, sparse):
    """K4's and K5's plain twins with a replica or an instance offset and
    the totals: two halves equal the whole launch."""
    from nmc_tpu_torch.ops import round_cuda as rc
    from nmc_tpu_torch.parallel import EnsembleNMC
    probs = [ea_2d(4, seed=s).normalized()[0] for s in range(4)]
    ens = EnsembleNMC([IsingProblem(p.J, p.h) for p in probs],
                      np.linspace(0.4, 2.5, 8), [False] * 6 + [True] * 2,
                      ShardedNPTConfig(block_size=8, use_coloring=True),
                      device="cpu")
    st = ens.init_state(torch.Generator().manual_seed(2))
    I, R, _ = st.m.shape
    cl = torch.rand(st.m.shape,
                    generator=torch.Generator().manual_seed(3)) < 0.5
    beta = ens.beta_list[st.slot_to_beta]
    col_idx, J_tiles = _dense_tiles(ens.J_full, 8)

    def call(lo, hi, off):
        sel = ((slice(lo, hi), slice(None)) if axis == "instance"
               else (slice(None), slice(lo, hi)))
        kw = dict(num_cycles=1, sweeps_per_phase=2)
        if off is not None:
            kw.update({f"{axis}_offset": off,
                       f"{axis}s_total": I if axis == "instance" else R})
        ii = sel[0]
        args = (ens.h[ii], ens.active, st.m[sel], cl[sel],
                st.do_nmc_slot[sel], beta[sel],
                torch.Generator().manual_seed(4))
        if sparse:
            return rc.ensemble_round_sparse(col_idx, J_tiles[ii], *args, **kw)
        return rc.ensemble_round(ens.J_full[ii], *args, block_size=8, **kw)

    whole, parts = _halves(call, I if axis == "instance" else R)
    dim = 0 if axis == "instance" else 1
    for f in whole._fields:
        assert torch.equal(getattr(whole, f),
                           torch.cat([getattr(p, f) for p in parts], dim)), f
