"""nmc_tpu_torch.parallel.SpinShardedSweeper against the JAX package's.

The JAX sweeper runs on a 1-device and on a 4-device 'spin' mesh (J and
phi column-sharded; its trajectory does not depend on the spin mesh), the
port at world size 1 on the CPU from the JAX initial state (carried over
with `interop.spin_sharded_state_from_numpy`), with the JAX draws
replayed: the per-block uniforms (`torch_parity.spin_sharded_replay`)
and the label swaps' Gumbels and uniforms (`label_swap_draws`). A run
chains plain sweeps, an annealed run under a spin mask, sweeps with a
per-replica beta and two `swap_round`s; after each, m, phi, the energies
and the label maps are equal (tolerance 0: +-J couplings, so every
float32 sum is exact). The multi-rank runs (spin axis, 2-D grid) are in
tests/test_torch_distributed.py.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from nmc_tpu.io.generators import ea_2d
from nmc_tpu.parallel.spin_sharded import SpinShardedConfig as JConfig
from nmc_tpu.parallel.spin_sharded import SpinShardedState as JState
from nmc_tpu.parallel.spin_sharded import SpinShardedSweeper as JSweeper
from nmc_tpu_torch import interop
from nmc_tpu_torch.core.problem import IsingProblem
from nmc_tpu_torch.parallel import (SpinShardedConfig, SpinShardedState,
                                    SpinShardedSweeper)
from nmc_tpu_torch.parallel.spin_sharded import _pad_blocked

from torch_parity import label_swap_draws, spin_sharded_replay

R, B = 8, 8
LADDER = np.geomspace(0.3, 3.0, R)


def assert_same(js, ts, je=None, te=None):
    np.testing.assert_array_equal(ts.m.numpy(), np.asarray(js.m))
    np.testing.assert_array_equal(ts.phi.numpy(), np.asarray(js.phi))
    np.testing.assert_array_equal(ts.beta_to_slot.numpy(),
                                  np.asarray(js.beta_to_slot))
    np.testing.assert_array_equal(ts.slot_to_beta.numpy(),
                                  np.asarray(js.slot_to_beta))
    assert ts.step == int(js.step)
    if je is not None:
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))


@pytest.mark.parametrize("n_dev", [1, 4])
def test_sweeps_and_swap_rounds_match_jax(n_dev):
    prob = ea_2d(8, seed=1)
    jsw = JSweeper(prob, JConfig(block_size=B),
                   mesh=Mesh(np.array(jax.devices()[:n_dev]), ("spin",)))
    tsw = SpinShardedSweeper(IsingProblem(prob.J, prob.h),
                             SpinShardedConfig(block_size=B), device="cpu")
    assert tsw.n_pad == jsw.n_pad and tsw.nB_real == jsw.nB
    js = jsw.init_state(jax.random.PRNGKey(2), R)
    ts = interop.spin_sharded_state_from_numpy(js, torch.Generator(),
                                               device="cpu")
    assert_same(js, ts)

    def replay(js, T):
        return spin_sharded_replay(js.key, int(js.step), T, tsw.nB_real, R, B)

    # plain sweeps
    u = replay(js, 3)
    js, je = jsw.sweeps(js, 3, 1.0)
    ts, te = tsw.sweeps(ts, 3, 1.0, uniforms=u)
    assert_same(js, ts, je, te)
    # annealed, under a spin mask
    mask = np.random.default_rng(0).random(jsw.n_pad) < 0.7
    u = replay(js, 4)
    js, je = jsw.sweeps(js, 4, 2.0, anneal=True, initial_beta=0.5,
                        update_mask=mask)
    ts, te = tsw.sweeps(ts, 4, 2.0, anneal=True, initial_beta=0.5,
                        update_mask=torch.as_tensor(mask), uniforms=u)
    assert_same(js, ts, je, te)
    # a per-replica ladder
    u = replay(js, 2)
    js, je = jsw.sweeps(js, 2, 1.0, beta_replica=LADDER)
    ts, te = tsw.sweeps(ts, 2, 1.0, beta_replica=LADDER, uniforms=u)
    assert_same(js, ts, je, te)
    # two swap rounds: sweeps at the slots' betas, then the label swap
    for _ in range(2):
        u = replay(js, 3)
        key, k_swap = jax.random.split(js.key)
        g, su = label_swap_draws(jax.random.fold_in(k_swap, int(js.step) + 3),
                                 R, 2)
        js, je = jsw.swap_round(js, 3, LADDER, num_swapping_pairs=2)
        ts, te = tsw.swap_round(ts, 3, LADDER, num_swapping_pairs=2,
                                uniforms=u, gumbels=g, swap_uniforms=su)
        assert_same(js, ts, je, te)
    assert not torch.equal(ts.beta_to_slot, torch.arange(R))
    np.testing.assert_array_equal(tsw.states(ts), jsw.states(js))
    for m, e in zip(tsw.states(ts), te.tolist()):
        assert prob.energy(m) == e


def test_generator_draws_give_valid_moves():
    """Without injected uniforms the port draws from its generator: the
    energies are those of the states it returns."""
    prob = ea_2d(6, seed=3)
    tsw = SpinShardedSweeper(IsingProblem(prob.J, prob.h),
                             SpinShardedConfig(block_size=B), device="cpu")
    ts = tsw.init_state(torch.Generator().manual_seed(0), R)
    ts, te = tsw.sweeps(ts, 5, 2.0)
    for m, e in zip(tsw.states(ts), te.tolist()):
        assert prob.energy(m) == e
    ts, e_all = tsw.swap_round(ts, 2, LADDER, num_swapping_pairs=2)
    assert sorted(ts.beta_to_slot.tolist()) == list(range(R))
    np.testing.assert_array_equal(
        ts.slot_to_beta.numpy()[ts.beta_to_slot.numpy()], np.arange(R))


def test_pad_blocked_matches_jax():
    """Filler blocks: the port's `_pad_blocked` gives JAX's layout."""
    from nmc_tpu.ops.coloring import color_groups as j_color_groups
    from nmc_tpu.parallel.spin_sharded import _pad_blocked as j_pad
    from nmc_tpu_torch.ops.coloring import color_groups
    prob = ea_2d(6, seed=1)
    tp = IsingProblem(prob.J, prob.h)
    a = _pad_blocked(tp, B, color_groups(tp.J), np.float32, extra_blocks=2)
    b = j_pad(prob, B, j_color_groups(prob.J), np.float32, extra_blocks=2)
    for f in ("J_rows", "J_diag", "h", "active", "perm", "inv_perm"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert a.n == b.n and a.colored and a.n_pad == b.n_pad


def test_fields_match_jax():
    assert set(SpinShardedState._fields) == (set(JState._fields) - {"key"}) \
        | {"generator"}
    assert set(JConfig.__dataclass_fields__) - {"precision"} == \
        set(SpinShardedConfig.__dataclass_fields__)
