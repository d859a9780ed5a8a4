"""nmc_tpu_torch.parallel.EnsemblePT against nmc_tpu.parallel.EnsemblePT.

Both start from the JAX engine's initial state and run rounds of
sequential sweeps, label swaps and best folds; the port replays the JAX
engine's draws from its state key (per round and instance
fold_in(fold_in(key, round), i), split into the sweep key, whose uniforms
`jax_sweep_uniforms` rebuilds, and the swap key, whose Gumbels and
acceptance uniforms are rebuilt here). In f64 (the plain route) the
states, label maps and best states are equal after the rounds and the
best energies within 1e-10. In f32 the port takes the sequential route
(its plain twin on the CPU), one batched wrapper call a round for every
instance. The JAX engine runs on a one-device mesh.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from nmc_tpu.io.generators import random_sk
from nmc_tpu.parallel import EnsembleConfig as JConfig
from nmc_tpu.parallel import EnsemblePT as JEnsemble
from nmc_tpu_torch.core.problem import IsingProblem
from nmc_tpu_torch.parallel import (EnsembleConfig, EnsemblePT,
                                    EnsembleState, RoundDraws)
from nmc_tpu_torch.parallel import ensemble as tens

from torch_parity import jax_sweep_uniforms

BETA = np.array([0.2, 0.45, 0.8, 1.3, 2.1])
I, N = 3, 14


def _problems():
    return [random_sk(N, seed=s, h_scale=0.3).normalized()[0]
            for s in range(I)]


def _mesh():
    return Mesh(np.array(jax.devices()[:1]), ("instance",))


def replay(key, cfg, R, n_pad):
    """`draws(round_index)` for EnsemblePT.run from the JAX state key."""
    def draws(round_index):
        sweeps, gumbels, uniforms = [], [], []
        for i in range(I):
            k = jax.random.fold_in(jax.random.fold_in(key, round_index), i)
            k_sweep, k_swap = jax.random.split(k)
            sweeps.append(jax_sweep_uniforms(k_sweep, cfg.sweeps_per_round,
                                             R, n_pad))
            k_sel, k_acc = jax.random.split(k_swap)
            gumbels.append(np.stack([
                np.asarray(jax.random.gumbel(kk, (R - 1,)))
                for kk in jax.random.split(k_sel, cfg.num_swapping_pairs)]))
            uniforms.append(np.asarray(jax.random.uniform(
                k_acc, (cfg.num_swapping_pairs,))))
        return RoundDraws(
            sweep_uniforms=torch.as_tensor(np.stack(sweeps, axis=1))[None],
            gumbels=torch.as_tensor(np.stack(gumbels)),
            swap_uniforms=torch.as_tensor(np.stack(uniforms)))
    return draws


@pytest.mark.parametrize("rounds,pairs", [(3, 2), (2, 1)])
def test_ensemble_pt_matches_jax_f64(rounds, pairs):
    probs = _problems()
    jcfg = JConfig(num_replicas=len(BETA), sweeps_per_round=6,
                   num_swapping_pairs=pairs, block_size=8, dtype="float64")
    jens = JEnsemble(probs, BETA, jcfg, mesh=_mesh())
    key = jax.random.PRNGKey(11)
    js = jens.init_state(key)
    cfg = EnsembleConfig(num_replicas=len(BETA), sweeps_per_round=6,
                         num_swapping_pairs=pairs, block_size=8,
                         dtype="float64")
    ens = EnsemblePT([IsingProblem(p.J, p.h) for p in probs], BETA, cfg,
                     device="cpu")
    assert ens.sweep_kernel is None and ens.n_pad == jens.n_pad
    st = ens.init_state(torch.Generator().manual_seed(0))
    st = st._replace(m=torch.as_tensor(np.array(js.m)))
    draws = replay(js.key, cfg, len(BETA), ens.n_pad)
    js = jens.run(js, rounds)
    st = ens.run(st, rounds, draws=draws)
    assert st.round_index == rounds
    np.testing.assert_array_equal(st.m.numpy(), np.asarray(js.m))
    np.testing.assert_array_equal(st.beta_to_slot.numpy(),
                                  np.asarray(js.beta_to_slot))
    np.testing.assert_array_equal(st.slot_to_beta.numpy(),
                                  np.asarray(js.slot_to_beta))
    np.testing.assert_allclose(ens.best_energies(st),
                               np.asarray(jens.best_energies(js)), rtol=0,
                               atol=1e-10)
    np.testing.assert_array_equal(ens.best_states(st),
                                  np.asarray(jens.best_states(js)))
    # each best energy is the energy of its best state
    for i, p in enumerate(probs):
        assert abs(p.energy(ens.best_states(st)[i])
                   - ens.best_energies(st)[i]) < 1e-10
    # some label moved
    assert (st.beta_to_slot != torch.arange(len(BETA))).any()


def test_f32_takes_the_sequential_route(monkeypatch):
    """f32 rounds go through the batched sequential wrapper, one call a
    round over every instance with the ensemble's union layout (one
    kernel launch a round on the card)."""
    calls = []
    inner = tens.sequential_sweeps_batched

    def counting(*a, **k):
        calls.append((k["nbrs"], a[3].shape[0]))
        return inner(*a, **k)
    monkeypatch.setattr(tens, "sequential_sweeps_batched", counting)
    probs = [IsingProblem(p.J, p.h) for p in _problems()]
    ens = EnsemblePT(probs, BETA, EnsembleConfig(
        num_replicas=len(BETA), sweeps_per_round=4, num_swapping_pairs=2,
        block_size=8), device="cpu")
    assert ens.sweep_kernel == "sequential_sweeps_batched"
    assert ens.sweep_nbrs.w.shape[0] == I and ens.sweep_nbrs.block_size == 8
    st = ens.run(ens.init_state(torch.Generator().manual_seed(3)), 2)
    assert len(calls) == 2
    assert all(c[0] is ens.sweep_nbrs and c[1] == I for c in calls)
    for i, p in enumerate(probs):
        assert abs(p.energy(ens.best_states(st)[i])
                   - ens.best_energies(st)[i]) < 1e-4
    # the jacobi option runs the plain sweeps
    jac = EnsemblePT(probs, BETA, EnsembleConfig(
        num_replicas=len(BETA), block_size=8, within_block="jacobi"),
        device="cpu")
    assert jac.sweep_kernel is None
    jac.run(jac.init_state(torch.Generator().manual_seed(3)), 1)
    assert len(calls) == 2


def test_m0_seeds_the_coldest_slots_like_jax():
    probs = _problems()
    C = 2
    rng = np.random.default_rng(4)
    m0 = np.where(rng.random((I, C, N)) < 0.5, -1.0, 1.0)
    jens = JEnsemble(probs, BETA, JConfig(num_replicas=len(BETA),
                                          block_size=8, dtype="float64"),
                     mesh=_mesh())
    js = jens.init_state(jax.random.PRNGKey(2), m0=m0)
    ens = EnsemblePT([IsingProblem(p.J, p.h) for p in probs], BETA,
                     EnsembleConfig(num_replicas=len(BETA), block_size=8,
                                    dtype="float64"), device="cpu")
    st = ens.init_state(torch.Generator().manual_seed(2), m0=m0)
    R = len(BETA)
    np.testing.assert_array_equal(st.m[:, R - C:].numpy(),
                                  np.asarray(js.m)[:, R - C:])
    # best candidate coldest: slot R - 1 holds m0[:, 0] in original order
    np.testing.assert_array_equal(
        st.m[:, R - 1][:, ens._inv_perm].numpy(), m0[:, 0])
    assert (st.m[:, :, ~ens.active.numpy()] == 1).all()
    with pytest.raises(ValueError):
        ens.init_state(torch.Generator(), m0=np.ones((I, R + 1, N)))


def test_size_mismatch_raises():
    with pytest.raises(ValueError):
        EnsemblePT([IsingProblem(np.zeros((8, 8)), np.zeros(8)),
                    IsingProblem(np.zeros((10, 10)), np.zeros(10))],
                   [0.5, 1.0], device="cpu")
    with pytest.raises(ValueError):
        JEnsemble([random_sk(8, 0), random_sk(10, 1)], [0.5, 1.0])


def test_state_and_config_fields_match_jax():
    """The JAX state's fields, its key replaced by the generator; the JAX
    config's fields less `precision`."""
    from nmc_tpu.parallel import EnsembleState as JState
    assert set(EnsembleState._fields) == (set(JState._fields) - {"key"}) \
        | {"generator"}
    assert set(JConfig.__dataclass_fields__) - {"precision"} == \
        set(EnsembleConfig.__dataclass_fields__)
