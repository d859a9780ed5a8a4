"""The port's APT + ICM (`models/apt_icm.py`) against nmc_tpu's.

The port replays the draws of the JAX package's run (`apt_icm_replay`
below: initial states from split(key)[1], the host rng seeded from the
last word of the remaining key, per round split(key, 3) -> (key, k_a,
k_b) for the first sweep and the rest, and on the device path split(key)
-> (key, k_icm) with one cluster uniform per pair from split(k_icm, P)).
On one instance and one layout both runs agree: states, swap counts, ICM
moves and flips, the energy traces and the best state, on the host path
(scipy components against the JAX package's native union-find) and on
the device path (the batched edge-list move), with faithful_quirks on and
off and per_swap 1 and 3. In f32, as the NPT parity test: the JAX
function writes into its initial states, which are read-only views in
f64; on +-J couplings the energies are integers, exact in f32. A resumed
run equals an uninterrupted one (the `icm` command's keys are checked in
test_torch_campaign.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmc_tpu.io.generators import chimera_graph
from nmc_tpu.models import apt_icm as jm
from nmc_tpu.ops.engine import SweepEngine as JaxEngine
from nmc_tpu_torch.models import apt_icm as tm
from nmc_tpu_torch.utils import checkpoint as tck

from torch_parity import jax_sweep_uniforms

BETA = [0.5, 1.2, 2.6]


def apt_icm_replay(key, engine, cfg, R, n):
    """(m_init [R*S, n], host rng, per-round (u_a, u_b, u_icm)) of
    nmc_tpu.models.apt_icm.apt_icm_run from `key` on the JAX `engine`."""
    S = cfg.num_subreplicas
    per_swap = cfg.num_sweeps_MCMC // cfg.num_swap_attempts
    key, k_init = jax.random.split(key)
    m_init = np.array(engine.from_blocked(engine.init_states(k_init, R * S)),
                      np.float64)
    host_rng = np.random.default_rng(
        np.asarray(jax.random.key_data(key)).ravel()[-1])
    device_icm = cfg.device_icm if cfg.device_icm is not None else n > 2048
    rounds = []
    for _ in range(cfg.num_swap_attempts):
        key, k_a, k_b = jax.random.split(key, 3)
        u_a = torch.as_tensor(jax_sweep_uniforms(k_a, 1, R * S, engine.n_pad,
                                                 np.float32))
        u_b = (torch.as_tensor(jax_sweep_uniforms(
            k_b, per_swap - 1, R * S, engine.n_pad, np.float32))
            if per_swap > 1 else None)
        g = None
        if device_icm:
            key, k_icm = jax.random.split(key)
            g = torch.as_tensor(np.stack([
                np.asarray(jax.random.uniform(k, (n,)))
                for k in jax.random.split(k_icm, R * (S // 2))]))
        rounds.append((u_a, u_b, g))
    return m_init, host_rng, rounds


def _common(**kw):
    base = dict(num_sweeps_MCMC=12, num_sweeps_read=8, num_swap_attempts=4,
                num_swapping_pairs=1, num_subreplicas=4, block_size=8,
                use_coloring=True, dtype="float32")
    base.update(kw)
    return base


@pytest.mark.parametrize("per_swap", [1, 3])
@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("device_icm", [False, True])
def test_apt_icm_run_matches_jax(device_icm, faithful, per_swap):
    prob = chimera_graph(2, 2, seed=5).normalized()[0]
    common = _common(num_sweeps_MCMC=4 * per_swap, faithful_quirks=faithful,
                     device_icm=device_icm, record_last_round_m=True)
    jcfg, tcfg = jm.APTICMConfig(**common), tm.APTICMConfig(**common)
    key = jax.random.PRNGKey(7)
    jr = jm.apt_icm_run(prob, BETA, jcfg, key)
    jeng = JaxEngine(prob, block_size=8, use_coloring=True,
                     dtype=jnp.float32)
    m_init, host_rng, rounds = apt_icm_replay(key, jeng, jcfg, len(BETA),
                                              prob.n)
    tr = tm.apt_icm_run(prob, BETA, tcfg, device="cpu", m_init=m_init,
                        host_rng=host_rng, uniforms=rounds)
    for f in ("final_states", "swap_counts", "Energy", "energy_trace",
              "best_state", "M_history", "beta_list"):
        np.testing.assert_array_equal(getattr(tr, f), getattr(jr, f),
                                      err_msg=f)
    for f in ("min_energy", "icm_moves", "icm_flips", "rounds_completed",
              "hit_round"):
        assert getattr(tr, f) == getattr(jr, f), f
    assert tr.icm_moves > 0 and tr.M_history.shape == (3, 4, per_swap, 32)


def test_host_path_is_the_default_up_to_2048_spins(monkeypatch):
    """device_icm=None takes the host path at n <= 2048 (no batched call)."""
    calls = []
    monkeypatch.setattr(tm, "houdayer_move_sparse",
                        lambda *a, **k: calls.append(1))
    prob = chimera_graph(2, 2, seed=1).normalized()[0]
    res = tm.apt_icm_run(prob, BETA, tm.APTICMConfig(**_common()),
                         torch.Generator().manual_seed(0))
    assert not calls and res.icm_moves + res.icm_flips > 0
    assert res.M_history is None


def test_target_energy_hit_and_resume(tmp_path):
    """A checkpoint after round 2 of 5 (generator state, host rng, states,
    counts) resumes into the run that never stopped; a reachable target
    stops the run at its hit."""
    prob = chimera_graph(2, 2, seed=2).normalized()[0]
    base = _common(num_sweeps_MCMC=15, num_swap_attempts=5)
    full = tm.apt_icm_run(prob, BETA, tm.APTICMConfig(**base),
                          torch.Generator().manual_seed(3))
    ck = str(tmp_path / "icm.npz")
    tm.apt_icm_run(prob, BETA, tm.APTICMConfig(**base, checkpoint_path=ck,
                                               checkpoint_every=2),
                   torch.Generator().manual_seed(3))
    _, step, _ = tck.load_checkpoint(ck)
    assert step == 4
    resumed = tm.apt_icm_run(
        prob, BETA, tm.APTICMConfig(**base, checkpoint_path=ck, resume=True),
        torch.Generator().manual_seed(3))
    for f in ("final_states", "swap_counts", "Energy", "best_state"):
        np.testing.assert_array_equal(getattr(resumed, f), getattr(full, f),
                                      err_msg=f)
    assert (resumed.icm_moves, resumed.icm_flips, resumed.min_energy) == (
        full.icm_moves, full.icm_flips, full.min_energy)
    hit = tm.apt_icm_run(prob, BETA, tm.APTICMConfig(
        **base, target_energy=full.min_energy + 50.0),
        torch.Generator().manual_seed(3))
    assert hit.hit_round == 0 and hit.rounds_completed == 1
    assert hit.hit_seconds > 0


def test_config_carries_the_jax_fields():
    jf = {f.name: f.default for f in dataclasses.fields(jm.APTICMConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tm.APTICMConfig)}
    assert jf == tf
    assert tm.APTICMResult._fields == jm.APTICMResult._fields
