"""nmc_tpu_torch.parallel.swaps against nmc_tpu.parallel.swaps.

The port's label swaps take a leading instance axis; fed the Gumbels and
uniforms that JAX draws from its keys (replayed with the JAX key tree),
the picks, acceptances and both permutations must be exactly JAX's, per
instance and batched over instances. At the benchmark cells' ladder
shapes and at edge cases (`swap_cases`), the CPU path returns exactly
what the stage returned before it became one kernel, and reads nothing
back to the host; on a tensor neither on the CPU nor on CUDA it raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmc_tpu.parallel import swaps as js
from nmc_tpu_torch.ops import swaps_cuda
from nmc_tpu_torch.parallel import swaps as ts

from nmc_tpu_torch.utils import metrics
from swap_cases import CASES, assert_same, make_case, old_label_swap
from swap_cases import old_select_pairs
from torch_parity import swap_replay


def _jax_draws(key, R, num_pairs):
    """The draws metropolis_label_swap(key, ...) makes: split(key) into
    (k_sel, k_acc); Gumbels from split(k_sel, num_pairs); uniforms from
    k_acc."""
    k_sel, k_acc = jax.random.split(key)
    g = np.stack([np.asarray(jax.random.gumbel(k, (R - 1,)))
                  for k in jax.random.split(k_sel, num_pairs)])
    u = np.array(jax.random.uniform(k_acc, (num_pairs,)))
    return torch.as_tensor(g), torch.as_tensor(u)


@pytest.mark.parametrize("R,num_pairs,seed", [(8, 2, 0), (8, 3, 1),
                                              (12, 5, 2), (4, 3, 3)])
def test_select_pairs_matches_jax(R, num_pairs, seed):
    """Sequential non-overlapping picks; (4, 3) runs out of pairs, so its
    last pick is -1 in both."""
    key = jax.random.PRNGKey(seed)
    want = np.asarray(js.select_pairs_device(key, num_replicas=R,
                                             num_pairs=num_pairs))
    g = torch.as_tensor(np.stack([
        np.asarray(jax.random.gumbel(k, (R - 1,)))
        for k in jax.random.split(key, num_pairs)]))
    got = ts.select_pairs_device(R, num_pairs, gumbels=g[None])
    np.testing.assert_array_equal(got[0].numpy(), want)
    if (R, num_pairs) == (4, 3):
        assert got[0, -1] == -1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metropolis_label_swap_matches_jax(seed):
    """Picks, acceptances and both permutations equal JAX's, from a
    shuffled permutation and spread energies (some swaps accepted, some
    not)."""
    R, num_pairs = 10, 4
    rng = np.random.default_rng(seed)
    b2s = rng.permutation(R).astype(np.int32)
    beta = np.geomspace(0.3, 5.0, R).astype(np.float32)
    e = (rng.normal(size=R) * 3).astype(np.float32)
    key = jax.random.PRNGKey(100 + seed)
    jr = js.metropolis_label_swap(key, jnp.asarray(b2s), jnp.asarray(beta),
                                  jnp.asarray(e), num_pairs=num_pairs)
    g, u = _jax_draws(key, R, num_pairs)
    tr = ts.metropolis_label_swap(
        torch.as_tensor(b2s, dtype=torch.int64)[None], torch.as_tensor(beta),
        torch.as_tensor(e)[None], num_pairs=num_pairs, gumbels=g[None],
        uniforms=u[None])
    np.testing.assert_array_equal(tr.pairs[0].numpy(), np.asarray(jr.pairs))
    np.testing.assert_array_equal(tr.accepted[0].numpy(),
                                  np.asarray(jr.accepted))
    np.testing.assert_array_equal(tr.beta_to_slot[0].numpy(),
                                  np.asarray(jr.beta_to_slot))
    np.testing.assert_array_equal(tr.slot_to_beta[0].numpy(),
                                  np.asarray(jr.slot_to_beta))


def test_batched_rows_equal_per_instance_calls():
    """Over an instance axis, row i is the swap of instance i alone, with
    the EnsembleNMC key tree's per-instance draws (swap_replay)."""
    I, R, num_pairs = 4, 8, 3
    rng = np.random.default_rng(7)
    b2s = np.stack([rng.permutation(R) for _ in range(I)])
    beta = np.geomspace(0.5, 4.0, R).astype(np.float32)
    e = (rng.normal(size=(I, R)) * 2).astype(np.float32)
    key = jax.random.PRNGKey(5)
    g, u = swap_replay(key, 3, I, R, num_pairs)
    batched = ts.metropolis_label_swap(
        torch.as_tensor(b2s), torch.as_tensor(beta), torch.as_tensor(e),
        num_pairs=num_pairs, gumbels=g, uniforms=u)
    for i in range(I):
        k_swap = jax.random.fold_in(jax.random.fold_in(
            jax.random.fold_in(key, i), 3), np.uint32(0xD00D))
        jr = js.metropolis_label_swap(
            k_swap, jnp.asarray(b2s[i], jnp.int32), jnp.asarray(beta),
            jnp.asarray(e[i]), num_pairs=num_pairs)
        np.testing.assert_array_equal(batched.beta_to_slot[i].numpy(),
                                      np.asarray(jr.beta_to_slot))
        np.testing.assert_array_equal(batched.accepted[i].numpy(),
                                      np.asarray(jr.accepted))
        np.testing.assert_array_equal(batched.pairs[i].numpy(),
                                      np.asarray(jr.pairs))


def test_generator_draws_keep_permutations():
    """Drawn from a torch.Generator, many rounds keep each row a permutation
    and slot_to_beta its inverse; the same seed gives the same swaps."""
    I, R = 3, 9
    beta = torch.linspace(0.2, 3.0, R)
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(11)
        b2s = torch.arange(R).expand(I, R).clone()
        for _ in range(20):
            e = torch.randn((I, R), generator=gen)
            res = ts.metropolis_label_swap(b2s, beta, e, num_pairs=2,
                                           generator=gen)
            b2s = res.beta_to_slot
            assert (torch.sort(b2s, dim=1).values == torch.arange(R)).all()
            inv = torch.gather(res.slot_to_beta, 1, b2s)
            assert (inv == torch.arange(R)).all()
        runs.append(b2s)
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], torch.arange(R).expand(I, R))


def test_injected_draws_are_checked():
    b2s = torch.arange(4)[None]
    with pytest.raises(ValueError, match="gumbels"):
        ts.metropolis_label_swap(b2s, torch.ones(4), torch.zeros((1, 4)),
                                 num_pairs=2, gumbels=torch.zeros((1, 2, 4)),
                                 uniforms=torch.zeros((1, 2)))
    with pytest.raises(ValueError, match="uniforms"):
        ts.metropolis_label_swap(b2s, torch.ones(4), torch.zeros((1, 4)),
                                 num_pairs=2, gumbels=torch.zeros((1, 2, 3)),
                                 uniforms=torch.zeros((1, 3)))
    with pytest.raises(ValueError, match="Generator"):
        ts.select_pairs_device(4, 2)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_path_equals_the_old_stage_without_a_host_read(name,
                                                           monkeypatch):
    """Injected draws: picks, acceptances and both permutations equal the
    old loop's (dtypes too); no `host_sync` call and no host tensor is
    made, inside a recorded round or out of it."""
    b2s, beta, e, g, u = make_case(name, 3, "cpu")
    want = old_label_swap(b2s, beta, e, g, u)
    want_picks = old_select_pairs(b2s.shape[1], u.shape[1], g)
    calls = []
    inner_sync, inner_tensor = metrics.host_sync, torch.tensor

    def counting_sync(fn, *args, **kw):
        calls.append(fn)
        return inner_sync(fn, *args, **kw)

    def counting_tensor(*args, **kw):
        calls.append(torch.tensor)
        return inner_tensor(*args, **kw)

    monkeypatch.setattr(metrics, "host_sync", counting_sync)
    monkeypatch.setattr(torch, "tensor", counting_tensor)
    spans, timings = metrics.RoundSpans("Test", torch.device("cpu")), {}
    with spans.round(timings):
        got = ts.metropolis_label_swap(b2s, beta, e, num_pairs=u.shape[1],
                                       gumbels=g, uniforms=u)
        picks = ts.select_pairs_device(b2s.shape[1], u.shape[1], gumbels=g)
    again = ts.metropolis_label_swap(b2s, beta, e, num_pairs=u.shape[1],
                                     gumbels=g, uniforms=u)
    assert calls == [] and timings["host_syncs"] == 0
    assert_same(got, want)
    assert_same(again, want)
    assert torch.equal(picks, want_picks)
    assert torch.equal(got.pairs, want_picks)
    if name in ("two_labels", "more_pairs_than_fit"):
        assert (got.pairs == -1).any()
    if name == "equal_energies":
        assert torch.equal(got.accepted, got.pairs >= 0)
    if name in ("exp_overflows", "nan_from_inf"):
        assert got.accepted.any() and not got.accepted[got.pairs >= 0].all()


def test_other_devices_raise_rather_than_fall_back():
    b2s, beta, e, g, u = (x.to("meta") for x in
                          make_case("chimera2048_x20.pt", 1, "cpu"))
    before = swaps_cuda.label_swaps.launches
    with pytest.raises(ValueError, match="cuda only, not meta"):
        ts.metropolis_label_swap(b2s, beta, e, num_pairs=8, gumbels=g,
                                 uniforms=u)
    assert swaps_cuda.label_swaps.launches == before


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_wrapper_takes_cuda_tensors_only(name):
    """`ops.swaps_cuda.label_swaps` on a case's CPU tensors raises, as
    it does on a ladder past 48 KB of shared memory, and counts no
    launch; every case fits one CTA."""
    b2s, beta, e, g, u = make_case(name, 2, "cpu")
    R, num_pairs = b2s.shape[1], u.shape[1]
    assert swaps_cuda.shared_bytes(R, num_pairs) <= 48 * 1024
    before = swaps_cuda.label_swaps.launches
    with pytest.raises(ValueError, match="cuda only, not cpu"):
        swaps_cuda.label_swaps(b2s, beta, e, g, u)
    R, num_pairs = 4096, 8
    with pytest.raises(ValueError, match="48 KB"):
        swaps_cuda.label_swaps(
            torch.zeros((1, R), dtype=torch.int64), torch.zeros(R),
            torch.zeros((1, R)), torch.zeros((1, num_pairs, R - 1)),
            torch.zeros((1, num_pairs)))
    assert swaps_cuda.label_swaps.launches == before
