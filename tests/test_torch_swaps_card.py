"""On a card: the label-swap kernel (`csrc/label_swaps.cu`, launched by
`metropolis_label_swap` on CUDA tensors) element for element against its
plain twin run as torch operations on the same card
(`label_swap_reference`) and against the stage as it was before the
kernel (`swap_cases.old_label_swap`), at the benchmark cells' ladder
shapes and the edge cases of `swap_cases`:
  * with injected draws, and with the draws of a CUDA generator (the twin
    fed what the same seed draws in the wrapper's order, Gumbels first);
  * at the acceptance boundary: uniforms equal to torch's own
    min(1, exp(dB dE)) and one float below it, so that an exp one ulp off
    torch's would flip an acceptance;
and each call is one launch (`ops.swaps_cuda.label_swaps.launches`), one
an engine round, with no host read in the round.

    python3 -m pytest tests/test_torch_swaps_card.py -m card --noconftest

Each test skips inside itself where torch sees no CUDA card. The file
uses no fixture of the repo's conftest and imports no JAX."""

import numpy as np
import pytest
import torch

from nmc_tpu_torch.io.generators import random_sk
from nmc_tpu_torch.ops import swaps_cuda
from nmc_tpu_torch.parallel import EnsembleConfig, EnsemblePT
from nmc_tpu_torch.parallel import swaps as ts
from swap_cases import CASES, assert_same, make_case, old_label_swap

pytestmark = pytest.mark.card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_equals_twin_with_injected_draws(name):
    dev = _card()
    for seed in (0, 2**31 + 11):
        b2s, beta, e, g, u = make_case(name, seed, dev)
        before = swaps_cuda.label_swaps.launches
        got = ts.metropolis_label_swap(b2s, beta, e, num_pairs=u.shape[1],
                                       gumbels=g, uniforms=u)
        assert swaps_cuda.label_swaps.launches == before + 1
        torch.cuda.synchronize()
        assert_same(got, ts.label_swap_reference(b2s, beta, e, g, u))
        assert_same(got, old_label_swap(b2s, beta, e, g, u))


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_equals_twin_with_generator_draws(name):
    dev = _card()
    b2s, beta, e, _, u = make_case(name, 5, dev)
    I, num_pairs = u.shape
    R = b2s.shape[1]
    gen = torch.Generator(device=dev).manual_seed(77)
    twin_gen = torch.Generator(device=dev).manual_seed(77)
    for _ in range(3):
        got = ts.metropolis_label_swap(b2s, beta, e, num_pairs=num_pairs,
                                       generator=gen)
        g = ts._gumbel((I, num_pairs, R - 1), twin_gen, torch.float32, dev)
        su = torch.rand((I, num_pairs), generator=twin_gen, device=dev)
        assert_same(got, ts.label_swap_reference(b2s, beta, e, g, su))
        b2s = got.beta_to_slot
    assert torch.equal(gen.get_state(), twin_gen.get_state())


def test_acceptance_at_torchs_exp_to_the_bit():
    """R = 2 (the one pair is always picked) on 2^20 ladders: uniforms set
    to torch's clamp(exp(dB dE), max=1) accept nowhere, one float below it
    wherever it is above 0; the kernel's expf must agree with torch.exp."""
    dev = _card()
    I = 1 << 20
    gen = torch.Generator(device=dev).manual_seed(3)
    beta = torch.tensor([0.7, 1.9], device=dev)
    e = torch.randn((I, 2), generator=gen, device=dev) * 40.0
    b2s = torch.stack([torch.arange(2, device=dev)] * I)
    b2s[torch.rand(I, generator=gen, device=dev) < 0.5] = torch.tensor(
        [1, 0], device=dev)
    g = torch.zeros((I, 1, 1), device=dev)
    rows = torch.arange(I, device=dev)
    dE = e[rows, b2s[:, 1]] - e[rows, b2s[:, 0]]
    p = torch.exp((beta[1] - beta[0]) * dE).clamp(max=1.0)
    below = torch.nextafter(p, torch.zeros_like(p))
    for u, want in ((p, torch.zeros_like(p, dtype=torch.bool)),
                    (below, p > 0)):
        got = ts.metropolis_label_swap(b2s, beta, e, num_pairs=1, gumbels=g,
                                       uniforms=u[:, None])
        assert torch.equal(got.accepted[:, 0], want)
        assert_same(got, ts.label_swap_reference(b2s, beta, e, g,
                                                 u[:, None]))
    assert 0.05 < float((p < 1).float().mean()) < 0.95


def test_one_launch_and_no_host_read_an_engine_round():
    """EnsemblePT on the card: one swap launch a round, and a recorded
    round counts no host sync."""
    dev = _card()
    eng = EnsemblePT([random_sk(64, seed=s) for s in range(3)],
                     np.geomspace(0.3, 3.0, 8),
                     EnsembleConfig(num_replicas=8, sweeps_per_round=4,
                                    num_swapping_pairs=3, block_size=32),
                     device=dev)
    state = eng.init_state(torch.Generator(device=dev).manual_seed(1))
    state = eng.round(state)
    before = swaps_cuda.label_swaps.launches
    timings = {}
    for _ in range(3):
        state = eng.round(state, timings=timings)
    eng.flush()
    assert swaps_cuda.label_swaps.launches == before + 3
    assert timings["rounds"] == 3 and timings["host_syncs"] == 0
    b2s = state.beta_to_slot.cpu()
    assert (torch.sort(b2s, dim=1).values == torch.arange(8)).all()
