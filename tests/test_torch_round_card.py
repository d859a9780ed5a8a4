"""On a card: the whole-round kernels K4/K5 bit for bit against the plain
round over their own layout (`ensemble_round_neighbors_reference`), with
injected uniforms and with their own Philox draws (reproduced for the
plain round by the benchmark's plain Philox, `perfbench/reference/`), at
both CTA widths:
  * chimera 26x26 at 16 slots of a 64-slot ladder (replica offset 16), as
    one card of the four-card sharded cell runs it: the 1024-thread CTA;
  * 20 chimera 16x16 (K5) and 20 chimera 8x8 (K4) instances x 32 slots
    on Gaussian couplings, the ensembles' launch: 256 threads;
and the width the wrapper does not take, forced, gives the same outputs.
An engine's rounds count the steps its launches walk: 3 a sweep on both
chimeras, for 5 and 16 row blocks.

    python3 -m pytest tests/test_torch_round_card.py -m card --noconftest

Each test skips inside itself where torch sees no CUDA card. The file
uses no fixture of the repo's conftest and imports no JAX, so it runs
with `--noconftest` on the card's machine."""

import numpy as np
import pytest
import torch

from nmc_tpu_torch.io.generators import chimera_graph
from nmc_tpu_torch.ops import round_cuda as rc
from nmc_tpu_torch.ops.sweeps_cuda import _num_sms
from nmc_tpu_torch.parallel import EnsembleNMC, ShardedNPTConfig

KW = dict(num_cycles=2, sweeps_per_phase=3, full_update_frequency=2,
          temp_x_inv=1.0 / 20.0)
# (chimera size, instances, slots, Gaussian couplings, replica offset,
#  the ladder's slots, the CTA width the wrapper takes); chimera 8x8 routes
# to K4, the larger ones to K5
CASES = {"c26_16_slots": (26, 1, 16, False, 16, 64, 1024),
         "c16_20x32_gaussian": (16, 20, 32, True, 0, 32, 256),
         "c8_20x32_gaussian": (8, 20, 32, True, 0, 32, 256)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(name, dev):
    size, count, R, gaussian, r0, r_total, width = CASES[name]
    probs = [chimera_graph(size, size, seed=s, pm=not gaussian).normalized()[0]
             for s in range(count)]
    ens = EnsembleNMC(probs, np.geomspace(0.25, 32.0, R), [False] * R,
                      ShardedNPTConfig(use_coloring=True, block_size=128),
                      device=dev)
    assert ens.round_path == ("K4" if size == 8 else "K5")
    gen = torch.Generator(device=dev).manual_seed(size)
    m0 = torch.where(torch.rand(ens.I, R, ens.n_pad, generator=gen,
                                device=dev) < 0.5, -1.0, 1.0)
    m0 = torch.where(ens.active, m0, 1.0)
    cl = (torch.rand(m0.shape, generator=gen, device=dev) < 0.4) & ens.active
    dn = torch.rand((ens.I, R), generator=gen, device=dev) < 0.3
    beta = torch.where(dn, 13.63, ens.beta_list.expand(ens.I, R)).contiguous()
    return ens, (m0, cl, dn, beta), (r0, r_total, width)


def _kernel(ens, inputs, offsets, **kw):
    r0, r_total, _ = offsets
    flips = torch.zeros(tuple(inputs[2].shape), dtype=torch.int32,
                        device=ens.device)
    kw.update(flips=flips, nbrs=ens.round_nbrs, replica_offset=r0,
              replicas_total=r_total, **KW)
    if ens.round_path == "K4":
        out = rc.ensemble_round(ens.J_full, ens.h, ens.active, *inputs, None,
                                block_size=ens.blocked0.block_size, **kw)
    else:
        out = rc.ensemble_round_sparse(*ens._stream_tiles, ens.h, ens.active,
                                       *inputs, None, **kw)
    return out, flips


def _plain(ens, inputs, uniforms):
    flips = torch.zeros(tuple(inputs[2].shape), dtype=torch.int32,
                        device=ens.device)
    out = rc.ensemble_round_neighbors_reference(
        ens.round_nbrs, ens.h, ens.active, *inputs, None, uniforms=uniforms,
        flips=flips, **KW)
    return out, flips


def _philox_uniforms(seed, ens, R, r0):
    """[P, T, I, R, n_pad]: the kernel's Philox draws of the launch."""
    from perfbench.reference.draws import kernel_uniforms
    P = len(rc.phase_list(KW["num_cycles"], KW["full_update_frequency"]))
    T = KW["sweeps_per_phase"]
    dev = ens.device
    u = kernel_uniforms(seed, ens.n_pad,
                        torch.arange(R, device=dev) + r0,
                        torch.arange(P * T, device=dev),
                        torch.arange(ens.I, device=dev))
    return u.reshape(P, T, ens.I, R, ens.n_pad)


def _equal(a, b):
    (ka, fa), (kb, fb) = a, b
    return all(torch.equal(x, y) for x, y in zip(ka, kb)) and torch.equal(
        fa, fb)


@pytest.mark.card
@pytest.mark.parametrize("draws", ["injected", "philox"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_round_kernel_is_the_neighbour_round_at_both_widths(
        name, draws, monkeypatch):
    dev = _card()
    ens, inputs, offsets = _case(name, dev)
    I, R = inputs[2].shape
    width = offsets[2]
    assert rc.round_threads(I * R, _num_sms(dev)) == width
    if draws == "injected":
        P = len(rc.phase_list(KW["num_cycles"], KW["full_update_frequency"]))
        u = torch.rand((P, KW["sweeps_per_phase"]) + tuple(inputs[0].shape),
                       generator=torch.Generator(device=dev).manual_seed(3),
                       device=dev)
        kw, plain_u = dict(uniforms=u), u
    else:
        seed = torch.tensor([123456789, 987654321], dtype=torch.int32,
                            device=dev)
        kw, plain_u = dict(seed=seed), _philox_uniforms(seed, ens, R,
                                                        offsets[0])
    got = _kernel(ens, inputs, offsets, **kw)
    want = _plain(ens, inputs, plain_u)
    torch.cuda.synchronize()
    assert (got[0].m != inputs[0]).any() and int(got[1].sum()) > 0
    assert _equal(got, want)
    other = [w for w in rc.ROUND_WIDTHS if w != width][0]
    monkeypatch.setattr(rc, "round_threads", lambda slots, sms: other)
    assert _equal(_kernel(ens, inputs, offsets, **kw), got)


@pytest.mark.card
@pytest.mark.parametrize("size,blocks", [(8, 5), (16, 16)])
def test_engine_rounds_count_the_steps_their_launches_walk(size, blocks):
    dev = _card()
    probs = [chimera_graph(size, size, seed=s).normalized()[0]
             for s in range(2)]
    cfg = ShardedNPTConfig(use_coloring=True, block_size=128, num_cycles=2,
                           sweeps_per_phase=3)
    ens = EnsembleNMC(probs, np.geomspace(0.25, 32.0, 8), [False] * 8, cfg,
                      device=dev)
    timings = {}
    ens.best(ens.run_scanned(ens.init_state(
        torch.Generator(device=dev).manual_seed(1)), 2, timings=timings))
    sweeps = 2 * 3 * len(rc.phase_list(2, cfg.full_update_frequency))
    assert timings["round_steps"] == 3 * sweeps
    assert timings["round_blocks"] == blocks * sweeps
