"""The yardstick's arithmetic on hand-worked cases: attempts and the
roofline bound (and the cells' own, pinned), Philox-4x32-10, TF32
rounding, the phase list, the warp energy, the p95 and the trace reader."""

import json

import numpy as np
import pytest
import torch

from perfbench import harness, instances, trace, work
from perfbench.reference import philox, precision, sweeps


@pytest.mark.parametrize("extra,chains", [({}, 4), ({"subreplicas": 3}, 12)],
                         ids=["replicas", "subreplicas"])
def test_round_work_on_a_hand_worked_shape(extra, chains):
    cfg = dict(replicas=4, sweeps_per_phase=2, num_cycles=2,
               full_update_frequency=1, **extra)
    J = np.zeros((3, 5, 5))
    J[:, 0, 1] = J[:, 1, 0] = 1.0
    J[1, 2, 3] = J[1, 3, 2] = -1.0
    w = work.round_work(cfg, J)
    # 3 instances x 4 replicas (x 3 subreplicas) x 5 spins x (2 cycles x 3
    # phases x 2 sweeps)
    visits = 3 * chains * 5 * 12
    assert w["attempts"] == visits
    assert w["ops"] == visits * 113
    # union nonzeros 4; couplings, h, then states 13 bytes a spin
    assert w["bytes"] == 4 * 3 * 4 + 4 * 3 * 5 + 3 * chains * 5 * 13
    peaks = dict(f32_flops=67e12, hbm_bytes_per_s=3.35e12)
    assert work.bound_seconds(w, peaks) == pytest.approx(visits * 113 / 67e12)
    # one instance over two ranks: each holds half of its chains
    one = work.round_work(cfg, J[:1], world=2)
    assert one["attempts"] == chains // 2 * 5 * 12
    assert one["bytes"] == 4 * 2 + 4 * 5 + chains // 2 * 5 * 13


# round_work of the cells at their own shapes (on four cards: one rank's
# share): every cell's attempts_per_s and round_roofline divide by it
PINNED = {
    ("chimera2048_x20.nmc", 1): (754974720, 85312143360, 18165760),
    ("chimera2048_x20.pt", 1): (754974720, 85312143360, 18165760),
    ("sk1000_x100.pt", 1): (204800000, 23142400000, 483200000),
    ("chimera5408_sharded.pt_4chip", 4): (49840128, 5631934464, 1274624),
}


@pytest.mark.parametrize("workload,world", list(PINNED))
def test_round_work_of_the_cells_is_pinned(workload, world):
    cfg = harness.resolve(workload)["config"]
    fam = cfg["instances"]
    # the family's support: every chimera edge; SK's off-diagonal entries
    if fam["family"] == "chimera":
        e = instances.chimera_edges(fam["m"], fam["t"])
        n = 2 * fam["t"] * fam["m"] ** 2
        support = np.zeros((n, n), dtype=bool)
        support[e[:, 0], e[:, 1]] = support[e[:, 1], e[:, 0]] = True
    else:
        n = fam["n"]
        support = ~np.eye(n, dtype=bool)
    J = np.broadcast_to(support, (fam["count"], n, n))
    w = work.round_work(cfg, J, world)
    assert (w["attempts"], w["ops"], w["bytes"]) == PINNED[workload, world]


def test_round_work_of_the_cells():
    J = np.ones((20, 2048, 2048))
    cfg = harness.resolve("chimera2048_x20.nmc")["config"]
    assert work.round_work(cfg, J)["attempts"] == 20 * 32 * 2048 * 576
    sharded = harness.resolve("chimera5408_sharded.pt_4chip")["config"]
    assert work.round_work(sharded, np.ones((1, 8, 8)), world=4)[
        "attempts"] == 16 * 8 * 576
    sk = harness.resolve("sk1000_x100.pt")["config"]
    assert work.sweeps_per_round(sk) == 32


def test_peaks_of_the_h100():
    p = work.load_peaks("NVIDIA H100 80GB HBM3")
    assert p["f32_flops"] == 67e12 and p["hbm_bytes_per_s"] == 3.35e12
    assert work.load_peaks("cpu") is None


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), 0x6627E8D5),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, 0x408F276D),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0), 0xD16CFE09),
])
def test_philox_known_answers(ctr, key, want):
    t = [torch.tensor(x, dtype=torch.int64) for x in ctr + key]
    assert int(philox.word0(*t)) == want


def test_uniforms_take_the_top_24_bits():
    bits = torch.tensor([0, 0xFFFFFFFF, 0x80000000], dtype=torch.int64)
    u = philox.uniforms(bits)
    assert u.tolist() == [0.0, 1.0 - 2.0 ** -24, 0.5]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11,
                      1.0 + 3 * 2.0 ** -11, 2.0, -3.0])
    y = precision._round_tf32(x)
    assert y.tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -9,
                          2.0, -3.0]


def test_phase_list_and_heated_factor():
    assert sweeps.phase_list(3, 1) == ["C", "NC", "ALL"] * 3
    assert sweeps.phase_list(2, 2) == ["C", "NC", "ALL", "C", "NC"]
    # 1 + f32(1/20 - 1) in float32, a little above 0.05
    assert sweeps.heated_factor(20.0) == np.float32(1) + np.float32(-0.95)


def test_warp_energy_sums_every_spin():
    g = torch.Generator().manual_seed(0)
    m = torch.where(torch.rand((3, 70), generator=g) < 0.5, -1.0, 1.0)
    phi = torch.randn((3, 70), generator=g, dtype=torch.float64)
    h = torch.randn((70,), generator=g, dtype=torch.float64)
    e = sweeps.warp_energy(h, m.double(), phi)
    assert torch.allclose(e, -0.5 * (m * (phi + h)).sum(-1))


def test_p95_of_the_rounds():
    xs = list(range(1, 101))
    assert harness._p95(xs) == pytest.approx(95.95)
    assert harness._p95([5.0]) is None


def test_trace_reader_busy_idle_and_gaps(tmp_path):
    ev = [
        dict(ph="X", cat="user_annotation", name=trace.WINDOW, ts=0, dur=100),
        dict(ph="X", cat="kernel", name="k", ts=10, dur=20),
        dict(ph="X", cat="kernel", name="ncclDevKernel_AllReduce", ts=25,
             dur=15),
        dict(ph="X", cat="cpu_op", name="aten::add", ts=40, dur=30,
             pid=1, tid=1),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=50,
             dur=5, pid=1, tid=1),
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    s = trace.summarize(str(p))
    assert s["busy_s"] == pytest.approx(30e-6)       # [10, 40)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["nccl_s"] == pytest.approx(15e-6)
    idle = dict(s["idle_gaps"])
    assert idle["cudaLaunchKernel"] == pytest.approx(5e-6)
    assert idle["aten::add"] == pytest.approx(25e-6)
    assert idle["host:no_operator"] == pytest.approx(40e-6)
