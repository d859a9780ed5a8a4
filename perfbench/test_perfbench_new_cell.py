"""A cell enters the benchmark by new files only: a whole cell built under
a temporary root (BENCHMARK.json, configuration, traffic mix, check limits,
tiny CPU size) on an engine with a sub-replica axis, whose runner and
reference are registered by name, resolves, runs correct through the
harness on the CPU, counts every chain's attempts, and fails under each
broken-path fault."""

import json
import sys
import time
import types
from typing import NamedTuple

import pytest
import torch

from perfbench import check, harness
from perfbench.reference import draws
from perfbench.test_perfbench_control import FAULTS

ENGINE = "stub_subreplicas"
WORKLOAD = "stub_family.stub_mix"
CONFIG = dict(name="stub_family", engine=ENGINE,
              instances={"family": "chimera", "m": 4, "t": 4, "count": 20},
              replicas=32, subreplicas=10,
              ladder={"kind": "two_halves", "beta_min": 0.25,
                      "beta_max": 32.0},
              sweeps_per_round=576, dtype="float32", reduced=[])
TINY = dict(instances={"family": "chimera", "m": 2, "t": 4, "count": 3},
            replicas=4, subreplicas=3, sweeps_per_round=4)
TRAFFIC = dict(nmc_coldest=0, lbp_every=8, global_beta=13.63, best_every=5)
LIMITS = {k: dict(limit=v, lower=0.0, upper=1.0, upper_from="bfloat16")
          for k, v in dict(spin_diff=0.01, label_diff=0.01, energy_gap=0.002,
                           best_gap=1e-4).items()}


class State(NamedTuple):
    m: torch.Tensor             # [I, S, R, n] chains, S sub-replicas
    beta_to_slot: torch.Tensor  # [I, S, R]
    slot_to_beta: torch.Tensor
    m_best: torch.Tensor        # [I, n]
    e_best: torch.Tensor        # [I]
    round_index: int


def _start(inputs, S, g):
    I, n = inputs.J.shape[:2]
    R = inputs.beta.shape[0]
    u = torch.rand((I, S, R, n), generator=g)
    ids = torch.arange(R).expand(I, S, R)
    return State(torch.where(u < 0.5, -1.0, 1.0), ids.clone(), ids.clone(),
                 torch.ones((I, n)), torch.full((I,), float("inf")), 0)


def _round(J, beta, T, state, g):
    """T synchronous heat-bath sweeps of every chain, then the fold of each
    instance's lowest chain into its best (strict <)."""
    m = state.m
    I, S, R, n = m.shape
    u = torch.rand((T,) + m.shape, generator=g)
    for t in range(T):
        phi = torch.matmul(m.reshape(I, S * R, n), J).reshape(m.shape)
        p = torch.sigmoid(2.0 * beta[:, None] * phi)
        m = torch.where(u[t] < p, 1.0, -1.0)
    phi = torch.matmul(m.reshape(I, S * R, n), J)
    e = -0.5 * (m.reshape(I, S * R, n) * phi).sum(-1)
    low, k = e.min(dim=1)
    better = low < state.e_best
    m_low = m.reshape(I, S * R, n)[torch.arange(I), k]
    return state._replace(
        m=m, m_best=torch.where(better[:, None], m_low, state.m_best),
        e_best=torch.where(better, low, state.e_best),
        round_index=state.round_index + 1)


class _Stub:
    def __init__(self, inputs, device, *_):
        cfg = inputs.config
        self.J = torch.as_tensor(inputs.J, dtype=torch.float32)
        self.beta = torch.as_tensor(inputs.beta, dtype=torch.float32)
        self.inputs, self.S = inputs, cfg["subreplicas"]
        self.T = cfg["sweeps_per_round"]


class StubEngine(_Stub):
    def init(self, generator):
        self.g = generator
        return _start(self.inputs, self.S, generator)

    def round(self, state, timings=None):
        return _round(self.J, self.beta, self.T, state, self.g), None

    def best(self, state):
        return state.e_best.numpy().copy(), state.m_best.numpy().copy()

    def export(self, state, extra=None):
        return state._asdict()


class StubReference(_Stub):
    def initial(self, gen_state):
        g = draws.generator_at(gen_state, "cpu")
        return _start(self.inputs, self.S, g)._asdict()

    def replay(self, state, gen_state, rounds, prec=None):
        g = draws.generator_at(gen_state, "cpu")
        s, out = State(**state), []
        for _ in range(rounds):
            s = _round(self.J, self.beta, self.T, s, g)
            out.append(s._asdict())
        return out

    def original_order(self, m):
        return m


def _write(path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=2))


@pytest.fixture
def new_cell(tmp_path, monkeypatch):
    """The stub cell's files under tmp_path, its runner and reference
    registered as perfbench.engines / perfbench.reference modules."""
    real = harness.load_json(harness.ROOT, "BENCHMARK.json")
    e2e = [m for m in real["end_to_end"]
           if m["name"] in ("attempts_per_s", "setup_s")]
    layer = [dict(m, workloads=[WORKLOAD]) for m in real["per_layer"]
             if m["name"] == "device_idle_pct"]
    bench = dict(real, configs=[dict(
        name=CONFIG["name"], source="https://example.org/stub",
        file="perfbench/configs/stub_family.json", reduced=[],
        why="a stub engine with sub-replicas")],
        workloads=[dict(name=WORKLOAD, config=CONFIG["name"],
                        traffic="stub_mix", chips=1, why="stub")],
        end_to_end=e2e, per_layer=layer)
    pb = tmp_path / "perfbench"
    _write(tmp_path / "BENCHMARK.json", bench)
    _write(pb / "configs" / "stub_family.json", CONFIG)
    _write(pb / "traffic" / "stub_mix.json", TRAFFIC)
    _write(pb / "checks" / f"{WORKLOAD}.json", dict(limits=LIMITS))
    _write(pb / "tiny" / f"{WORKLOAD}.json", TINY)
    runner = types.ModuleType(f"perfbench.engines.{ENGINE}")
    runner.Engine, runner.LIBRARIES = StubEngine, ()
    reference = types.ModuleType(f"perfbench.reference.{ENGINE}")
    reference.Reference = StubReference
    monkeypatch.setitem(sys.modules, runner.__name__, runner)
    monkeypatch.setitem(sys.modules, reference.__name__, reference)
    return str(tmp_path)


def _run(cell, seed=2147483671):
    rec = harness.run_rank(cell, seed, 0.2, False, t_process=time.time(),
                           device="cpu")
    return rec, harness.assemble(cell, [rec], False)


def test_a_new_cell_resolves_under_its_own_root(new_cell):
    cell = harness.resolve(WORKLOAD, new_cell)
    assert cell["config"] == CONFIG and cell["traffic"] == TRAFFIC
    assert cell["limits"] == {k: v["limit"] for k, v in LIMITS.items()}
    assert cell["replayed"] == 2 and cell["chips"] == 1
    assert [m["name"] for m in cell["metrics"]["end_to_end"]] == [
        "attempts_per_s", "setup_s"]
    assert check.control_precision(WORKLOAD, f"{new_cell}/perfbench") == \
        "bfloat16"
    mods = harness._engine_modules(ENGINE)
    assert mods[0].Engine is StubEngine and mods[1].Reference is StubReference


def test_a_new_cell_runs_correct_and_counts_every_chain(tiny, new_cell):
    cell = tiny(WORKLOAD, new_cell)
    rec, line = _run(cell)
    assert line["correct"], line["checks"]
    nums = check.numbers(rec["tally"])
    assert nums["spin_diff"] == 0 and nums["label_diff"] == 0
    I, n = TINY["instances"]["count"], 2 * 4 * 2 ** 2
    assert rec["work"]["attempts"] == I * 4 * 3 * n * 4
    assert line["metrics"]["attempts_per_s"]["value"] == pytest.approx(
        rec["work"]["attempts"] * rec["rounds"] / rec["window_s"])


@pytest.mark.parametrize("fault,attr", FAULTS)
def test_a_new_cell_with_a_broken_timed_path_is_not_correct(
        tiny, new_cell, monkeypatch, fault, attr):
    cell = tiny(WORKLOAD, new_cell)
    monkeypatch.setattr(StubEngine, attr, fault(StubEngine))
    _, line = _run(cell)
    assert not line["correct"], line["checks"]
