"""The check must fail what is wrong: the reference in a lower precision
put in the program's place (the control), and the timed path broken
underneath a run of the harness."""

import time

import pytest
import torch

from perfbench import check, harness
from perfbench.reference.precision import Precision

CELLS = [w["name"] for w in
         harness.load_json(harness.ROOT, "BENCHMARK.json")["workloads"]]


def run(cell, seed=2147483660):
    rec = harness.run_rank(cell, seed, 0.2, False, t_process=time.time(),
                           device="cpu")
    return harness.assemble(cell, [rec], False)


def captured_run(cell, seed):
    """A run of the cell that also hands back what its check compared."""
    seen = {}
    verify = harness.verify

    def spy(ref, snaps, inputs, answers, prec=Precision()):
        seen.update(ref=ref, snaps=snaps, inputs=inputs)
        return verify(ref, snaps, inputs, answers, prec)

    harness.verify = spy
    try:
        harness.run_rank(cell, seed, 0.2, False, t_process=time.time(),
                         device="cpu")
    finally:
        harness.verify = verify
    return seen


@pytest.mark.parametrize("workload", CELLS)
def test_the_bfloat16_control_fails(tiny, workload):
    cell = tiny(workload)
    seen = captured_run(cell, 23)
    t = harness.control(seen["ref"], seen["snaps"], seen["inputs"],
                        Precision("bfloat16"))
    ok, checks = check.verdict(check.numbers(t), cell["limits"])
    assert not ok, checks


def _unchanged(engine_cls):
    def round_(self, state, timings=None):
        return state._replace(round_index=state.round_index + 1), None
    return round_


def _half(engine_cls):
    inner = engine_cls.round

    def round_(self, state, timings=None):
        new, extra = inner(self, state, timings)
        m = new.m.clone()
        rows = m.shape[0] // 2
        m[rows:] = state.m[rows:]
        return new._replace(m=m), extra
    return round_


def _altered(engine_cls):
    inner = engine_cls.best

    def best(self, state):
        e, m = inner(self, state)
        e = e.copy()
        e[0] += 1.0
        return e, m
    return best


# each fault and the Engine method it replaces
FAULTS = [(_unchanged, "round"), (_half, "round"), (_altered, "best")]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault,attr", FAULTS)
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, workload,
                                            fault, attr):
    cell = tiny(workload)
    mod, _ = harness._engine_modules(cell["config"]["engine"])
    monkeypatch.setattr(mod.Engine, attr, fault(mod.Engine))
    line = run(cell)
    assert not line["correct"], line["checks"]


def test_the_exchange_between_ranks_left_out_is_not_correct(tiny,
                                                            monkeypatch):
    """The sharded cell with every rank's energies but the first quarter's
    missing from the gather, as if the all-reduce had not run."""
    from nmc_tpu_torch.parallel import distributed
    gather = distributed.gather_rows

    def local_only(x, offset, total, group=None):
        y = gather(x, offset, total, group)
        keep = torch.zeros_like(y)
        keep[:total // 4] = y[:total // 4]
        return keep

    monkeypatch.setattr(distributed, "gather_rows", local_only)
    line = run(tiny("chimera5408_sharded.pt_4chip"))
    assert not line["correct"], line["checks"]
