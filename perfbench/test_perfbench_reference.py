"""The reference against the program at a tiny size on the CPU, through
the harness's own run of each cell: every compared number at or under its
limit, the states bit for bit."""

import time

import pytest

from perfbench import check, harness

CELLS = [w["name"] for w in
         harness.load_json(harness.ROOT, "BENCHMARK.json")["workloads"]]


def run(cell, seed=2147483665, trace=False):
    rec = harness.run_rank(cell, seed, 0.2, trace, t_process=time.time(),
                           device="cpu")
    return rec, harness.assemble(cell, [rec], trace)


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_program(tiny, workload):
    cell = tiny(workload)
    rec, line = run(cell)
    nums = check.numbers(rec["tally"])
    assert line["correct"], line["checks"]
    assert nums["spin_diff"] == 0 and nums["label_diff"] == 0
    if cell["traffic"]["nmc_coldest"] > 0:
        assert "mask_diff" in nums and nums["mask_diff"] == 0
    else:
        assert "mask_diff" not in nums
    assert rec["rounds"] >= 3 and list(line)[-1] == "checks"
    assert set(line) == {"correct", "attempted", "failed", "metrics",
                         "device", "checks"}


def test_a_traced_run_reports_the_per_layer_metrics(tiny):
    rec, line = run(tiny("chimera2048_x20.nmc"), trace=True)
    assert line["correct"]
    assert {"lbp_ms_per_round.nmc", "swaps_ms_per_round",
            "device_idle_pct"} <= set(line["metrics"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0


def test_the_same_seed_gives_the_same_inputs_and_check(tiny):
    cell = tiny("sk1000_x100.pt")
    a, _ = run(cell, seed=27)
    b, _ = run(cell, seed=27)
    assert a["tally"] == b["tally"]
