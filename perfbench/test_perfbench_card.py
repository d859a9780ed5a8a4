"""On a card: each cell's run at its own size is correct, and its control
(the reference in a lower precision in the program's place, the one its
check file's limits were set from) is not.

    python3 -m pytest perfbench -m card

Each test skips inside itself where torch sees too few CUDA cards."""

import json
import os
import subprocess
import sys

import pytest
import torch

from perfbench import check, harness

ROOT = harness.ROOT


def _cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [(w["name"], w["chips"]) for w in json.load(f)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload,chips", _cells())
def test_a_short_run_is_correct_and_its_control_is_not(workload, chips):
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"{workload} needs {chips} CUDA cards")
    prec = check.control_precision(workload)
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "perfbench", "run.py"),
         "--workload", workload, "--seed", "2718281828459", "--seconds", "3",
         "--trace", "0", "--control", prec],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    control = next(json.loads(x.split(" ", 2)[2])
                   for x in out.stderr.splitlines()
                   if x.startswith(f"control {prec} "))
    ok, checks = check.verdict(control, check.load_limits(workload))
    assert not ok, checks
