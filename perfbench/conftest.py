"""Test set-up for the benchmark's own tests: the repository root on the
path, the `card` marker for tests that need a CUDA card (they skip inside
the test where there is none), and tiny versions of the cells for the CPU.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the configuration keys a tiny CPU cell changes, per workload
TINY = {
    "chimera2048_x20.nmc": dict(instances={"family": "chimera", "m": 3,
                                           "t": 4, "count": 3}),
    "chimera2048_x20.pt": dict(instances={"family": "chimera", "m": 3,
                                          "t": 4, "count": 3}),
    "sk1000_x100.pt": dict(instances={"family": "sk", "n": 40, "count": 3},
                           sweeps_per_round=4),
    "chimera5408_sharded.pt_4chip": dict(
        instances={"family": "chimera", "m": 3, "t": 4, "count": 1}),
}
COMMON = dict(replicas=8, sweeps_per_phase=4, num_cycles=2,
              num_swapping_pairs=2, block_size=16)


def pytest_configure(config):
    # tiny cells are many small operations: one thread a test process
    import torch
    torch.set_num_threads(1)
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips inside the test without one")


def tiny_cell(workload):
    """The cell `workload` as BENCHMARK.json resolves it, at a size the CPU
    runs in seconds."""
    from perfbench import harness
    cell = harness.resolve(workload)
    cfg = dict(cell["config"])
    for k, v in {**COMMON, **TINY[workload]}.items():
        if k in cfg or k == "instances":
            cfg[k] = v
    cell["config"] = cfg
    return cell


@pytest.fixture
def tiny():
    return tiny_cell
