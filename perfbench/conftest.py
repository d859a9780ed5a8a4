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


def pytest_configure(config):
    # tiny cells are many small operations: one thread a test process
    import torch
    torch.set_num_threads(1)
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips inside the test without one")


def tiny_path(workload, root=ROOT):
    """perfbench/tiny/<workload>.json: the configuration keys the cell's
    tiny CPU version changes."""
    return os.path.join(root, "perfbench", "tiny", f"{workload}.json")


def tiny_cell(workload, root=ROOT):
    """The cell `workload` as BENCHMARK.json under `root` resolves it, at a
    size the CPU runs in seconds."""
    from perfbench import harness
    cell = harness.resolve(workload, root)
    cell["config"] = {**cell["config"],
                      **harness.load_json(tiny_path(workload, root))}
    return cell


@pytest.fixture
def tiny():
    return tiny_cell
