"""BENCHMARK.json and the files it names: every cell resolves by name to
its configuration, traffic mix, check limits, metric readers, its engine's
runner and reference, and its tiny CPU size, and the file keeps to the
shapes its format sets."""

import json
import os
import re

import pytest

from perfbench import check, harness
from perfbench.conftest import tiny_path
from perfbench.reference import precision

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection",
               "head", "expansion", "experts_per_token")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"][:2] == ["python3", "perfbench/run.py"]
    assert b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_text_fields():
    b = bench()
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    for n in names:
        assert NAME.match(n), n
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in b[group]}) == len(b[group])
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in b["configs"] + b["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    for c in b["configs"]:
        assert 1 <= len(c["source"]) <= 200
        assert not any(w in k for k in c["reduced"] for w in WIDTH_WORDS)


def test_bounds_and_end_to_end_metrics():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m["workloads"]) <= {w["name"] for w in b["workloads"]}


def test_cells_and_chips():
    b = bench()
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = [w for w in b["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(b["workloads"]) // 4)
    assert {w["chips"] for w in b["workloads"]} <= {1, 4}
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}


WORKLOADS = [w["name"] for w in bench()["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_resolves(workload):
    cell = harness.resolve(workload)
    engine = cell["config"]["engine"]
    runner = os.path.join(harness.HERE, "engines", f"{engine}.py")
    reference = os.path.join(harness.HERE, "reference", f"{engine}.py")
    for path in (runner, reference):
        assert os.path.exists(path), f"{workload}: no {path}"
    eng_mod, ref_mod = harness._engine_modules(engine)
    assert hasattr(eng_mod, "Engine") and hasattr(eng_mod, "LIBRARIES"), runner
    assert hasattr(ref_mod, "Reference"), reference
    kinds = cell["metrics"]
    assert any(m["name"] == "setup_s" for m in kinds["end_to_end"])
    assert len(kinds["end_to_end"]) >= 2 and kinds["per_layer"]
    for m in kinds["end_to_end"] + kinds["per_layer"]:
        assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                           m["name"] + ".py")), m["name"]
    assert cell["limits"] and all(v > 0 for v in cell["limits"].values())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_has_a_tiny_cpu_size_and_one_control(workload):
    path = tiny_path(workload)
    assert os.path.exists(path), f"{workload}: no {path}"
    tiny = harness.load_json(path)
    config = harness.resolve(workload)["config"]
    assert tiny and set(tiny) <= set(config), (path, set(tiny) - set(config))
    assert check.control_precision(workload) in precision.KINDS


def test_config_files_match_their_entries():
    b = bench()
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"]
        assert conf["reduced"] == c["reduced"]
        assert c["file"].startswith("perfbench/configs/")


def test_file_names_are_made_of_name_characters():
    for dirpath, _, files in os.walk(harness.HERE):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
