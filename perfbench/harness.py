"""One run of one cell: set-up, the measured window, the output check.

`run_rank` runs on one card (one rank of a cell on several cards): it
makes the inputs from the seed, builds the engine and warms up every shape
the traffic uses (the set-up), then drives one round at a time for the
window's seconds, the periodic best call every `best_every` rounds,
recording a CUDA event between consecutive rounds. The window ends on a
synchronise after its last round; on several ranks the ranks agree on the
last round at a best call. With `trace` the window runs under
torch.profiler and hands the engine a `timings` dict, into which it sums
its stage spans: CUDA events between stages, read once the card has
passed a round, with no synchronise between stages. After the window: the
peak memory, then the output check (`check.py`) against the reference
once the engine is freed.

`assemble` turns the ranks' records into the result line, reading each of
the cell's metrics with its reader `metrics/<name>.py`.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check, work
from .instances import chain_generator, make_inputs
from .reference.precision import Precision, full_float32

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "nmc_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def resolve(workload: str, root: str = ROOT) -> Dict:
    """The cell of BENCHMARK.json named `workload`, with its configuration,
    traffic mix, metrics and check limits, all found by name under `root`:
    BENCHMARK.json and the configuration's file there, the traffic mix and
    the check limits in its perfbench/."""
    bench = load_json(root, "BENCHMARK.json")
    here = os.path.join(root, "perfbench")
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    metrics = {}
    for kind in ("end_to_end", "per_layer"):
        metrics[kind] = [m for m in bench[kind]
                         if cell["name"] in m.get("workloads", [cell["name"]])]
    return dict(name=workload, chips=cell["chips"], config=load_json(root, conf["file"]),
                traffic=load_json(here, "traffic", f"{cell['traffic']}.json"),
                limits=check.load_limits(workload, here),
                replayed=check.load_check(workload, here).get("replayed", 2),
                run_seconds=bench["run_seconds"], metrics=metrics)


def forbidden_modules() -> List[str]:
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def _engine_modules(name: str):
    return (importlib.import_module(f"perfbench.engines.{name}"),
            importlib.import_module(f"perfbench.reference.{name}"))


def replay_round(traffic: Dict, seed: int) -> int:
    """The absolute index of the first window round the check follows:
    drawn from the seed among the first 12 backbone refreshes after the
    warm-up (every 8th round where the traffic has none)."""
    every = traffic.get("lbp_every", 8)
    return every * int(np.random.default_rng(seed).integers(1, 13))


def power_limit_w(device) -> Optional[float]:
    """The card's power limit in watts (nvidia-smi), or None where it cannot
    be read: a roofline share is stated beside it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", str(device.index or 0)], capture_output=True, text=True,
            timeout=20)
        return float(out.stdout.strip())
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_rank(cell: Dict, seed: int, seconds: float, trace: bool, *,
             t_process: float, rank: int = 0, world: int = 1,
             device=None, group=None, controls=()) -> Dict:
    """The record of one rank: counts, times, trace summary, check tally;
    with `controls` (precision names) also the tallies of those controls,
    which only the calibration of a check's limits runs."""
    cfg, tr = cell["config"], cell["traffic"]
    device = torch.device(device) if device else torch.device("cuda", rank)
    full_float32()
    split = {}
    split["start_s"] = time.time() - t_process
    t = time.perf_counter()
    inputs = make_inputs(cfg, tr, seed, device)
    _sync(device)
    split["instances_s"] = time.perf_counter() - t
    eng_mod, ref_mod = _engine_modules(cfg["engine"])
    t = time.perf_counter()
    engine = eng_mod.Engine(inputs, device, group)
    _sync(device)
    split["engine_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if device.type == "cuda":
        from nmc_tpu_torch.ops._build import load_library
        for lib in eng_mod.LIBRARIES:
            load_library(lib)
    split["kernels_s"] = time.perf_counter() - t

    # warm-up: the first rounds (a backbone refresh, then a plain round)
    # and a best call, through the window's own calls
    t = time.perf_counter()
    gen = chain_generator(seed, device)
    snaps = dict(gen0=gen.get_state())
    state = engine.init(gen)
    snaps["init"] = engine.export(state)
    snaps["gen1"] = gen.get_state()
    state, extra = engine.round(state)
    snaps["round1"] = engine.export(state, extra)
    state, extra = engine.round(state)
    engine.best(state)
    _sync(device)
    split["warmup_s"] = time.perf_counter() - t

    first = replay_round(tr, seed)
    replayed = cell["replayed"]
    best_every = tr["best_every"]
    answers = []
    timings = {} if trace else None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        window_mark = record_function("perfbench.window")
        window_mark.__enter__()
    if group is not None:
        torch.distributed.barrier()
    _sync(device)
    timer = device.type == "cuda"
    events = []
    t0_wall = time.time()
    t0 = time.perf_counter()
    if timer:
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    rounds = 0
    while True:
        if state.round_index == first:
            snaps["before"] = engine.export(state)
            snaps["gen_before"] = gen.get_state()
        state, extra = engine.round(state, timings)
        rounds += 1
        if first < state.round_index <= first + replayed:
            snaps[f"after{state.round_index - first}"] = engine.export(state, extra)
        stop = False
        if rounds % best_every == 0:
            answers.append(engine.best(state))
            stop = time.perf_counter() - t0 >= seconds
            if group is not None:
                flag = torch.tensor([float(stop)])
                torch.distributed.all_reduce(
                    flag, op=torch.distributed.ReduceOp.MAX)
                stop = bool(flag.item())
        elif group is None:
            stop = time.perf_counter() - t0 >= seconds
        if timer:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        if stop and state.round_index >= first + replayed:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    summary = None
    if trace:
        window_mark.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        from .trace import export_and_summarize
        summary = export_and_summarize(prof)
    round_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    peak = torch.cuda.max_memory_allocated(device) if timer else 0
    answers.append(engine.best(state))
    found = forbidden_modules()

    # the output check, once the engine is freed
    del engine, state, extra
    if timer:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = ref_mod.Reference(inputs, device, rank, world)
    tally = verify(ref, snaps, inputs, answers)
    check_s = time.perf_counter() - t
    ctl = {p: control(ref, snaps, inputs, Precision(p)) for p in controls}
    rec = dict(rank=rank, rounds=rounds, window_s=window_s, round_ms=round_ms,
               setup_s=t0_wall - t_process, setup_split=split,
               work=work.round_work(cfg, inputs.J, world),
               memory_peak_bytes=int(peak), timings=timings, trace=summary,
               tally=tally, check_s=check_s, controls=ctl, forbidden=found,
               kind=(torch.cuda.get_device_name(device) if timer else "cpu"),
               power_limit_w=power_limit_w(device) if trace and timer else None)
    return rec


def _replayed(snaps: Dict) -> int:
    return sum(1 for k in snaps if k.startswith("after"))


def verify(ref, snaps: Dict, inputs, answers,
           prec: Precision = Precision()) -> Dict:
    """The tally of the program's exported states and answers against the
    reference `ref` (computing in `prec`)."""
    t = check.empty_tally()
    start = ref.initial(snaps["gen0"])
    check.compare_state(t, snaps["init"], start)
    (r1,) = ref.replay(start, snaps["gen1"], 1, prec)
    check.compare_state(t, snaps["round1"], r1)
    outs = ref.replay(snaps["before"], snaps["gen_before"], _replayed(snaps),
                      prec)
    for k, r in enumerate(outs, 1):
        check.compare_state(t, snaps[f"after{k}"], r)
    for e, m in answers:
        check.best_gap(t, inputs.J, inputs.h, e, m)
    return t


def control(ref, snaps: Dict, inputs, prec: Precision) -> Dict:
    """The tally of the reference computed in `prec`, put in the program's
    place, against the reference in float32: the same rounds from the same
    states, and the lower precision's bests against their float64
    energies."""
    t = check.empty_tally()
    f32 = Precision()
    start = ref.initial(snaps["gen0"])
    pairs = [(ref.replay(start, snaps["gen1"], 1, prec),
              ref.replay(start, snaps["gen1"], 1, f32))]
    before, n = snaps["before"], _replayed(snaps)
    pairs.append((ref.replay(before, snaps["gen_before"], n, prec),
                  ref.replay(before, snaps["gen_before"], n, f32)))
    for low, full in pairs:
        for a, b in zip(low, full):
            check.compare_state(t, a, b)
            check.best_gap(t, inputs.J, inputs.h, a["e_best"].cpu().numpy(),
                           ref.original_order(a["m_best"]).cpu().numpy())
    return t


def _p95(xs: List[float]) -> Optional[float]:
    return statistics.quantiles(xs, n=20)[-1] if len(xs) >= 2 else None


def assemble(cell: Dict, recs: List[Dict], trace: bool) -> Dict:
    """The result line of a cell from its ranks' records."""
    kind = recs[0]["kind"]
    run = dict(ranks=recs, config=cell["config"], traffic=cell["traffic"],
               peaks=work.load_peaks(kind), p95=_p95)
    kinds = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell["metrics"][kinds]:
        value = read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    tally = check.merge([r["tally"] for r in recs])
    nums = check.numbers(tally)
    correct, checks = check.verdict(nums, cell["limits"])
    device = dict(platform="gpu" if kind != "cpu" else "cpu", kind=kind,
                  count=len(recs),
                  memory_peak_bytes=max(r["memory_peak_bytes"] for r in recs))
    line = dict(correct=correct, attempted=recs[0]["rounds"],
                failed=0, metrics=metrics, device=device)
    if trace:
        sums = [r["trace"] for r in recs]
        device["busy_s"] = statistics.mean(s["busy_s"] for s in sums)
        device["window_s"] = statistics.mean(s["window_s"] for s in sums)
        device["power_limit_w"] = [r["power_limit_w"] for r in recs]
        worst = max(sums, key=lambda s: s["window_s"] - s["busy_s"])
        line["breakdown"] = dict(device_ops=[list(x) for x in sums[0]["device_ops"]],
                                 idle_gaps=[list(x) for x in worst["idle_gaps"]])
    line["checks"] = checks
    return line


def read_metric(name: str, run: Dict):
    """The value of metric `name` read by `metrics/<name>.py`, or None."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)
