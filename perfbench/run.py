"""Run one cell of BENCHMARK.json on this machine's cards.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Prints one JSON object as the last line of standard output: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1` `breakdown`,
and last `checks`, each compared number beside its limit (also the last
lines of standard error). Exits non-zero and prints no result without
enough CUDA cards, when the output check cannot run, or when a module of
the JAX package or of JAX is loaded once the window has closed.

A cell on several cards starts one rank process per card (this script with
--rank), joined by torch.distributed over a localhost port; each writes its
record to a file under TMPDIR and this process prints the result.
"""

from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

RANK_TIMEOUT_S = 330


def _args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--out", default=None, help=argparse.SUPPRESS)
    p.add_argument("--t-process", type=float, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--control", default="",
                   help="comma-separated precisions (tf32, bfloat16) whose "
                        "control the run also computes and prints on "
                        "standard error: the readings a check's limits are "
                        "set from; the benchmark's runs never pass it")
    return p.parse_args(argv)


def _fail(msg: str, code: int = 2):
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(a):
    """One rank of a cell on several cards: join the group, run, write the
    record to `--out`."""
    from perfbench import harness
    from nmc_tpu_torch.parallel import distributed
    cell = harness.resolve(a.workload)
    distributed.initialize()
    import torch
    rec = harness.run_rank(cell, a.seed, a.seconds, bool(a.trace),
                           t_process=a.t_process, rank=a.rank, world=a.world,
                           device=torch.device("cuda", a.rank),
                           group=distributed.global_group(),
                           controls=_controls(a))
    with open(a.out, "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()


def _controls(a):
    return tuple(p for p in a.control.split(",") if p)


def _chips(workload: str) -> int:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = json.load(f)["workloads"]
    for w in cells:
        if w["name"] == workload:
            return w["chips"]
    _fail(f"no workload {workload!r} in BENCHMARK.json")


def _start_ranks(a, world: int):
    """Start `world` rank processes (before this process loads torch, so
    that their set-up overlaps its own)."""
    port = _free_port()
    tmp = tempfile.mkdtemp(prefix="perfbench-")
    procs, outs = [], []
    for k in range(world):
        out = os.path.join(tmp, f"rank{k}.json")
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   RANK=str(k), WORLD_SIZE=str(world), LOCAL_RANK=str(k))
        cmd = [sys.executable, os.path.abspath(__file__), "--workload",
               a.workload, "--seed", str(a.seed), "--seconds", str(a.seconds),
               "--trace", str(a.trace), "--rank", str(k), "--world",
               str(world), "--out", out, "--t-process", repr(T_PROCESS),
               "--control", a.control]
        procs.append(subprocess.Popen(cmd, env=env, stdout=sys.stderr))
        outs.append(out)
    return procs, outs, tmp


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def _collect(procs, outs, tmp):
    """Wait for every rank process; their records, or a failure."""
    deadline = time.time() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.time(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        _stop(procs)
    codes = [p.returncode for p in procs]
    recs = []
    for out in outs:
        if os.path.exists(out):
            with open(out) as f:
                recs.append(json.load(f))
            os.unlink(out)
    os.rmdir(tmp)
    if any(codes) or len(recs) != len(procs):
        _fail(f"rank processes ended with codes {codes}", 1)
    return recs


def main(argv=None):
    a = _args(argv)
    if a.rank is not None:
        return _rank_main(a)
    chips = _chips(a.workload)
    ranks = _start_ranks(a, chips) if chips > 1 else None
    import torch
    from perfbench import harness
    cell = harness.resolve(a.workload)
    missing = None
    if not torch.cuda.is_available():
        missing = "no CUDA card: torch.cuda.is_available() is false"
    elif torch.cuda.device_count() < chips:
        missing = (f"{a.workload} needs {chips} cards, torch sees "
                   f"{torch.cuda.device_count()}")
    if missing:
        if ranks:
            _stop(ranks[0])
        _fail(missing)
    if chips == 1:
        recs = [harness.run_rank(cell, a.seed, a.seconds, bool(a.trace),
                                 t_process=T_PROCESS, controls=_controls(a))]
    else:
        recs = _collect(*ranks)
    found = sorted(set(harness.forbidden_modules()).union(
        *(r["forbidden"] for r in recs)))
    if found:
        _fail("modules of JAX or of the JAX package are loaded: "
              + ", ".join(found), 3)
    for r in recs:
        print(f"perfbench: rank {r['rank']} set-up {r['setup_s']:.3f} s "
              f"{json.dumps(r['setup_split'])}, {r['rounds']} rounds in "
              f"{r['window_s']:.3f} s, check {r['check_s']:.1f} s",
              file=sys.stderr)
    from perfbench import check
    for p in _controls(a):
        nums = check.numbers(check.merge([r["controls"][p] for r in recs]))
        print(f"control {p} {json.dumps(nums)}", file=sys.stderr)
    print("sound " + json.dumps(check.numbers(
        check.merge([r["tally"] for r in recs]))), file=sys.stderr)
    line = harness.assemble(cell, recs, bool(a.trace))
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} <= {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
