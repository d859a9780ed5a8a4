"""Structured run records (JSONL), the subset the NMC driver writes.

A trimmed counterpart of ``nmc_tpu/utils/metrics.py``: `MetricsLogger`
appends one JSON record per event to an optional file and keeps them in
memory. The NMC driver logs one `sweeps` record per phase (with its wall
time) and one `clusters` record per cycle; APT logs one `apt_rung` record
per rung and NPT one `swap` and one `sweeps` record per swap round.
`timed` logs a section's wall time, `device_trace` captures a
`torch.profiler` trace of a section (the JAX package's uses
jax.profiler), and `RoundSpans`, with `count` and `host_sync`, times and
counts the stages of the ensemble engines' rounds without synchronising
the card.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import json
import logging
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

logger = logging.getLogger("nmc_tpu_torch")


def _to_jsonable(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


@dataclasses.dataclass
class MetricsLogger:
    """Append-only JSONL metrics sink + in-memory records."""

    path: Optional[str] = None
    echo: bool = False
    records: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def log(self, kind: str, **fields):
        rec = {"kind": kind, "t": time.time()}
        rec.update({k: _to_jsonable(v) for k, v in fields.items()})
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self.echo:
            logger.info("%s %s", kind, {k: v for k, v in rec.items()
                                        if k not in ("kind", "t")})
        return rec

    def of_kind(self, kind: str) -> List[Dict[str, Any]]:
        return [r for r in self.records if r["kind"] == kind]

    def sweep_stats(self, *, phase: str, num_sweeps: int, num_chains: int,
                    num_spins: int, seconds: float, min_energy: float):
        attempts = num_sweeps * num_chains * num_spins
        return self.log("sweeps", phase=phase, num_sweeps=num_sweeps,
                        num_chains=num_chains, num_spins=num_spins,
                        seconds=seconds,
                        attempts_per_sec=attempts / max(seconds, 1e-12),
                        min_energy=min_energy)

    def swap_stats(self, *, round_index: int, pairs, accepted,
                   energies=None):
        return self.log("swap", round_index=round_index, pairs=pairs,
                        accepted=accepted, energies=energies)

    def apt_rung(self, *, rung: int, beta: float, sigma_E: float,
                 seconds: float):
        return self.log("apt_rung", rung=rung, beta=beta, sigma_E=sigma_E,
                        seconds=seconds)

    def cluster_stats(self, *, cycle: int, sizes, seconds: float = 0.0):
        return self.log("clusters", cycle=cycle, sizes=sizes,
                        total=int(np.sum(sizes)) if len(sizes) else 0,
                        seconds=seconds)


@contextlib.contextmanager
def timed(metrics: Optional[MetricsLogger], kind: str, **fields) -> Iterator[dict]:
    """Time a section; logs `kind` with a `seconds` field on exit."""
    box: Dict[str, Any] = {}
    t0 = time.perf_counter()
    try:
        yield box
    finally:
        box["seconds"] = time.perf_counter() - t0
        if metrics is not None:
            metrics.log(kind, seconds=box["seconds"],
                        **{k: v for k, v in {**fields, **box}.items()
                           if k != "seconds"})


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a `torch.profiler` trace (the host, and the card where one
    is present) around a section and write it to `log_dir` as a Chrome
    trace (`trace.json`, which Perfetto and chrome://tracing read)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ---- round spans ----------------------------------------------------------

# the round whose spans are open in this thread (None: nothing records)
_ROUND: contextvars.ContextVar = contextvars.ContextVar("round_spans",
                                                        default=None)
_OFF = contextlib.nullcontext()


def count(name: str, k: int = 1) -> None:
    """Add `k` to counter `name` of the open round, if a round records."""
    rnd = _ROUND.get()
    if rnd is not None:
        rnd.counts[name] = rnd.counts.get(name, 0) + k


def host_sync(fn: Callable, *args, **kw):
    """`fn(*args, **kw)`, a call that makes the host wait for the card's
    stream: a device-to-host read (`bool`, `int`, `.tolist()` of a device
    tensor) or a copy from pageable host memory (`torch.tensor(x,
    device=...)`). Every such call on an engine's round path goes through
    here; while a round records, it is counted ("host_syncs") and its wait
    is left out of the round's host seconds."""
    rnd = _ROUND.get()
    if rnd is None:
        return fn(*args, **kw)
    t = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        rnd.syncs += 1
        rnd.blocked_s += time.perf_counter() - t


class RoundSpans:
    """The stage spans and counters of one engine's rounds, summed into the
    `timings` dict its caller passes.

    An engine opens `round(timings)` around each round and `stage(name)`
    around each stage inside it. With a dict, a stage span enters
    `torch.profiler.record_function("<engine>.<name>")`, so it lies on the
    profiler's timeline, records a CUDA event on the device's current
    stream at its start and end, and reads the host clock. Nothing
    synchronises: a round waits here until the card has passed its last
    event, and is then summed into its dict (`collect`, which never waits,
    runs after every round and after the engine's own host syncs such as
    `best`; `flush` waits for the last event). On the CPU host seconds
    stand in for device seconds.

    The dict gets each stage's device seconds under its name; "rounds", the
    rounds summed; "host_s", host seconds inside the round calls less the
    waits in `host_sync`; "host_syncs", the `host_sync` calls; each name
    that `count` filled inside a round, summed; and where a round marks
    "collective_in" / "collective_out" around a collective,
    "compute_ms_by_round": per round, the device ms from the previous
    round's "collective_out" (or this round's start) to "collective_in",
    when the rank arrives at the collective. Every value is an int, a float
    or a list of floats. Without a dict a round or stage costs a None
    check."""

    def __init__(self, engine: str, device):
        self.engine = engine
        self.cuda = device.type == "cuda"
        self.device = device
        self._pending = collections.deque()
        self._open = None      # the round being recorded
        self._prev = None      # the last round recorded, while unbroken

    def round(self, timings: Optional[Dict[str, Any]]):
        if timings is None:
            self._prev = None
            return _OFF
        return _Round(self, timings)

    def stage(self, name: str):
        rnd = self._open
        return _OFF if rnd is None else _Stage(rnd, name)

    def mark(self, name: str) -> None:
        """A named point of the open round (a CUDA event, or the host
        clock on the CPU)."""
        rnd = self._open
        if rnd is not None:
            rnd.marks[name] = rnd.point()

    def collect(self) -> None:
        """Sum every round the card has finished into its dict, oldest
        first, without waiting."""
        while self._pending:
            last = self._pending[0].last
            if last is not None and not last.query():
                return
            self._resolve(self._pending.popleft())

    def flush(self) -> None:
        """Wait for the last recorded event, then sum every pending round."""
        if self._pending and self._pending[-1].last is not None:
            self._pending[-1].last.synchronize()
        self.collect()

    def _resolve(self, rnd: "_Round") -> None:
        sink = rnd.sink
        for name, a, b in rnd.stages:
            sink[name] = sink.get(name, 0.0) + _seconds(a, b)
        sink["rounds"] = sink.get("rounds", 0) + 1
        sink["host_s"] = sink.get("host_s", 0.0) + rnd.host_s
        sink["host_syncs"] = sink.get("host_syncs", 0) + rnd.syncs
        for k, n in rnd.counts.items():
            sink[k] = sink.get(k, 0) + n
        arrive = rnd.marks.get("collective_in")
        if arrive is not None:
            prev = rnd.prev.marks.get("collective_out") if rnd.prev else None
            since = prev if prev is not None else rnd.stages[0][1]
            sink.setdefault("compute_ms_by_round", []).append(
                1e3 * _seconds(since, arrive))
        rnd.prev = None


def _seconds(a, b) -> float:
    """Seconds from point a to point b: CUDA events or host clock reads."""
    if isinstance(a, float):
        return b - a
    return 1e-3 * a.elapsed_time(b)


class _Round:
    def __init__(self, owner: RoundSpans, sink: Dict[str, Any]):
        self.owner, self.sink = owner, sink
        self.stages = []       # (name, start point, end point)
        self.marks = {}
        self.counts = {}
        self.syncs = 0
        self.blocked_s = 0.0
        self.last = None       # the last CUDA event recorded
        self.prev = owner._prev

    def point(self):
        if not self.owner.cuda:
            return time.perf_counter()
        import torch
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.owner.device))
        self.last = ev
        return ev

    def __enter__(self):
        self.owner._open = self
        self._token = _ROUND.set(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, kind, value, tb):
        self.host_s = time.perf_counter() - self._t0 - self.blocked_s
        _ROUND.reset(self._token)
        owner = self.owner
        owner._open = None
        if kind is None:
            owner._prev = self
            owner._pending.append(self)
            owner.collect()
        else:
            owner._prev = None
        return False


class _Stage:
    def __init__(self, rnd: _Round, name: str):
        self.rnd, self.name = rnd, name

    def __enter__(self):
        from torch.profiler import record_function
        self._mark = record_function(f"{self.rnd.owner.engine}.{self.name}")
        self._mark.__enter__()
        self._start = self.rnd.point()
        return self

    def __exit__(self, kind, value, tb):
        rnd = self.rnd
        rnd.stages.append((self.name, self._start, rnd.point()))
        self._mark.__exit__(kind, value, tb)
        return False
