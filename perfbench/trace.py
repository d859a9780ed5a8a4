"""Reading the torch.profiler trace of a traced window.

The window is marked by a `record_function` annotation. Device operations
(kernels, copies, sets) are clipped to it; their union is the busy time,
and the rest of the window is idle. Each idle stretch is put down to what
the host thread that launches the work was doing then: its innermost
operator or runtime call, or "host:no_operator" where it ran none.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

WINDOW = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime")


def _union(intervals: List[Tuple[float, float]]):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(events):
    """[(start, end, name)] pieces of the timeline of one thread, each
    named by the innermost event covering it."""
    pieces, stack, t = [], [], None
    marks = sorted([(e["ts"], 0, -e["dur"], i) for i, e in enumerate(events)]
                   + [(e["ts"] + e["dur"], 1, 0, i)
                      for i, e in enumerate(events)],
                   key=lambda x: (x[0], -x[1], x[2]))
    for time, kind, _, i in marks:
        if stack and t is not None and time > t:
            pieces.append((t, time, events[stack[-1]]["name"]))
        t = time
        if kind == 0:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
    return pieces


def summarize(path: str, top: int = 10) -> Dict:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace has no window annotation")
    w0 = win[0]["ts"]
    w1 = w0 + win[0]["dur"]
    dev = [(max(e["ts"], w0), min(e["ts"] + e["dur"], w1), e["name"])
           for e in events if e.get("cat") in DEVICE_CATS
           and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    by_name = defaultdict(float)
    nccl = 0.0
    for s, e, name in dev:
        by_name[name] += (e - s) * 1e-6
        if "nccl" in name.lower():
            nccl += (e - s) * 1e-6
    busy = _union([(s, e) for s, e, _ in dev])
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    host = [e for e in events if e.get("cat") in HOST_CATS]
    by_tid = defaultdict(list)
    for e in host:
        by_tid[(e.get("pid"), e.get("tid"))].append(e)
    main = max(by_tid.values(), key=len) if by_tid else []
    pieces = _innermost([e for e in main if e["ts"] < w1
                         and e["ts"] + e["dur"] > w0])
    idle = defaultdict(float)
    k = 0
    for g0, g1 in gaps:       # both in time order: one pass
        while k < len(pieces) and pieces[k][1] <= g0:
            k += 1
        covered, j = 0.0, k
        while j < len(pieces) and pieces[j][0] < g1:
            s, e, name = pieces[j]
            o = min(e, g1) - max(s, g0)
            if o > 0:
                idle[name] += o * 1e-6
                covered += o
            j += 1
        if g1 - g0 > covered:
            idle["host:no_operator"] += (g1 - g0 - covered) * 1e-6
    return dict(
        busy_s=busy_s, window_s=(w1 - w0) * 1e-6, nccl_s=nccl,
        device_ops=sorted(by_name.items(), key=lambda x: -x[1])[:top],
        idle_gaps=sorted(idle.items(), key=lambda x: -x[1])[:top])


def export_and_summarize(prof) -> Dict:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return summarize(path)
    finally:
        os.unlink(path)
