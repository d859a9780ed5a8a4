"""Host milliseconds a round inside the engine's round call, less the
waits in the calls that block on the card: the engine's "host_s" over its
"rounds" in the traced window (`utils.metrics.RoundSpans`), on the rank
that spent the most. The harness passes `timings` only in a traced run,
so the value is read under torch.profiler, which slows the host's
launches: it reads above the host time of an untraced round. Nothing to
read where the engine records no spans (an engine runner that passes no
`timings`, or a program without them)."""


def read(run):
    vals = [1e3 * t["host_s"] / t["rounds"]
            for t in (r["timings"] or {} for r in run["ranks"])
            if "host_s" in t and t.get("rounds")]
    return max(vals) if vals else None
