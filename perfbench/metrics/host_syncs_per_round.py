"""Blocking host syncs a round: the calls of the engine's round path that
make the host wait for the card (`utils.metrics.host_sync`: convergence
reads, host reads of indices, copies of constants from host memory), the
engine's "host_syncs" over its "rounds" in the traced window, on the rank
that made the most. Nothing to read where the engine records no spans."""


def read(run):
    vals = [t["host_syncs"] / t["rounds"]
            for t in (r["timings"] or {} for r in run["ranks"])
            if "host_syncs" in t and t.get("rounds")]
    return max(vals) if vals else None
