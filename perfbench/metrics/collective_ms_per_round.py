"""Milliseconds a round of NCCL kernels on the card: the device time of
the trace's operations named nccl over the traced window, per round, on
the rank that spent the most. Nothing to read on one rank."""


def read(run):
    ranks = run["ranks"]
    if len(ranks) < 2:
        return None
    vals = [1e3 * r["trace"]["nccl_s"] / r["rounds"] for r in ranks
            if r["trace"] and r["trace"]["nccl_s"] > 0]
    return max(vals) if vals else None
