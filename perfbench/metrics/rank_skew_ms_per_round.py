"""Milliseconds a round between the first and the last rank to reach the
round's collective: each rank's "compute_ms_by_round" (its device time
from the previous round's all-reduce to this one's), the rounds aligned
by index, the largest less the smallest over the ranks, the mean over the
rounds of the traced window. The harness passes `timings` only in a
traced run, so the ranks run under torch.profiler, whose slower host
launches widen the gaps between them: the value reads above the skew of
untraced rounds. Nothing to read on one rank or where the engine records
no spans."""


def read(run):
    runs = [t["compute_ms_by_round"]
            for t in (r["timings"] or {} for r in run["ranks"])
            if t.get("compute_ms_by_round")]
    if len(runs) < 2 or len(runs) < len(run["ranks"]):
        return None
    rounds = min(len(x) for x in runs)
    skews = [max(x[k] for x in runs) - min(x[k] for x in runs)
             for k in range(rounds)]
    return sum(skews) / rounds
