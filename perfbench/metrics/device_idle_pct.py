"""The share of the traced window in which no operation ran on the card,
in percent (torch.profiler, CPU and CUDA activity); the mean over ranks."""


def read(run):
    sums = [r["trace"] for r in run["ranks"] if r["trace"]]
    if not sums:
        return None
    return sum(100.0 * (1.0 - s["busy_s"] / s["window_s"])
               for s in sums) / len(sums)
