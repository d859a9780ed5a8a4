"""The 95th percentile of the window's round times: CUDA events recorded
between consecutive rounds on the card's stream, read after the window's
last synchronise, so a round's time includes the card's waits for the
host; over every round of the window, the highest rank's."""


def read(run):
    values = [run["p95"](r["round_ms"]) for r in run["ranks"]]
    values = [v for v in values if v is not None]
    return max(values) if values else None
