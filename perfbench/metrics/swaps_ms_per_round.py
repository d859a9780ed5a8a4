"""Milliseconds a round in the best fold and label swaps: the engine's
"swaps" stage timings of the traced window, per round (the highest rank)."""


def read(run):
    vals = [1e3 * r["timings"]["swaps"] / r["rounds"] for r in run["ranks"]
            if r["timings"] and "swaps" in r["timings"]]
    return max(vals) if vals else None
