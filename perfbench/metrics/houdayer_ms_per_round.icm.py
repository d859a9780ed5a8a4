"""Milliseconds a round in the Houdayer stage (the sub-replica pairing,
the disagreement labels' fixed-point loop and the moves): the engine's
"houdayer" stage timings of the traced window, per round, the highest
rank. Nothing to read where the engine has no such stage."""


def read(run):
    vals = [1e3 * r["timings"]["houdayer"] / r["rounds"] for r in run["ranks"]
            if r["timings"] and "houdayer" in r["timings"]]
    return max(vals) if vals else None
