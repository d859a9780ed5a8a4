"""Milliseconds a round in the backbone refresh (LBP and masks): the
engine's "lbp" stage timings of the traced window, per round. Nothing to
read where the traffic has no NMC labels or the engine has no stages."""


def read(run):
    if not run["traffic"].get("nmc_coldest"):
        return None
    vals = [1e3 * r["timings"]["lbp"] / r["rounds"] for r in run["ranks"]
            if r["timings"] and "lbp" in r["timings"]]
    return max(vals) if vals else None
