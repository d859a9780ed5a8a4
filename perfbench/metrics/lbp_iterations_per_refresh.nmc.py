"""LBP iterations a backbone refresh: the trips of the convergence loop
summed over the lambda ladder's rungs (the engine's "lbp_iterations"),
over the ladders solved (its "lbp_refreshes"), in the traced window, on
the rank that ran the most. Nothing to read where the traffic has no NMC
labels, no refresh ran, or the engine records no spans."""


def read(run):
    if not run["traffic"].get("nmc_coldest"):
        return None
    vals = [t["lbp_iterations"] / t["lbp_refreshes"]
            for t in (r["timings"] or {} for r in run["ranks"])
            if t.get("lbp_refreshes") and "lbp_iterations" in t]
    return max(vals) if vals else None
