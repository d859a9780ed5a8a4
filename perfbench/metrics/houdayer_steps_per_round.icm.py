"""Fixed-point steps a round of the Houdayer labels: the engine's
"houdayer_steps" (each step one propagation over every pair at once) over
its "rounds" in the traced window, the highest rank. Nothing to read where
the program does not count them."""


def read(run):
    vals = [t["houdayer_steps"] / t["rounds"]
            for t in (r["timings"] or {} for r in run["ranks"])
            if "houdayer_steps" in t and t.get("rounds")]
    return max(vals) if vals else None
