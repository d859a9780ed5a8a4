"""The round's sweeps against the chip's least time for them, in percent:
the bound of `work.py` (operations at the float32 peak, bytes at the HBM
peak, the larger; the per-flip phi update left out, so this is a floor)
over the measured time of the stage that runs the sweeps in the traced
window: the engine's "round" stage timings where it has stages, else the
whole window (EnsemblePT exposes no split; its sweep launch is most of a
round). The mean over ranks. Nothing to read without the card's peaks."""

from perfbench.work import bound_seconds


def read(run):
    if run["peaks"] is None:
        return None
    shares = []
    for r in run["ranks"]:
        t = r["timings"] or {}
        spent = t.get("round", r["window_s"])
        shares.append(100.0 * r["rounds"] * bound_seconds(r["work"], run["peaks"])
                      / spent)
    return sum(shares) / len(shares)
