"""Spin-flip attempts a second over the window: every rank's attempts of
the rounds the window completed, over the longest rank's window (host
clock, from the first round's enqueue to the synchronise after the last)."""


def read(run):
    ranks = run["ranks"]
    done = sum(r["work"]["attempts"] * r["rounds"] for r in ranks)
    return done / max(r["window_s"] for r in ranks)
