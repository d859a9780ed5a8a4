"""Seconds from the process's start to the first timed round: the inputs,
the engine's build (colouring, layouts, LBP structure), the kernels' load
(a build in a checkout's first run), the process group on several cards,
and the warm-up rounds; the latest rank's."""


def read(run):
    return max(r["setup_s"] for r in run["ranks"])
