"""Campaign-record helpers shared by the summary table and, later, the
figures: a copy of ``miss_residuals`` from ``nmc_tpu/utils/plotting.py``
(the figures themselves are not ported yet)."""


def miss_residuals(records):
    """Sorted relative miss residuals (%) from campaign records, skipping
    hits and records without a usable ground truth (None or NaN gs_raw /
    residual — the contrived family ships no exact truths). Shared by
    the summary table and the campaign figures so the two can't drift."""
    out = []
    for r in records:
        if r.get("hit"):
            continue
        res, gs = r.get("residual"), r.get("gs_raw")
        if res is None or gs is None or res != res or gs != gs or not gs:
            continue
        out.append(abs(res) / abs(gs) * 100)
    return sorted(out)
