"""The figures and PNG artifacts of the reference, same filenames.

A copy of ``nmc_tpu/utils/plotting.py``: NMC_spins.png / NMC_energy.png
(the reference's NMC/nmc.py:522-641), NPT_energy.png (NPT/npt.py:702-717),
APT_ICM_energy..png (NPT/apt_ICM.py:307-322; the double dot kept for
artifact-name parity), beta_sigma.png (NPT/apt_preprocessor.py:206-231),
and the campaign figures (time-to-solution and miss residuals, hardness
curve and surface, residual traces); `miss_residuals` is shared with the
campaign's summary table.

matplotlib is imported lazily with the Agg backend, so that nothing
touches a display and a machine without matplotlib (the card's) imports
this module: there `_plt()` raises an ImportError that names the missing
package, which the compat shims turn into a warning.
"""

from __future__ import annotations

import os

import numpy as np


def _plt():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the figures need matplotlib, which is not "
                          "installed", name="matplotlib") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _phase_marks(ax, phase_labels, phase_lengths, y):
    colors = {"C": "red", "NC": (0, 0.5, 0), "ALL": "blue"}
    x = 0
    for label, length in zip(phase_labels, phase_lengths):
        x += length
        ax.axvline(x=x, color="k", linewidth=2)
        ax.text(x - length / 2, y, label, fontsize=12, ha="center",
                color=colors.get(label, "k"), fontweight="bold")


def plot_nmc_results(M_overall, energy_overall, all_clusters, phase_labels,
                     phase_lengths, M_skip=1, prefix=""):
    """Cluster/non-cluster spin heatmaps + energy trace (chain 0)."""
    plt = _plt()
    M = np.asarray(M_overall)
    if M.ndim == 3:          # [T, R, n] -> chain 0, reference layout [n, T]
        M = M[:, 0, :].T
    e = np.asarray(energy_overall)
    if e.ndim == 2:
        e = e[:, 0]
    n = M.shape[0]
    clusters = np.asarray(all_clusters, dtype=int)
    non_clusters = np.setdiff1d(np.arange(n), clusters)

    fig, axes = plt.subplots(2, 1, figsize=(10, 10))
    for ax, rows, ylab in ((axes[0], clusters, "cluster index"),
                           (axes[1], non_clusters, "non-cluster index")):
        if rows.size:
            ax.imshow(M[rows], aspect="auto", cmap="viridis")
        ax.set_xlabel("number of sweeps", fontsize=14, fontweight="bold")
        ax.set_ylabel(ylab, fontsize=14, fontweight="bold")
        _phase_marks(ax, phase_labels,
                     [pl // M_skip for pl in phase_lengths], -5)
    fig.tight_layout()
    fig.savefig(f"{prefix}NMC_spins.png")
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(10, 5))
    ax.plot(np.arange(0, e.size * M_skip, M_skip)[: e.size], e)
    ax.set_xlabel("number of sweeps", fontsize=14, fontweight="bold")
    ax.set_ylabel("energy", fontsize=14, fontweight="bold")
    ymin, ymax = float(np.min(e)), float(np.max(e))
    ax.set_ylim([ymin, ymax])
    _phase_marks(ax, phase_labels, phase_lengths,
                 ymin + 0.05 * (ymax - ymin))
    fig.tight_layout()
    fig.savefig(f"{prefix}NMC_energy.png")
    plt.close(fig)


def plot_energies(energy_traces, beta_list, filename="NPT_energy.png"):
    """Per-replica energy traces (reference plot_energies)."""
    plt = _plt()
    fig = plt.figure()
    for i, trace in enumerate(energy_traces):
        plt.plot(np.asarray(trace),
                 label=f"Replica {i + 1} (β={float(beta_list[i]):.2f})")
    plt.xlabel("Sweeps")
    plt.ylabel("Energy")
    plt.title("Energy traces for different replicas")
    plt.legend()
    fig.savefig(filename)
    plt.close(fig)


def plot_beta_sigma(beta, sigma, filename="beta_sigma.png"):
    """APT schedule diagnostics (reference plot_results)."""
    plt = _plt()
    fig, ax1 = plt.subplots()
    ax1.plot(beta, marker="*", linewidth=2, markersize=6, label="beta")
    ax1.set_ylabel("beta")
    ax2 = ax1.twinx()
    ax2.plot(sigma, marker=">", linewidth=2, markersize=6,
             color="tab:orange", label="sigma")
    ax2.set_ylabel("sigma")
    ax1.set_xlabel("iteration")
    ax1.legend(loc="upper left")
    ax2.legend(loc="upper right")
    fig.savefig(filename)
    plt.close(fig)


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


def plot_campaign(jsonl_paths, out_png="campaign.png"):
    """Per-(family, arm) time-to-solution curves and miss residuals from
    campaign JSONL files (the round-2 analogue of the reference's
    plot_results artifacts): left panel, fraction of instances solved vs
    wall-clock; right panel, per-instance relative residuals for misses."""
    import json

    plt = _plt()

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.2))
    labels = []
    for path in jsonl_paths:
        rs = [json.loads(l) for l in open(path)]
        if not rs:
            continue
        meta = rs[0].get("meta", {})
        label = f"{meta.get('family', '?')}/{meta.get('arm', '?')}"
        labels.append(label)
        tts = sorted(r["hit_seconds"] for r in rs if r["hit"])
        n = len(rs)
        if tts:
            xs = [0.0] + tts
            ys = [0.0] + [(i + 1) / n for i in range(len(tts))]
            ax1.step(xs, ys, where="post", label=label)
        miss = miss_residuals(rs)
        if miss:
            ax2.plot(range(1, len(miss) + 1), miss, "o-", label=label,
                     markersize=3)
    ax1.set_xlabel("wall-clock (s, shared ensemble)")
    ax1.set_ylabel("fraction of instances at ground state")
    ax1.set_ylim(0, 1.02)
    ax1.legend(fontsize=7)
    ax1.set_title("time-to-solution")
    ax2.set_xlabel("instance rank")
    ax2.set_ylabel("residual above ground state (%)")
    ax2.set_yscale("log")
    ax2.legend(fontsize=7)
    ax2.set_title("miss residuals")
    fig.tight_layout()
    fig.savefig(out_png, dpi=130)
    plt.close(fig)
    return out_png


def plot_hardness_curve(jsonl_paths, out_png="hardness.png"):
    """Wishart hardness curve: ground-state hit rate (left) and median TTS
    over hits (right) vs the planting density alpha, one line per solver
    arm. Alpha is parsed from the campaign run/folder name
    (`..._a0.30_...` or `..._alpha_0.30...`)."""
    import json
    import re

    plt = _plt()

    series = {}       # arm -> {alpha: (hit_rate, tts_p50)}
    for path in jsonl_paths:
        rs = [json.loads(l) for l in open(path)]
        if not rs:
            continue
        meta = rs[0].get("meta", {})
        name = meta.get("family") or os.path.basename(path)
        m = re.search(r"(?:_a|alpha[_ ]?)(\d+\.\d+)", name) or \
            re.search(r"(?:_a|alpha[_ ]?)(\d+\.\d+)", os.path.basename(path))
        if not m:
            continue
        alpha = float(m.group(1))
        arm = meta.get("arm", "?")
        hits = [r for r in rs if r["hit"]]
        tts = sorted(r["hit_seconds"] for r in hits)
        p50 = tts[len(tts) // 2] if tts else None
        series.setdefault(arm, {})[alpha] = (len(hits) / len(rs), p50)

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    for arm in sorted(series):
        pts = sorted(series[arm].items())
        ax1.plot([a for a, _ in pts], [v[0] for _, v in pts], "o-",
                 label=arm)
        solved = [(a, v[1]) for a, v in pts if v[1] is not None]
        if solved:
            ax2.plot([a for a, _ in solved], [t for _, t in solved], "o-",
                     label=arm)
    ax1.set_xlabel("alpha")
    ax1.set_ylabel("ground-state hit rate")
    ax1.set_ylim(0, 1.05)
    ax1.legend()
    ax1.set_title("hardness curve")
    ax2.set_xlabel("alpha")
    ax2.set_ylabel("TTS p50 (s)")
    ax2.set_yscale("log")
    ax2.legend()
    ax2.set_title("median time-to-solution")
    fig.tight_layout()
    fig.savefig(out_png, dpi=130)
    plt.close(fig)
    return out_png


def plot_residual_trace(trace_paths, out_png="residual_trace.png",
                        labels=None):
    """Convergence curves from campaign `--trace` files: per-instance raw
    residual (best-so-far minus shipped ground energy) and cumulative hit
    count vs sweeps. One color per trace file (family/arm). The measured
    demonstration of what a sweep budget buys on the deep-budget chimera
    runs."""
    import json

    plt = _plt()

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    for ti, path in enumerate(trace_paths):
        rows = [json.loads(l) for l in open(path) if l.strip()]
        if not rows:
            continue
        label = (labels[ti] if labels else
                 os.path.basename(path).replace(".jsonl.trace", ""))
        sweeps = np.array([r["sweeps"] for r in rows], float)
        # a resumed rerun appends rows with fewer pending instances —
        # pad ragged rows with NaN so the quantiles stay well-defined
        width = max(len(r["residual_raw"]) for r in rows)
        res = np.full((len(rows), width), np.nan)
        for i, r in enumerate(rows):
            vals = [x if x is not None else np.nan
                    for x in r["residual_raw"]]
            res[i, :len(vals)] = vals
        color = f"C{ti}"
        med = np.nanmedian(res, axis=1)
        q90 = np.nanquantile(res, 0.9, axis=1)
        ax1.plot(sweeps, np.maximum(med, 1e-6), "-", color=color,
                 label=f"{label} (median)")
        ax1.plot(sweeps, np.maximum(q90, 1e-6), "--", color=color,
                 alpha=0.6, label=f"{label} (p90)")
        ax2.plot(sweeps, [r["hits"] for r in rows], "-", color=color,
                 label=f"{label} ({rows[-1]['hits']}/{res.shape[1]})")
    ax1.set_xlabel("sweeps")
    ax1.set_ylabel("raw energy residual to ground state")
    ax1.set_xscale("log")
    ax1.set_yscale("log")
    ax1.legend(fontsize=8)
    ax1.set_title("residual convergence")
    ax2.set_xlabel("sweeps")
    ax2.set_ylabel("instances at ground state")
    ax2.set_xscale("log")
    ax2.legend(fontsize=8)
    ax2.set_title("cumulative ground-state hits")
    fig.tight_layout()
    fig.savefig(out_png, dpi=130)
    plt.close(fig)
    return out_png


def plot_hardness_surface(jsonl_paths, out_png="hardness_surface.png",
                          metric="hit_rate"):
    """Wishart (N, alpha) hardness SURFACE: one panel per solver arm, a
    heatmap of ground-state hit rate (default) or median TTS over the
    shipped wishart_small grid. N and alpha are parsed from the campaign
    file/family names (`wishart_n40_a0.30_icm.jsonl` or
    `wishart_planting_N_40_alpha_0.30`)."""
    import json
    import re

    plt = _plt()

    cells = {}        # arm -> {(N, alpha): value}
    for path in jsonl_paths:
        rs = [json.loads(l) for l in open(path) if l.strip()]
        if not rs:
            continue
        meta = rs[0].get("meta", {})
        text = (meta.get("family") or "") + " " + os.path.basename(path)
        mn = re.search(r"(?:_n|N[_ ]?)(\d+)(?:_|\b)", text)
        ma = re.search(r"(?:_a|alpha[_ ]?)(\d+\.\d+)", text)
        if not (mn and ma):
            continue
        N, alpha = int(mn.group(1)), float(ma.group(1))
        arm = meta.get("arm", "?")
        hits = [r for r in rs if r["hit"]]
        if metric == "hit_rate":
            val = len(hits) / len(rs)
        else:
            tts = sorted(r["hit_seconds"] for r in hits)
            val = tts[len(tts) // 2] if tts else np.nan
        cells.setdefault(arm, {})[(N, alpha)] = val

    arms = sorted(cells)
    if not arms:
        raise ValueError("no (N, alpha) campaign rows found")
    Ns = sorted({k[0] for c in cells.values() for k in c})
    alphas = sorted({k[1] for c in cells.values() for k in c})
    fig, axes = plt.subplots(1, len(arms), figsize=(4 * len(arms), 3.4),
                             squeeze=False)
    for ax, arm in zip(axes[0], arms):
        grid = np.full((len(Ns), len(alphas)), np.nan)
        for (N, a), v in cells[arm].items():
            grid[Ns.index(N), alphas.index(a)] = v
        im = ax.imshow(grid, origin="lower", aspect="auto",
                       vmin=0, vmax=1 if metric == "hit_rate" else None,
                       cmap="viridis")
        ax.set_xticks(range(len(alphas)))
        ax.set_xticklabels([f"{a:g}" for a in alphas], fontsize=8)
        ax.set_yticks(range(len(Ns)))
        ax.set_yticklabels([str(n) for n in Ns], fontsize=8)
        ax.set_xlabel("alpha")
        ax.set_ylabel("N")
        ax.set_title(arm)
        for i in range(len(Ns)):
            for j in range(len(alphas)):
                if grid[i, j] == grid[i, j]:
                    ax.text(j, i, f"{grid[i, j]:.2f}", ha="center",
                            va="center", fontsize=7,
                            color="w" if grid[i, j] < 0.6 else "k")
        fig.colorbar(im, ax=ax, shrink=0.85)
    fig.suptitle("wishart planting hardness surface: "
                 + ("ground-state hit rate" if metric == "hit_rate"
                    else "median TTS (s)"))
    fig.tight_layout()
    fig.savefig(out_png, dpi=130)
    plt.close(fig)
    return out_png
