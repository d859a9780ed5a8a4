"""Chimera-raster helpers of the beam tier.

Holds `pad_to_chimera_grid`, a copy of ``nmc_tpu/beam_chimera.py``'s (held
equal to it by the tests), which the induced-tree refinement
(`refine.tree_refine_state`) uses to complete a partial raster. The beam
search itself (`solve_beam_chimera` and the strip refinement) is still to
be ported (ROADMAP.md, queue 1 item 3).
"""
from __future__ import annotations

import numpy as np

from .exact_chimera import chimera_layout

__all__ = ["pad_to_chimera_grid"]


def pad_to_chimera_grid(prob):
    """(padded_prob, rows, cols, n_orig) for partial-raster chimeras.

    The DCL instances are chimera rasters with an incomplete last row
    (e.g. 119 cells on a 16-wide grid); appending zero-coupled cells
    completes the rectangle without changing any state's energy. Returns
    the problem unchanged when it already validates. Raises ValueError
    when the coupling pattern is not a chimera raster at all.
    """
    from .core.problem import IsingProblem

    J = np.asarray(prob.J, np.float64)
    h = np.asarray(prob.h, np.float64)
    n = J.shape[0]
    if n % 8 == 0:
        try:
            rows, cols = chimera_layout(J)
            return prob, rows, cols, n
        except ValueError:
            pass
    ii, jj = np.nonzero(np.triu(J, 1))
    ci, cj, ki = ii // 8, jj // 8, ii % 8
    inter = ci != cj
    d = cj[inter] - ci[inter]
    vert = np.unique(d[ki[inter] < 4])
    if vert.size != 1:
        raise ValueError("cannot infer chimera grid width")
    cols = int(vert[0])
    cells = -(-n // 8)
    rows = -(-cells // cols)
    n_pad = rows * cols * 8
    J2 = np.zeros((n_pad, n_pad))
    J2[:n, :n] = J
    h2 = np.zeros(n_pad)
    h2[:n] = h
    chimera_layout(J2, rows, cols)     # validates; raises if non-chimera
    return IsingProblem(J2, h2), rows, cols, n
