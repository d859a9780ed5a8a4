"""Instance writers: edge-list .txt output (reference dialect).

Copies of ``nmc_tpu/io/writers.py`` (held byte-equal to it by
tests/test_torch_generate.py). The reference's contrived-instance generator
writes sign-flipped edge lists (contrived_instance_generator.py,
save_to_txt) that its own loaders read back with `J = -J`. `save_edgelist`
emits the same convention so files round-trip through io/loaders.py.
"""

from __future__ import annotations

import numpy as np

from ..core.problem import IsingProblem


def save_edgelist(path: str, problem: IsingProblem, *, negate: bool = True,
                  include_fields: bool = True) -> None:
    """Write `i j J_ij` lines (0-indexed), diagonal lines carrying h when
    `include_fields` and h is nonzero; sign-flipped when `negate` so that
    loaders (which apply J = -J, h = -h) reconstruct the problem."""
    sgn = -1.0 if negate else 1.0
    J = problem.J
    h = problem.h
    n = problem.n
    with open(path, "w") as f:
        f.write("#\n")
        if include_fields and np.any(h != 0):
            for i in range(n):
                if h[i] != 0:
                    f.write(f"{i} {i} {sgn * h[i]:.12g}\n")
        ii, jj = np.nonzero(np.triu(J, 1))
        for i, j in zip(ii, jj):
            f.write(f"{i} {j} {sgn * J[i, j]:.12g}\n")


def save_npy_pair(prefix: str, problem: IsingProblem) -> None:
    """Write J.npy / h.npy as consumed by the reference main() scripts."""
    np.save(f"{prefix}J.npy", problem.J)
    np.save(f"{prefix}h.npy", problem.h)
