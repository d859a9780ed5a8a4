"""nmc_tpu_torch — the PyTorch/CUDA port of nmc_tpu (Nonlocal Monte Carlo).

Runs the NMC solver on graph-colored blocks with its colored sweep kernel
hand-written in CUDA for Hopper (csrc/colored_sweeps.cu, built with nvcc on
first use). Module paths and public names mirror ``nmc_tpu``; the JAX
package stays the reference the port is tested against, and nothing here
imports JAX.

This first slice covers the problem containers, colouring, generators and
loaders, energies, the sweep engine (plain torch and the CUDA kernel),
dense LBP, backbone clusters and the NMC driver with its CLI.
"""

from . import device  # noqa: F401  (sets the full-f32 matmul policy)
from .core.energy import energy, energy_from_fields, local_fields
from .core.problem import BlockedProblem, IsingProblem, block_problem
from .models.nmc import NMCConfig, NMCResult, nmc_run, nmc_subroutine
from .ops.clusters import cluster_mask, find_clusters, flatten_clusters
from .ops.coloring import color_groups, greedy_coloring, num_colors
from .ops.engine import SweepEngine
from .ops.lbp import (atanh_saturated, convexification_epsilon,
                      lbp_convexified, lbp_convexified_batch,
                      loopy_belief_propagation)
from .ops.sweeps_cuda import colored_sweeps, colored_sweeps_reference

__version__ = "0.1.0"

__all__ = [
    "IsingProblem", "BlockedProblem", "block_problem",
    "energy", "energy_from_fields", "local_fields",
    "SweepEngine", "colored_sweeps", "colored_sweeps_reference",
    "NMCConfig", "NMCResult", "nmc_run", "nmc_subroutine",
    "loopy_belief_propagation", "lbp_convexified", "lbp_convexified_batch",
    "atanh_saturated", "convexification_epsilon",
    "find_clusters", "flatten_clusters", "cluster_mask",
    "greedy_coloring", "color_groups", "num_colors",
]
