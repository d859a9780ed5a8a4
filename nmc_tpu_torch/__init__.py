"""nmc_tpu_torch — the PyTorch/CUDA port of nmc_tpu (Nonlocal Monte Carlo).

Runs the NMC solver on graph-colored blocks with its colored sweep kernel
hand-written in CUDA for Hopper (csrc/colored_sweeps.cu, built with nvcc on
first use). Module paths and public names mirror ``nmc_tpu``; the JAX
package stays the reference the port is tested against, and nothing here
imports JAX.

The port covers the problem containers, colouring, generators and
loaders, energies, the sweep engine with its three colored sweep kernels
(K1 dense, K2 dense streamed, K3 block-sparse; each with a plain torch
twin), dense and edge-message LBP, backbone clusters, the NMC driver, the
APT beta schedule, NPT replica exchange and checkpoints, with the
`nmc`/`apt`/`npt` CLI.
"""

from . import device  # noqa: F401  (sets the full-f32 matmul policy)
from .core.energy import energy, energy_from_fields, local_fields
from .core.problem import BlockedProblem, IsingProblem, block_problem
from .models.apt import APTConfig, APTResult, apt_preprocess
from .models.nmc import NMCConfig, NMCResult, nmc_run, nmc_subroutine
from .models.npt import NPTConfig, NPTResult, npt_run
from .ops.clusters import cluster_mask, find_clusters, flatten_clusters
from .ops.coloring import color_groups, greedy_coloring, num_colors
from .ops.engine import SweepEngine
from .ops.lbp import (atanh_saturated, convexification_epsilon,
                      lbp_convexified, lbp_convexified_batch,
                      loopy_belief_propagation)
from .ops.lbp_sparse import (EdgeGraph, sparse_lbp, sparse_lbp_convexified,
                             sparse_lbp_convexified_batch)
from .ops.sweeps_cuda import (colored_sweeps, colored_sweeps_reference,
                              colored_sweeps_sparse,
                              colored_sweeps_sparse_reference,
                              colored_sweeps_streamed,
                              colored_sweeps_streamed_reference)

__version__ = "0.1.0"

__all__ = [
    "IsingProblem", "BlockedProblem", "block_problem",
    "energy", "energy_from_fields", "local_fields",
    "SweepEngine", "colored_sweeps", "colored_sweeps_reference",
    "colored_sweeps_streamed", "colored_sweeps_streamed_reference",
    "colored_sweeps_sparse", "colored_sweeps_sparse_reference",
    "NMCConfig", "NMCResult", "nmc_run", "nmc_subroutine",
    "APTConfig", "APTResult", "apt_preprocess",
    "NPTConfig", "NPTResult", "npt_run",
    "loopy_belief_propagation", "lbp_convexified", "lbp_convexified_batch",
    "EdgeGraph", "sparse_lbp", "sparse_lbp_convexified",
    "sparse_lbp_convexified_batch",
    "atanh_saturated", "convexification_epsilon",
    "find_clusters", "flatten_clusters", "cluster_mask",
    "greedy_coloring", "color_groups", "num_colors",
]
