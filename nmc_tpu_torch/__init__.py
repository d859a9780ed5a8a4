"""nmc_tpu_torch — the PyTorch/CUDA port of nmc_tpu (Nonlocal Monte Carlo).

Runs the NMC solvers on graph-colored blocks with their kernels
hand-written in CUDA for Hopper (csrc/*.cu, built with nvcc on first use). Module paths and public names mirror ``nmc_tpu``; the JAX
package stays the reference the port is tested against, and nothing here
imports JAX.

The port covers the problem containers, colouring, generators and
loaders, energies, the sweep engine with its three colored sweep kernels
(K1 dense, K2 dense streamed, K3 block-sparse; each with a plain torch
twin), dense and edge-message LBP, backbone clusters, the NMC driver, the
APT beta schedule, NPT replica exchange and checkpoints, APT + Houdayer
ICM (`apt_icm_run`; host or batched device cluster moves), and the
campaign engines: `EnsembleNMC` (many instances x a replica ladder, whole
rounds through the round kernels K4 dense and K5 block-sparse, each with a
plain torch twin; in-round slotted-edge, edge-message or dense LBP; device
label swaps) and `EnsembleICM` (instances x sub-replicas x a ladder, the
sweep stage through K4/K5, batched device Houdayer moves), the exact
meet-in-the-middle solver (host, torch-tile and fused tiers; the fused tier
through the table kernels K6 f32 and K7 int8 digit planes, each with a
plain torch twin) with the chimera tropical DP and the native
branch-and-bound tier (`solve_exact_enum`), the leaf-peeling presolve, the
spectral search (host and torch device variants), the induced-tree
refinement, the staged portfolio solver (`portfolio_solve`), the chimera
beam tier (host `solve_beam_chimera` with strip refinement, and the int32
device beam `solve_beam_chimera_cuda` over torch's stable sorts), the
evaluation harness, and the `nmc`/`apt`/`npt`/`icm`/`evaluate`/`campaign`/
`solve`/`exact`/`beam`/`refine`/`generate`/`sharded` CLI. The sequential
fixed-order sweep of uncoloured layouts (the drivers' default) runs on the
card through its own kernel (`sequential_sweeps`, and over an instance axis
`sequential_sweeps_batched`); `EnsemblePT` runs instance ensembles of PT
ladders, one launch a round; the reference-compatible class shims
(NMC, NPT, APT_preprocessor, APT_ICM, with the faithful host kernel) live
in nmc_tpu_torch.compat, the figures in utils/plotting.py and the native
union-find in nmc_tpu_torch.native. The multi-GPU slice runs on
torch.distributed (nmc_tpu_torch.parallel: `ShardedNPT`,
`SpinShardedSweeper`, `distributed`, the ensembles' `group=`, and the
`sharded` CLI).
"""

from . import device  # noqa: F401  (sets the full-f32 matmul policy)
from .core.energy import energy, energy_from_fields, local_fields
from .core.problem import BlockedProblem, IsingProblem, block_problem
from .exact import (exact_energy_bound, solve_exact_device, solve_exact_enum,
                    solve_exact_fused, solve_exact_host)
from .beam_chimera import (pad_to_chimera_grid, refine_strips,
                           solve_beam_chimera, solve_beam_chimera_multi)
from .beam_chimera_cuda import solve_beam_chimera_cuda
from .exact_chimera import solve_exact_chimera
from .models.apt import APTConfig, APTResult, apt_preprocess
from .models.apt_icm import APTICMConfig, APTICMResult, apt_icm_run
from .models.nmc import NMCConfig, NMCResult, nmc_run, nmc_subroutine
from .models.npt import NPTConfig, NPTResult, npt_run
from .ops.clusters import (backbone_mask_device, cluster_mask,
                           find_clusters, flatten_clusters)
from .ops.coloring import color_groups, greedy_coloring, num_colors
from .ops.engine import SweepEngine
from .ops.exact_cuda import (mitm_min, mitm_min_i8, mitm_min_i8_reference,
                             mitm_min_reference)
from .ops.lbp import (atanh_saturated, convexification_epsilon,
                      lbp_convexified, lbp_convexified_batch,
                      loopy_belief_propagation)
from .ops.lbp_jit import (convexified_marginal_dense,
                          convexified_marginal_sparse)
from .ops.lbp_planes import (EdgeSlotPlanes, build_edge_slot_planes,
                             convexified_marginal_planes, w_slot_from_tiles)
from .ops.lbp_sparse import (EdgeGraph, sparse_lbp, sparse_lbp_convexified,
                             sparse_lbp_convexified_batch)
from .ops.presolve import Presolve, peel_leaves
from .ops.round_cuda import (EnsembleRoundResult, ensemble_round,
                             ensemble_round_reference, ensemble_round_sparse,
                             ensemble_round_sparse_reference)
from .ops.spectral import (SpectralResult, auto_subspace_dim,
                           batched_descent_device, batched_descent_host,
                           difference_map_rounding,
                           difference_map_rounding_device,
                           spectral_candidates, spectral_candidates_device,
                           spectral_search)
from .ops.sweeps_cuda import (colored_sweeps, colored_sweeps_reference,
                              colored_sweeps_sparse,
                              colored_sweeps_sparse_reference,
                              colored_sweeps_streamed,
                              colored_sweeps_streamed_reference,
                              sequential_sweeps, sequential_sweeps_batched)
from .portfolio import SolveResult, SolveStage, portfolio_solve
from .refine import partition_crossover, refine_family, tree_refine_state
from .tree_moves import tree_refine
from .parallel import (EnsembleConfig, EnsembleICM, EnsembleICMConfig,
                       EnsembleICMState, EnsembleNMC, EnsembleNMCState,
                       EnsemblePT, EnsembleState, ShardedNPTConfig,
                       metropolis_label_swap, select_pairs_device)

__version__ = "0.1.0"

__all__ = [
    "IsingProblem", "BlockedProblem", "block_problem",
    "energy", "energy_from_fields", "local_fields",
    "SweepEngine", "colored_sweeps", "colored_sweeps_reference",
    "colored_sweeps_streamed", "colored_sweeps_streamed_reference",
    "colored_sweeps_sparse", "colored_sweeps_sparse_reference",
    "sequential_sweeps", "sequential_sweeps_batched",
    "ensemble_round", "ensemble_round_reference", "ensemble_round_sparse",
    "ensemble_round_sparse_reference", "EnsembleRoundResult",
    "EnsembleNMC", "EnsembleNMCState", "ShardedNPTConfig",
    "EnsemblePT", "EnsembleConfig", "EnsembleState",
    "EnsembleICM", "EnsembleICMConfig", "EnsembleICMState",
    "metropolis_label_swap", "select_pairs_device",
    "NMCConfig", "NMCResult", "nmc_run", "nmc_subroutine",
    "APTConfig", "APTResult", "apt_preprocess",
    "NPTConfig", "NPTResult", "npt_run",
    "APTICMConfig", "APTICMResult", "apt_icm_run",
    "loopy_belief_propagation", "lbp_convexified", "lbp_convexified_batch",
    "EdgeGraph", "sparse_lbp", "sparse_lbp_convexified",
    "sparse_lbp_convexified_batch", "convexified_marginal_dense",
    "convexified_marginal_sparse", "convexified_marginal_planes",
    "EdgeSlotPlanes", "build_edge_slot_planes", "w_slot_from_tiles",
    "backbone_mask_device",
    "atanh_saturated", "convexification_epsilon",
    "find_clusters", "flatten_clusters", "cluster_mask",
    "greedy_coloring", "color_groups", "num_colors",
    "solve_exact_host", "solve_exact_device", "solve_exact_fused",
    "solve_exact_enum", "exact_energy_bound", "solve_exact_chimera",
    "mitm_min", "mitm_min_reference", "mitm_min_i8",
    "mitm_min_i8_reference",
    "Presolve", "peel_leaves",
    "SolveResult", "SolveStage", "portfolio_solve",
    "tree_refine", "tree_refine_state", "refine_family",
    "partition_crossover", "pad_to_chimera_grid",
    "solve_beam_chimera", "solve_beam_chimera_multi",
    "solve_beam_chimera_cuda", "refine_strips",
    "SpectralResult", "spectral_search", "spectral_candidates",
    "spectral_candidates_device", "auto_subspace_dim",
    "difference_map_rounding", "difference_map_rounding_device",
    "batched_descent_host", "batched_descent_device",
]
