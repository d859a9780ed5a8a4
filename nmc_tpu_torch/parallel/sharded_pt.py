"""Configuration of the replica-exchange engines with NMC phases.

The counterpart of ``nmc_tpu/parallel/sharded_pt.py``'s `ShardedNPTConfig`,
which `EnsembleNMC` takes: the same fields and defaults, less `precision`
(the port turns TF32 off globally, `device.py`). The mesh-sharded
`ShardedNPT` engine itself belongs to the multi-GPU slice (ROADMAP).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ShardedNPTConfig:
    sweeps_per_phase: int = 32
    num_cycles: int = 2
    full_update_frequency: int = 1
    num_swapping_pairs: int = 1
    global_beta: float = 2.5
    temp_x: float = 20.0
    threshold_initial: float = 0.999999
    threshold_cutoff: float = 0.99999
    threshold_step: float = 0.01
    lambda_start: float = 3.0
    lambda_end: float = 0.01
    lambda_reduction_factor: float = 0.5
    lbp_max_iterations: int = 30
    lbp_tolerance: float = 1e-7
    lbp_every: int = 1       # recompute backbone clusters every K rounds
    lbp_mode: str = "auto"   # 'dense' | 'sparse' | 'planes' (slotted edges,
                             # raises past the degree cap) | 'auto': planes
                             # when the degree cap holds, else edge messages
                             # below 5% density or with 'sparse', else dense
    block_size: int = 128
    within_block: str = "sequential"
    use_coloring: bool = False   # graph-colored blocks -> exact Jacobi updates
    dtype: str = "float32"
    round_kernel: str = "auto"   # EnsembleNMC whole-round kernels K4/K5:
                                 # 'auto' (colored f32 layouts), 'on' (raise
                                 # when none fits), 'off' (the plain round)
