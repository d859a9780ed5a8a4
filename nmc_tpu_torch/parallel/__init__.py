"""Replica exchange and instance ensembles on the device (torch).

The counterpart of ``nmc_tpu/parallel``, with its single-card names (the
mesh-sharded `ShardedNPT`, `spin_sharded` and `distributed` belong to the
multi-GPU slice):
  * label swaps batched over instances: `parallel/swaps.py`;
  * `EnsemblePT` (many instances x a PT replica ladder, the sequential
    sweeps per instance): `parallel/ensemble.py`;
  * the campaign engine `EnsembleNMC` (many instances x a replica ladder x
    full NMC/PT rounds through the whole-round kernels K4/K5):
    `parallel/ensemble_nmc.py`;
  * its configuration `ShardedNPTConfig`: `parallel/sharded_pt.py`;
  * the APT + Houdayer ICM ensemble `EnsembleICM` (the campaign's icm and
    hybrid arms; its sweep stage through K4/K5, batched device Houdayer
    moves): `parallel/ensemble_icm.py`.
"""

from .ensemble import EnsembleConfig, EnsemblePT, EnsembleState
from .ensemble_icm import (EnsembleICM, EnsembleICMConfig, EnsembleICMState,
                           ICMDraws)
from .ensemble_nmc import EnsembleNMC, EnsembleNMCState, RoundDraws
from .sharded_pt import ShardedNPTConfig
from .swaps import SwapResult, metropolis_label_swap, select_pairs_device

__all__ = [
    "ShardedNPTConfig",
    "EnsemblePT", "EnsembleConfig", "EnsembleState",
    "EnsembleNMC", "EnsembleNMCState", "RoundDraws",
    "EnsembleICM", "EnsembleICMConfig", "EnsembleICMState", "ICMDraws",
    "SwapResult", "metropolis_label_swap", "select_pairs_device",
]
