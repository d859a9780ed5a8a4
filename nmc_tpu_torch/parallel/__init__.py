"""Replica exchange and instance ensembles on the device (torch).

The counterpart of ``nmc_tpu/parallel``, over `torch.distributed` where JAX
shards over a mesh:
  * label swaps batched over instances: `parallel/swaps.py`;
  * `EnsemblePT` (many instances x a PT replica ladder, the sequential
    sweeps per instance): `parallel/ensemble.py`;
  * the campaign engine `EnsembleNMC` (many instances x a replica ladder x
    full NMC/PT rounds through the whole-round kernels K4/K5):
    `parallel/ensemble_nmc.py`;
  * replica parallelism across ranks: `ShardedNPT` (the ladder split over
    a process group, label swaps on the gathered energies),
    `parallel/sharded_pt.py`, which also holds `ShardedNPTConfig`;
  * spin(J)-axis sharding when N outgrows one card: `SpinShardedSweeper`
    (column-sharded J and phi, one all_reduce of dm per block),
    `parallel/spin_sharded.py`;
  * the three ensembles shard their instances over a `group=`;
  * process groups and the collectives they use: `parallel/distributed.py`;
    the multi-rank dry run and rank launcher: `parallel/dryrun.py`;
  * the APT + Houdayer ICM ensemble `EnsembleICM` (the campaign's icm and
    hybrid arms; its sweep stage through K4/K5, batched device Houdayer
    moves): `parallel/ensemble_icm.py`.
"""

from . import distributed
from .ensemble import EnsembleConfig, EnsemblePT, EnsembleState
from .ensemble_icm import (EnsembleICM, EnsembleICMConfig, EnsembleICMState,
                           ICMDraws)
from .ensemble_nmc import EnsembleNMC, EnsembleNMCState, RoundDraws
from .sharded_pt import (RoundMetrics, ShardedNPT, ShardedNPTConfig,
                         ShardedPTState)
from .spin_sharded import (SpinShardedConfig, SpinShardedState,
                           SpinShardedSweeper)
from .swaps import SwapResult, metropolis_label_swap, select_pairs_device

__all__ = [
    "ShardedNPT", "ShardedNPTConfig", "ShardedPTState", "RoundMetrics",
    "EnsemblePT", "EnsembleConfig", "EnsembleState",
    "EnsembleNMC", "EnsembleNMCState", "RoundDraws",
    "EnsembleICM", "EnsembleICMConfig", "EnsembleICMState", "ICMDraws",
    "SwapResult", "metropolis_label_swap", "select_pairs_device",
    "SpinShardedSweeper", "SpinShardedConfig", "SpinShardedState",
    "distributed",
]
