"""`ShardedNPT` over the default process group, as the `sharded` command
runs it under torchrun: one round a call to `run_scanned`, `best` every
`best_every` rounds."""

from __future__ import annotations

import numpy as np

from nmc_tpu_torch.core.problem import IsingProblem
from nmc_tpu_torch.parallel import ShardedNPT, ShardedNPTConfig

LIBRARIES = ("ensemble_round",)


class Engine:
    def __init__(self, inputs, device, group=None):
        cfg, tr = inputs.config, inputs.traffic
        ncfg = ShardedNPTConfig(
            sweeps_per_phase=cfg["sweeps_per_phase"],
            num_cycles=cfg["num_cycles"],
            full_update_frequency=cfg["full_update_frequency"],
            num_swapping_pairs=cfg["num_swapping_pairs"],
            global_beta=tr["global_beta"], temp_x=cfg["temp_x"],
            block_size=cfg["block_size"], use_coloring=cfg["use_coloring"],
            dtype=cfg["dtype"])
        self.npt = ShardedNPT(IsingProblem(inputs.J[0], inputs.h[0]),
                              inputs.beta, inputs.do_nmc.tolist(), ncfg,
                              group=group, device=device)

    def init(self, generator):
        return self.npt.init_state(generator)

    def round(self, state, timings=None):
        state, met = self.npt.run_scanned(state, 1, timings=timings)
        return state, met

    def best(self, state):
        e, m = self.npt.best(state)
        return np.array([e]), m[None]

    def export(self, state, extra=None):
        out = dict(m=state.m, beta_to_slot=state.beta_to_slot,
                   slot_to_beta=state.slot_to_beta, m_best=state.m_best,
                   e_best=state.e_best, round_index=state.round_index)
        if extra is not None:
            out["slot_energies"] = extra.slot_energies[-1]
        return out
