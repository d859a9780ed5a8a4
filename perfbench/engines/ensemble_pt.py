"""`EnsemblePT`: the family as one ensemble of PT ladders, one call to
`round` a round, `best_energies` / `best_states` every `best_every`
rounds."""

from __future__ import annotations

from nmc_tpu_torch.core.problem import IsingProblem
from nmc_tpu_torch.parallel import EnsembleConfig, EnsemblePT

LIBRARIES = ("sequential_sweeps",)


class Engine:
    def __init__(self, inputs, device, group=None):
        cfg = inputs.config
        if inputs.do_nmc.any():
            raise ValueError("EnsemblePT runs no NMC labels")
        probs = [IsingProblem(J, h) for J, h in zip(inputs.J, inputs.h)]
        self.ens = EnsemblePT(probs, inputs.beta, EnsembleConfig(
            num_replicas=cfg["replicas"],
            sweeps_per_round=cfg["sweeps_per_round"],
            num_swapping_pairs=cfg["num_swapping_pairs"],
            block_size=cfg["block_size"], within_block=cfg["within_block"],
            dtype=cfg["dtype"]), device=device)

    def init(self, generator):
        return self.ens.init_state(generator)

    def round(self, state, timings=None):
        return self.ens.round(state), None

    def best(self, state):
        return self.ens.best_energies(state), self.ens.best_states(state)

    def export(self, state, extra=None):
        return dict(m=state.m, beta_to_slot=state.beta_to_slot,
                    slot_to_beta=state.slot_to_beta, m_best=state.best_m,
                    e_best=state.best_e, round_index=state.round_index)
