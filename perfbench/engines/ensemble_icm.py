"""The campaign's `icm` arm: `EnsembleICM`, the family as one ensemble of
sub-replica ladders with Houdayer moves, one round a call to
`run_scanned`, `best` every `best_every` rounds, as
`campaign.solve_ensemble_batch` drives it."""

from __future__ import annotations

from nmc_tpu_torch.core.problem import IsingProblem
from nmc_tpu_torch.parallel import EnsembleICM, EnsembleICMConfig

LIBRARIES = ("ensemble_round",)


class Engine:
    def __init__(self, inputs, device, group=None):
        cfg = inputs.config
        if inputs.do_nmc.any():
            raise ValueError("the icm arm runs no NMC labels")
        probs = [IsingProblem(J, h) for J, h in zip(inputs.J, inputs.h)]
        self.ens = EnsembleICM(probs, inputs.beta, EnsembleICMConfig(
            sweeps_per_round=cfg["sweeps_per_round"],
            num_subreplicas=cfg["subreplicas"],
            use_katzgraber=cfg["use_katzgraber"],
            num_swapping_pairs=cfg["num_swapping_pairs"],
            block_size=cfg["block_size"], use_coloring=cfg["use_coloring"],
            dtype=cfg["dtype"], houdayer=cfg["houdayer"]), device=device)
        assert self.ens.houdayer == "matmul", self.ens.houdayer
        if self.ens.device.type == "cuda":
            assert self.ens.round_path == "K5", self.ens.round_path

    def init(self, generator):
        return self.ens.init_state(generator)

    def round(self, state, timings=None):
        return self.ens.run_scanned(state, 1, timings=timings), None

    def best(self, state):
        return self.ens.best(state)

    def export(self, state, extra=None):
        return dict(m=state.m, beta_to_slot=state.beta_to_slot,
                    slot_to_beta=state.slot_to_beta, m_best=state.m_best,
                    e_best=state.e_best, round_index=state.round_index)
