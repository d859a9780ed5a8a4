"""The campaign's engine: `EnsembleNMC`, the family as one ensemble, one
round a call to `run_scanned`, `best` every `best_every` rounds, as
`campaign.solve_ensemble_batch` drives it."""

from __future__ import annotations

from nmc_tpu_torch.core.problem import IsingProblem
from nmc_tpu_torch.parallel import EnsembleNMC, ShardedNPTConfig

LIBRARIES = ("ensemble_round",)


class Engine:
    def __init__(self, inputs, device, group=None):
        cfg, tr = inputs.config, inputs.traffic
        probs = [IsingProblem(J, h) for J, h in zip(inputs.J, inputs.h)]
        ncfg = ShardedNPTConfig(
            sweeps_per_phase=cfg["sweeps_per_phase"],
            num_cycles=cfg["num_cycles"],
            full_update_frequency=cfg["full_update_frequency"],
            num_swapping_pairs=cfg["num_swapping_pairs"],
            global_beta=tr["global_beta"], temp_x=cfg["temp_x"],
            threshold_initial=cfg["threshold_initial"],
            threshold_cutoff=cfg["threshold_cutoff"],
            threshold_step=cfg["threshold_step"],
            lambda_start=cfg["lambda_start"], lambda_end=cfg["lambda_end"],
            lambda_reduction_factor=cfg["lambda_reduction_factor"],
            lbp_max_iterations=cfg["lbp_max_iterations"],
            lbp_tolerance=cfg["lbp_tolerance"], lbp_every=tr["lbp_every"],
            lbp_mode=cfg["lbp_mode"], block_size=cfg["block_size"],
            use_coloring=cfg["use_coloring"], dtype=cfg["dtype"])
        self.ens = EnsembleNMC(probs, inputs.beta, inputs.do_nmc.tolist(),
                               ncfg, device=device)

    def init(self, generator):
        return self.ens.init_state(generator)

    def round(self, state, timings=None):
        return self.ens.run_scanned(state, 1, timings=timings), None

    def best(self, state):
        return self.ens.best(state)

    def export(self, state, extra=None):
        return dict(m=state.m, beta_to_slot=state.beta_to_slot,
                    slot_to_beta=state.slot_to_beta, m_best=state.m_best,
                    e_best=state.e_best, cl=state.cl, do_nmc=state.do_nmc_slot,
                    round_index=state.round_index)
