"""Reference-compatible API shims over the port's drivers.

The counterpart of ``nmc_tpu/compat``: drop-in classes matching the
reference's public surfaces,

    NMC(J, h).run(...)                      the reference's NMC/nmc.py:442
    NPT(J, h).run(beta_list, ...)           NPT/npt.py:535
    APT_preprocessor(J, h).run(...)         NPT/apt_preprocessor.py:115
    APT_ICM(J, h).run(beta_list, ...)       NPT/apt_ICM.py:145

with the same methods, return layouts, in-place J/h normalization on run,
PNG artifact names and npy artifacts. Each takes an optional `device=`
(default: the card; pass "cpu" to run on the CPU). A `torch.Generator` on
that device, seeded from `np.random.randint`, stands in for the JAX key,
and `.seed(s)` seeds both it and numpy's global RNG. `num_cores` is
accepted and ignored (the batch axis replaces process pools);
`use_hash_table` selects the faithful host kernel in `MCMC` and is a
documented no-op on the device path (docs/DEVIATIONS.md).

The figures need matplotlib. Where it is missing (the card's machine), a
`run` warns once, naming the PNG files it did not write, and still returns
the reference's arrays.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from ..core.problem import IsingProblem
from ..device import resolve_device
from ..models.apt import APTConfig, apt_preprocess
from ..models.apt_icm import APTICMConfig, apt_icm_run
from ..models.nmc import NMCConfig, nmc_run, nmc_subroutine
from ..models.npt import NPTConfig, npt_run
from ..models.npt import select_non_overlapping_pairs as _select_pairs
from ..ops import lbp as _lbp
from ..ops.clusters import disagreement_clusters
from ..ops.clusters import find_clusters as _find_clusters
from ..ops.engine import SweepEngine
from ..utils import plotting
from .faithful import LRUFieldCache, mcmc_sequential

__all__ = ["NMC", "NPT", "APT_preprocessor", "APT_ICM", "LRUFieldCache",
           "mcmc_sequential"]

_EPS = float(np.finfo(np.float64).eps)


def _as_dense(J):
    return np.asarray(J.toarray() if hasattr(J, "toarray") else J,
                      dtype=np.float64)


def _block_size(n: int) -> int:
    return min(128, max(8, n))


def _plot(pngs, draw, *args):
    """Draw a figure; without matplotlib, warn that `pngs` were not written."""
    try:
        draw(*args)
    except ImportError as e:
        if e.name != "matplotlib":
            raise
        warnings.warn(f"{', '.join(pngs)} not written: {e}", RuntimeWarning,
                      stacklevel=3)


class _Base:
    def __init__(self, J, h, device=None):
        self.J = _as_dense(J)
        self.h = np.asarray(h, dtype=np.float64).reshape(-1)
        self.device = resolve_device(device)
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(np.random.randint(0, 2 ** 31 - 1)))

    def seed(self, seed: int):
        """Deterministic runs (the reference relies on np.random.seed(0)
        at import, NMC/nmc.py:10)."""
        self._gen.manual_seed(seed)
        np.random.seed(seed)
        return self

    # -- shared reference methods ----------------------------------------
    def MCMC(self, num_sweeps, m_start, beta, J, h, anneal=False,
             sweeps_per_beta=1, initial_beta=0, hash_table=None,
             use_hash_table=False):
        """Single-chain Gibbs sweeps -> M [N, num_sweeps] (the reference's
        NMC/nmc.py:28-91). The faithful host kernel when a hash table is
        requested, the sweep engine on the device otherwise."""
        if use_hash_table:
            if not isinstance(hash_table, LRUFieldCache):
                raise ValueError(
                    "hash_table must be an instance of LRUFieldCache")
            return mcmc_sequential(
                num_sweeps, m_start, beta, J, h, anneal=anneal,
                sweeps_per_beta=sweeps_per_beta, initial_beta=initial_beta,
                hash_table=hash_table, use_hash_table=True,
                rng=np.random.default_rng(int(np.random.randint(2 ** 31))),
            )
        problem = IsingProblem(_as_dense(J), np.asarray(h).reshape(-1))
        engine = SweepEngine(problem, block_size=_block_size(problem.n),
                             device=self.device)
        res = engine.run(np.asarray(m_start, dtype=np.float64).reshape(1, -1),
                         self._gen, num_sweeps=num_sweeps, beta=beta,
                         anneal=anneal, sweeps_per_beta=sweeps_per_beta,
                         initial_beta=initial_beta, record_m=True)
        return res.M[:, 0, :].T.cpu().numpy().astype(np.float64)

    def atanh_saturated(self, x):
        return _lbp.atanh_saturated(
            torch.as_tensor(np.asarray(x), dtype=torch.float64,
                            device=self.device)).cpu().numpy()

    def LoopyBeliefPropagation(self, J, h, beta, h_msgs, u_msgs, tolerance,
                               max_iterations):
        def f64(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float64,
                                   device=self.device)

        res = _lbp.loopy_belief_propagation(
            f64(_as_dense(J)), f64(h).reshape(-1), beta, f64(h_msgs),
            f64(u_msgs), tolerance, max_iterations=max_iterations)
        return (res.magnetizations.cpu().numpy(),
                res.correlations.cpu().numpy(), res.h_tilde.cpu().numpy(),
                res.J_tilde.cpu().numpy(), int(res.iterations),
                res.h_msgs.cpu().numpy(), res.u_msgs.cpu().numpy())

    def find_clusters(self, magnetizations, threshold_initial,
                      threshold_cutoff, threshold_step):
        return _find_clusters(self.J, magnetizations, threshold_initial,
                              threshold_cutoff, threshold_step)

    def LBP_convexified(self, lambda_start, lambda_end,
                        lambda_reduction_factor, m_star, epsilon, tolerance,
                        max_iterations, threshold_initial, threshold_cutoff,
                        global_beta):
        out = _lbp.lbp_convexified(
            torch.as_tensor(self.J, device=self.device),
            torch.as_tensor(self.h, device=self.device), global_beta,
            np.asarray(m_star).reshape(-1), np.asarray(epsilon).reshape(-1),
            lambda_start=lambda_start, lambda_end=lambda_end,
            lambda_reduction_factor=lambda_reduction_factor,
            tolerance=tolerance, max_iterations=max_iterations,
            keep_history=True)
        # the marginal from the pre-tanh belief in f64, which keeps the
        # reference's 7-nines threshold discrimination
        marg64 = np.tanh(global_beta * np.asarray(out.belief, np.float64))
        clusters = self.find_clusters(marg64, threshold_initial,
                                      threshold_cutoff, 0.01)
        return (clusters, out.marginals_all, out.mean_marginals_all,
                out.h_tilde_all, out.J_tilde_all)

    def replica_energy(self, M, num_sweeps):
        """(min energy, energies) over the first num_sweeps columns of M
        (the reference's NPT/npt.py:31-45)."""
        M = np.asarray(M)
        EE1 = np.array([
            -(M[:, i] @ self.J @ M[:, i] / 2 + M[:, i] @ self.h)
            for i in range(num_sweeps)
        ])
        return float(EE1.min()), EE1

    def _normalize(self):
        """The reference's in-place normalization by max |J|, observable
        on the instance (NMC/nmc.py:471-476)."""
        norm = np.max(np.abs(self.J)) or 1.0
        self.J = self.J / norm
        self.h = self.h / norm


class NMC(_Base):
    """Reference-compatible NMC solver (the reference's NMC/nmc.py:13)."""

    def _config(self, n, **kw):
        return NMCConfig(normalize=False, record_m=True,
                         block_size=_block_size(n), **kw)

    def NMC_subroutine(self, m_star, num_cycles, num_sweeps_per_NMC_phase,
                       full_update_frequency, M_skip, global_beta, temp_x,
                       lambda_start, lambda_end, lambda_reduction_factor,
                       threshold_initial, threshold_cutoff, max_iterations,
                       tolerance, all_clusters=None, hash_table=None,
                       use_hash_table=False):
        problem = IsingProblem(self.J, self.h)
        cfg = self._config(
            problem.n, num_sweeps_per_NMC_phase=num_sweeps_per_NMC_phase,
            num_NMC_cycles=num_cycles,
            full_update_frequency=full_update_frequency, M_skip=M_skip,
            temp_x=temp_x, global_beta=global_beta,
            lambda_start=lambda_start, lambda_end=lambda_end,
            lambda_reduction_factor=lambda_reduction_factor,
            threshold_initial=threshold_initial,
            threshold_cutoff=threshold_cutoff,
            max_iterations=max_iterations, tolerance=tolerance)
        engine = SweepEngine(problem, block_size=cfg.block_size,
                             device=self.device)
        res = nmc_subroutine(engine, problem,
                             np.asarray(m_star).reshape(1, -1), self._gen,
                             cfg, all_clusters=all_clusters)
        M_overall, energy_overall = _subsample_record(res, M_skip)
        return (M_overall, energy_overall, float(energy_overall.min()),
                res.all_clusters)

    def run(self, num_sweeps_initial=int(1e4),
            num_sweeps_per_NMC_phase=int(1e4), num_NMC_cycles=10,
            full_update_frequency=1, M_skip=1, temp_x=20, global_beta=2.5,
            lambda_start=0.5, lambda_end=0.01, lambda_reduction_factor=0.9,
            threshold_initial=0.999999, threshold_cutoff=0.99999,
            max_iterations=100, tolerance=_EPS, use_hash_table=False):
        self._normalize()
        problem = IsingProblem(self.J, self.h)
        cfg = self._config(
            problem.n, num_sweeps_initial=num_sweeps_initial,
            num_sweeps_per_NMC_phase=num_sweeps_per_NMC_phase,
            num_NMC_cycles=num_NMC_cycles,
            full_update_frequency=full_update_frequency, M_skip=M_skip,
            temp_x=temp_x, global_beta=global_beta,
            lambda_start=lambda_start, lambda_end=lambda_end,
            lambda_reduction_factor=lambda_reduction_factor,
            threshold_initial=threshold_initial,
            threshold_cutoff=threshold_cutoff,
            max_iterations=max_iterations, tolerance=tolerance)
        res = nmc_run(problem, cfg, self._gen, device=self.device)
        M_overall, energy_overall = _subsample_record(res, M_skip)
        _plot(["NMC_spins.png", "NMC_energy.png"], plotting.plot_nmc_results,
              res.M_overall, res.energy_overall, res.all_clusters,
              res.phase_labels, res.phase_lengths, M_skip)
        return M_overall, energy_overall, float(energy_overall.min())


def _subsample_record(res, M_skip):
    """The reference's record layout: M [N, T_rec], energies [T_rec] with
    the per-phase ::M_skip subsampling of NMC/nmc.py:390-391 (chain 0)."""
    e = res.energy_overall[:, 0]
    num_phases = len(res.phase_lengths)
    T = res.phase_lengths[0]
    e_rec = e.reshape(num_phases, T)[:, ::M_skip].reshape(-1)
    if res.M_overall is not None:
        M_rec = res.M_overall[:, 0, :].T     # already ::M_skip per phase
    else:
        M_rec = None
    return M_rec, e_rec


def _npt_record(res, num_replicas, n):
    """NPT's M [R * N, per_swap]: the last round's states, replica blocks
    stacked."""
    return res.M.reshape(num_replicas * n, -1)


def _apt_icm_record(res, num_replicas, n, per_swap, S):
    """APT_ICM's M [N * R, per_swap * S]: the last round's per-sweep
    history, sub-replica blocks side by side, the first column carrying
    the Houdayer-modified states (the reference's quirk)."""
    M = np.zeros((n * num_replicas, per_swap * S))
    for r in range(num_replicas):
        for s in range(S):
            M[r * n:(r + 1) * n, s * per_swap:(s + 1) * per_swap] = \
                res.M_history[r, s].T
    return M


class NPT(_Base):
    """Reference-compatible NPT solver (the reference's NPT/npt.py:15)."""

    def select_non_overlapping_pairs(self, all_pairs):
        return _select_pairs(all_pairs, self.num_swapping_pairs,
                             np.random.default_rng(np.random.randint(2 ** 31)))

    def run(self, beta_list, num_replicas, doNMC, num_sweeps_MCMC=1000,
            num_sweeps_read=1000, num_swap_attempts=100,
            num_swapping_pairs=1, num_cycles=10, full_update_frequency=1,
            M_skip=1, temp_x=20, global_beta=2.5, lambda_start=0.5,
            lambda_end=0.01, lambda_reduction_factor=0.9,
            threshold_initial=0.999999, threshold_cutoff=0.99999,
            max_iterations=100, tolerance=_EPS, use_hash_table=False,
            num_cores=8):
        del num_cores  # the batch axis replaces the process pool
        self.num_swapping_pairs = num_swapping_pairs
        self._normalize()
        problem = IsingProblem(self.J, self.h)
        cfg = NPTConfig(
            num_sweeps_MCMC=num_sweeps_MCMC, num_sweeps_read=num_sweeps_read,
            num_swap_attempts=num_swap_attempts,
            num_swapping_pairs=num_swapping_pairs, num_cycles=num_cycles,
            full_update_frequency=full_update_frequency, M_skip=M_skip,
            temp_x=temp_x, global_beta=global_beta,
            lambda_start=lambda_start, lambda_end=lambda_end,
            lambda_reduction_factor=lambda_reduction_factor,
            threshold_initial=threshold_initial,
            threshold_cutoff=threshold_cutoff,
            max_iterations=max_iterations, tolerance=tolerance,
            normalize=False, record_last_round_m=True,
            block_size=_block_size(problem.n),
        )
        res = npt_run(problem, np.asarray(beta_list)[:num_replicas],
                      list(doNMC), cfg, self._gen, device=self.device)
        M = _npt_record(res, num_replicas, problem.n)
        _plot(["NPT_energy.png"], plotting.plot_energies,
              list(res.energy_trace), res.beta_list, "NPT_energy.png")
        return M, res.Energy


class APT_preprocessor(_Base):
    """Reference-compatible APT preprocessor (the reference's
    NPT/apt_preprocessor.py:12)."""

    def __init__(self, J, h, device=None):
        super().__init__(J, h, device=device)
        self.N = self.J.shape[0]

    def run(self, num_sweeps_MCMC=1000, num_sweeps_read=1000, num_rng=100,
            beta_start=0.5, alpha=1.25, sigma_E_val=1000, beta_max=30,
            use_hash_table=1, num_cores=8):
        del num_cores
        if num_sweeps_MCMC <= 0:
            raise ValueError("num_sweeps_MCMC must be positive")
        self._normalize()
        problem = IsingProblem(self.J, self.h)
        cfg = APTConfig(
            num_sweeps_MCMC=num_sweeps_MCMC,
            num_sweeps_read=min(num_sweeps_read, num_sweeps_MCMC),
            num_rng=num_rng, beta_start=beta_start, alpha=alpha,
            sigma_E_val=sigma_E_val, beta_max=beta_max, normalize=False,
            save_dir=os.path.join("Results", "data"),
            block_size=_block_size(problem.n),
        )
        res = apt_preprocess(problem, cfg, self._gen, device=self.device)
        np.save("beta_list_python.npy", np.asarray(res.beta))
        np.save("sigma_list_python.npy", np.asarray(res.sigma))
        _plot(["beta_sigma.png"], plotting.plot_beta_sigma, res.beta,
              res.sigma, "beta_sigma.png")
        return list(res.beta), list(res.sigma)


class APT_ICM(_Base):
    """Reference-compatible APT+ICM baseline (the reference's
    NPT/apt_ICM.py:14)."""

    def find_disagreement_clusters(self, state_1, state_2, J):
        return [c.tolist() for c in
                disagreement_clusters(_as_dense(J), state_1, state_2)]

    def run(self, beta_list, num_replicas, num_sweeps_MCMC=1000,
            num_sweeps_read=1000, num_swap_attempts=100,
            num_swapping_pairs=1, use_hash_table=0, num_cores=8):
        del num_cores
        self.num_sweeps_MCMC = num_sweeps_MCMC
        self.num_swapping_pairs = num_swapping_pairs
        problem = IsingProblem(self.J, self.h)  # caller normalizes (quirk)
        cfg = APTICMConfig(
            num_sweeps_MCMC=num_sweeps_MCMC, num_sweeps_read=num_sweeps_read,
            num_swap_attempts=num_swap_attempts,
            num_swapping_pairs=num_swapping_pairs,
            use_hash_table=bool(use_hash_table), normalize=False,
            record_last_round_m=True,
            block_size=_block_size(problem.n),
        )
        res = apt_icm_run(problem, np.asarray(beta_list)[:num_replicas],
                          cfg, self._gen, device=self.device)
        per_swap = num_sweeps_MCMC // num_swap_attempts
        M = _apt_icm_record(res, num_replicas, problem.n, per_swap,
                            cfg.num_subreplicas)
        _plot(["APT_ICM_energy..png"], plotting.plot_energies,
              list(res.energy_trace), res.beta_list, "APT_ICM_energy..png")
        return M, res.Energy
