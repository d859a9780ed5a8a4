"""The port's reference-compatible shims (nmc_tpu_torch.compat) on the CPU.

  * the cases of tests/test_compat.py and tests/test_quirks.py through the
    port's shims (`device="cpu"`): constructors, run signatures, shapes,
    artifacts, in-place normalization, the hash-table MCMC path;
  * each `_Base` method against JAX's shim on the same inputs (f64: LBP
    within 1e-10, clusters and energies equal);
  * each record layout against JAX's on one driver result: the drivers are
    monkeypatched in both shims to return the same result, so the outputs
    must be equal element for element;
  * without matplotlib, a run warns once naming the PNGs it did not write
    and still returns the reference's arrays.
"""

import os
import warnings

import numpy as np
import pytest

import nmc_tpu.compat as jcompat
import nmc_tpu_torch.compat as tcompat
from nmc_tpu_torch.compat import (APT_ICM, APT_preprocessor, LRUFieldCache,
                                  NMC, NPT)
from nmc_tpu_torch.utils import plotting


def random_J_h(N, seed=0):
    rng = np.random.default_rng(seed)
    J = np.zeros((N, N))
    iu = np.triu_indices(N, 1)
    J[iu] = rng.normal(size=len(iu[0]))
    J = J + J.T
    h = rng.normal(size=N)
    return J, h


@pytest.fixture(autouse=True)
def chdir_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


NMC_KW = dict(num_sweeps_initial=100, num_sweeps_per_NMC_phase=10,
              num_NMC_cycles=2, full_update_frequency=1, M_skip=1, temp_x=20,
              global_beta=3, lambda_start=3, lambda_end=0.01,
              lambda_reduction_factor=0.9, threshold_initial=0.9999999,
              threshold_cutoff=0.999999, max_iterations=10,
              tolerance=np.finfo(float).eps, use_hash_table=False)


# ---- the cases of test_compat.py ---------------------------------------

class TestNMCCompat:
    def test_initialization(self):
        J, h = random_J_h(10)
        nmc = NMC(J, h.reshape(-1, 1), device="cpu")
        assert np.array_equal(nmc.J, J)
        assert np.array_equal(nmc.h, h)

    def test_run_method_shapes_and_artifacts(self):
        J, h = random_J_h(10, seed=1)
        nmc = NMC(J, h, device="cpu").seed(0)
        M, e, min_e = nmc.run(**NMC_KW)
        assert isinstance(M, np.ndarray)
        assert M.shape == (10, 60)          # 2 cycles x 3 phases x 10 sweeps
        assert e.shape == (60,)
        assert isinstance(min_e, float)
        assert min_e == e.min()
        assert set(np.unique(M)) <= {-1.0, 1.0}
        assert os.path.exists("NMC_spins.png")
        assert os.path.exists("NMC_energy.png")
        assert abs(np.abs(nmc.J).max() - 1.0) < 1e-12

    def test_mcmc_method(self):
        J, h = random_J_h(8, seed=2)
        nmc = NMC(J, h, device="cpu").seed(0)
        M = nmc.MCMC(5, np.ones(8), 1.0, J, h)
        assert M.shape == (8, 5) and M.dtype == np.float64
        assert set(np.unique(M)) <= {-1.0, 1.0}

    def test_mcmc_hash_table_path(self):
        J, h = random_J_h(6, seed=3)
        nmc = NMC(J, h, device="cpu").seed(0)
        table = LRUFieldCache(maxsize=100)
        M = nmc.MCMC(4, np.ones(6), 1.0, J, h, hash_table=table,
                     use_hash_table=True)
        assert M.shape == (6, 4)
        assert len(table) > 0
        with pytest.raises(ValueError):
            nmc.MCMC(2, np.ones(6), 1.0, J, h, hash_table={},
                     use_hash_table=True)

    def test_hash_table_path_equals_jax_for_one_seed(self):
        """Both shims draw the host kernel's rng from numpy's global RNG,
        so after the same np.random.seed they return the same array."""
        J, h = random_J_h(7, seed=12)
        np.random.seed(5)
        a = NMC(J, h, device="cpu").MCMC(
            5, np.ones(7), 1.1, J, h, hash_table=LRUFieldCache(),
            use_hash_table=True)
        np.random.seed(5)
        b = jcompat.NMC(J, h).MCMC(5, np.ones(7), 1.1, J, h,
                                   hash_table=jcompat.LRUFieldCache(),
                                   use_hash_table=True)
        np.testing.assert_array_equal(a, b)

    def test_seed_is_deterministic(self):
        J, h = random_J_h(8, seed=13)
        a = NMC(J, h, device="cpu").seed(3).MCMC(6, np.ones(8), 1.0, J, h)
        b = NMC(J, h, device="cpu").seed(3).MCMC(6, np.ones(8), 1.0, J, h)
        np.testing.assert_array_equal(a, b)


class TestNPTCompat:
    def test_run_method(self):
        N = 10
        J, h = random_J_h(N, seed=4)
        npt = NPT(J, h.reshape(-1, 1), device="cpu").seed(0)
        M, Energy = npt.run(
            beta_list=np.array([0.5, 1.0, 1.5, 2.0]), num_replicas=4,
            doNMC=[False, False, True, True], num_sweeps_MCMC=100,
            num_sweeps_read=100, num_swap_attempts=10, num_swapping_pairs=1,
            num_cycles=2, full_update_frequency=1, M_skip=1, temp_x=20,
            global_beta=1 / 0.366838 * 5, lambda_start=3, lambda_end=0.01,
            lambda_reduction_factor=0.9, threshold_initial=0.9999999,
            threshold_cutoff=0.999999, max_iterations=100,
            tolerance=1e-10, use_hash_table=False, num_cores=1)
        assert M.shape == (N * 4, 100 // 10)
        assert Energy.shape == (4,)
        assert os.path.exists("NPT_energy.png")
        pairs = npt.select_non_overlapping_pairs([(1, 2), (2, 3), (3, 4)])
        assert len(pairs) == 1


class TestAPTPreprocessorCompat:
    def test_run_and_artifacts(self):
        J, h = random_J_h(8, seed=5)
        apt = APT_preprocessor(J, h.reshape(-1, 1), device="cpu").seed(0)
        beta, sigma = apt.run(num_sweeps_MCMC=30, num_sweeps_read=20,
                              num_rng=5, beta_start=0.5, alpha=2.0,
                              sigma_E_val=1000, beta_max=5.0,
                              use_hash_table=0, num_cores=1)
        assert isinstance(beta, list) and isinstance(sigma, list)
        assert apt.N == 8
        assert os.path.exists("beta_list_python.npy")
        assert os.path.exists("sigma_list_python.npy")
        assert os.path.exists("beta_sigma.png")
        assert os.path.exists(os.path.join("Results", "data",
                                           "Energy_iter_1.npy"))
        np.testing.assert_allclose(np.load("beta_list_python.npy"), beta)

    def test_negative_sweeps_raises(self):
        J, h = random_J_h(6, seed=6)
        apt = APT_preprocessor(J, h, device="cpu")
        with pytest.raises(ValueError):
            apt.run(num_sweeps_MCMC=-100, num_rng=2)


class TestAPTICMCompat:
    def test_run_method(self):
        N = 10
        J, h = random_J_h(N, seed=7)
        norm = np.abs(J).max()
        icm = APT_ICM(J / norm, h / norm, device="cpu").seed(0)
        M, Energy = icm.run(np.array([0.5, 1.0, 1.5, 2.0]), num_replicas=4,
                            num_sweeps_MCMC=100, num_sweeps_read=100,
                            num_swap_attempts=10, num_swapping_pairs=1,
                            use_hash_table=0, num_cores=1)
        assert M.shape == (N * 4, icm.num_sweeps_MCMC)
        assert Energy.shape == (4,)
        assert os.path.exists("APT_ICM_energy..png")

    def test_find_disagreement_clusters(self):
        J, h = random_J_h(8, seed=8)
        icm = APT_ICM(J, h, device="cpu")
        s1 = np.sign(np.random.default_rng(0).normal(size=8))
        clusters = icm.find_disagreement_clusters(s1, -s1, J)
        assert sorted(sum(clusters, [])) == list(range(8))
        jc = jcompat.APT_ICM(J, h).find_disagreement_clusters(s1, -s1, J)
        assert clusters == jc


# ---- the cases of test_quirks.py ---------------------------------------

def test_quirk10_compat_normalization_idempotent():
    rng = np.random.default_rng(0)
    J = rng.normal(size=(8, 8)) * 5
    J = 0.5 * (J + J.T)
    np.fill_diagonal(J, 0)
    nmc = NMC(J, np.zeros(8), device="cpu").seed(0)
    kwargs = dict(num_sweeps_initial=20, num_sweeps_per_NMC_phase=10,
                  num_NMC_cycles=1, lambda_start=3.0, max_iterations=300,
                  tolerance=1e-8)
    nmc.run(**kwargs)
    assert abs(np.abs(nmc.J).max() - 1.0) < 1e-12
    J_after_first = nmc.J.copy()
    nmc.run(**kwargs)
    np.testing.assert_allclose(nmc.J, J_after_first, rtol=1e-12)


def test_quirk1_npt_nmc_replicas_run_at_global_beta(monkeypatch):
    """NPT's NMC replicas sample at global_beta, not their tempering beta
    (the reference's NPT/npt.py:126), through the port's shim."""
    import nmc_tpu_torch.models.npt as npt_mod
    captured = {}
    orig = npt_mod.nmc_subroutine

    def spy(engine, problem, m_star, generator, cfg, **kw):
        captured["global_beta"] = cfg.global_beta
        return orig(engine, problem, m_star, generator, cfg, **kw)
    monkeypatch.setattr(npt_mod, "nmc_subroutine", spy)
    J, h = random_J_h(10, seed=1)
    NPT(J, h, device="cpu").seed(0).run(
        [0.1, 0.2], 2, [False, True], num_sweeps_MCMC=24, num_sweeps_read=24,
        num_swap_attempts=2, num_cycles=1, global_beta=7.5, lambda_start=3.0,
        tolerance=1e-8, max_iterations=300)
    assert captured["global_beta"] == 7.5


# ---- the _Base methods against JAX's shim -------------------------------

def _pair(J, h):
    return NMC(J, h, device="cpu").seed(0), jcompat.NMC(J, h).seed(0)


def test_atanh_saturated_matches_jax():
    t, j = _pair(*random_J_h(5))
    x = np.array([-1.0, -0.999999999, -0.3, 0.0, 0.5, 0.9999999999, 1.0])
    a, b = t.atanh_saturated(x), j.atanh_saturated(x)
    # the f64 clip bound tanh(19.06) - eps lies within 1e-15 of 1, where
    # XLA's and torch's f64 tanh round differently (tests/test_torch_lbp.py);
    # values inside it agree
    inner = np.abs(x) < 1.0
    np.testing.assert_allclose(a[inner], b[inner], rtol=0, atol=1e-12)
    assert np.all(np.abs(a[~inner]) > 17.0) and np.isfinite(a).all()


def test_loopy_belief_propagation_matches_jax():
    J, h = random_J_h(9, seed=14)
    J /= np.abs(J).max()
    t, j = _pair(J, h)
    rng = np.random.default_rng(2)
    hm, um = rng.normal(size=(9, 9)) * 0.1, rng.normal(size=(9, 9)) * 0.1
    a = t.LoopyBeliefPropagation(J, h * 0.1, 0.8, hm, um, 1e-12, 60)
    b = j.LoopyBeliefPropagation(J, h * 0.1, 0.8, hm, um, 1e-12, 60)
    assert a[4] == b[4]
    for x, y in zip(a[:4] + a[5:], b[:4] + b[5:]):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-10)


def test_find_clusters_matches_jax():
    J, h = random_J_h(12, seed=15)
    t, j = _pair(J, h)
    mag = np.tanh(3 * np.random.default_rng(3).normal(size=12))
    a = t.find_clusters(mag, 0.9, 0.5, 0.05)
    b = j.find_clusters(mag, 0.9, 0.5, 0.05)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_lbp_convexified_matches_jax():
    J, h = random_J_h(10, seed=16)
    J, h = J / np.abs(J).max(), h / np.abs(J).max()
    t, j = _pair(J, h)
    rng = np.random.default_rng(4)
    m_star = np.sign(rng.normal(size=10))
    eps = np.abs(h) + np.abs(J).sum(1)
    args = (3.0, 0.01, 0.5, m_star, eps, 1e-10, 300, 0.9, 0.5, 1.5)
    a, b = t.LBP_convexified(*args), j.LBP_convexified(*args)
    assert len(a[0]) == len(b[0])
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(x, y)
    assert sorted(a[1]) == sorted(b[1])
    for lam in a[1]:
        np.testing.assert_allclose(a[1][lam], b[1][lam], rtol=0, atol=1e-10)
        np.testing.assert_allclose(a[2][lam], b[2][lam], rtol=0, atol=1e-10)


def test_replica_energy_matches_jax():
    J, h = random_J_h(8, seed=17)
    t, j = _pair(J, h)
    M = np.sign(np.random.default_rng(5).normal(size=(8, 6)))
    a, b = t.replica_energy(M, 5), j.replica_energy(M, 5)
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])


# ---- the record layouts against JAX's ---------------------------------

def _nmc_result(rng, phases, T, n, M_skip, R=2):
    from nmc_tpu_torch.models.nmc import NMCResult
    M = np.sign(rng.normal(size=(phases * (T // M_skip), R, n)))
    return NMCResult(
        M_overall=M, energy_overall=rng.normal(size=(phases * T, R)),
        min_energy=np.zeros(R), m_best=np.ones((R, n)),
        m_final=np.ones((R, n)), all_clusters=np.array([0, 3]),
        phase_labels=["C", "NC", "ALL"] * (phases // 3),
        phase_lengths=[T] * phases, norm_factor=1.0)


@pytest.mark.parametrize("M_skip", [1, 2])
def test_nmc_record_layout_matches_jax(M_skip, monkeypatch):
    res = _nmc_result(np.random.default_rng(6), 6, 8, 7, M_skip)
    monkeypatch.setattr(tcompat, "nmc_run", lambda *a, **k: res)
    monkeypatch.setattr(jcompat, "nmc_run", lambda *a, **k: res)
    J, h = random_J_h(7, seed=18)
    kw = dict(num_sweeps_per_NMC_phase=8, num_NMC_cycles=2, M_skip=M_skip)
    a = NMC(J, h, device="cpu").run(**kw)
    b = jcompat.NMC(J, h).run(**kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert a[0].shape == (7, 6 * 8 // M_skip)
    assert a[1].shape == (6 * 8 // M_skip,)
    assert os.path.exists("NMC_spins.png")


def test_nmc_subroutine_layout_matches_jax(monkeypatch):
    res = _nmc_result(np.random.default_rng(7), 3, 5, 6, 1)
    monkeypatch.setattr(tcompat, "nmc_subroutine", lambda *a, **k: res)
    monkeypatch.setattr(jcompat, "nmc_subroutine", lambda *a, **k: res)
    J, h = random_J_h(6, seed=19)
    args = (np.ones(6), 1, 5, 1, 1, 2.5, 20, 3.0, 0.01, 0.9, 0.99, 0.9,
            100, 1e-10)
    a = NMC(J, h, device="cpu").NMC_subroutine(*args)
    b = jcompat.NMC(J, h).NMC_subroutine(*args)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2] == b[2]
    np.testing.assert_array_equal(a[3], b[3])


def test_npt_record_layout_matches_jax(monkeypatch):
    from nmc_tpu_torch.models.npt import NPTResult
    rng = np.random.default_rng(8)
    R, n, per_swap = 3, 5, 4
    res = NPTResult(
        M=np.sign(rng.normal(size=(R, n, per_swap))), Energy=rng.normal(
            size=R), energy_trace=rng.normal(size=(R, per_swap)),
        min_energy=-1.0, best_state=np.ones(n), swap_counts=np.zeros(2),
        swap_attempted=np.zeros((2, 2)), swap_accepted=np.zeros((2, 2)),
        beta_list=np.array([0.5, 1.0, 2.0]), norm_factor=1.0)
    monkeypatch.setattr(tcompat, "npt_run", lambda *a, **k: res)
    monkeypatch.setattr(jcompat, "npt_run", lambda *a, **k: res)
    J, h = random_J_h(n, seed=20)
    args = ([0.5, 1.0, 2.0], R, [False] * R)
    a = NPT(J, h, device="cpu").run(*args)
    b = jcompat.NPT(J, h).run(*args)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert a[0].shape == (R * n, per_swap)
    np.testing.assert_array_equal(a[0][n:2 * n], res.M[1])


def test_apt_icm_record_layout_matches_jax(monkeypatch):
    from nmc_tpu_torch.models.apt_icm import APTICMResult
    rng = np.random.default_rng(9)
    R, S, n, per_swap = 3, 10, 4, 2
    res = APTICMResult(
        Energy=rng.normal(size=R), energy_trace=rng.normal(size=(R, 2)),
        final_states=np.ones((R, S, n)),
        M_history=np.sign(rng.normal(size=(R, S, per_swap, n))),
        min_energy=-1.0, best_state=np.ones(n), swap_counts=np.zeros(5),
        icm_moves=0, icm_flips=0, beta_list=np.array([0.5, 1.0, 2.0]))
    monkeypatch.setattr(tcompat, "apt_icm_run", lambda *a, **k: res)
    monkeypatch.setattr(jcompat, "apt_icm_run", lambda *a, **k: res)
    J, h = random_J_h(n, seed=21)
    kw = dict(num_sweeps_MCMC=10, num_swap_attempts=5)
    a = APT_ICM(J, h, device="cpu").run([0.5, 1.0, 2.0], R, **kw)
    b = jcompat.APT_ICM(J, h).run([0.5, 1.0, 2.0], R, **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert a[0].shape == (n * R, per_swap * S)
    np.testing.assert_array_equal(a[0][n:2 * n, per_swap:2 * per_swap],
                                  res.M_history[1, 1].T)


# ---- without matplotlib ---------------------------------------------------

def _no_matplotlib():
    raise ImportError("the figures need matplotlib, which is not installed",
                      name="matplotlib")


def test_missing_matplotlib_warns_and_returns_arrays(monkeypatch):
    monkeypatch.setattr(plotting, "_plt", _no_matplotlib)
    J, h = random_J_h(10, seed=1)
    with pytest.warns(RuntimeWarning) as rec:
        M, e, min_e = NMC(J, h, device="cpu").seed(0).run(**NMC_KW)
    msgs = [str(w.message) for w in rec if w.category is RuntimeWarning]
    assert len(msgs) == 1
    assert "NMC_spins.png" in msgs[0] and "NMC_energy.png" in msgs[0]
    assert M.shape == (10, 60) and e.shape == (60,) and min_e == e.min()
    assert not os.path.exists("NMC_spins.png")
    with pytest.warns(RuntimeWarning, match="beta_sigma.png"):
        beta, _ = APT_preprocessor(*random_J_h(8, seed=5),
                                   device="cpu").seed(0).run(
            num_sweeps_MCMC=30, num_sweeps_read=20, num_rng=5, alpha=2.0,
            beta_max=5.0)
    assert os.path.exists("beta_list_python.npy") and len(beta) >= 1


def test_other_import_errors_propagate(monkeypatch):
    def broken():
        raise ImportError("something else", name="not_matplotlib")
    monkeypatch.setattr(plotting, "_plt", broken)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(ImportError, match="something else"):
            NMC(*random_J_h(10, seed=1), device="cpu").seed(0).run(**NMC_KW)


def test_plt_names_the_missing_package(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_mpl(name, *a, **k):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError(f"No module named {name!r}")
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_mpl)
    with pytest.raises(ImportError) as err:
        plotting._plt()
    assert err.value.name == "matplotlib"
    assert "matplotlib" in str(err.value)


# ---- the rest of test_quirks.py, through the port ---------------------------

def test_quirk6_acceptance_rate_is_round_fraction():
    """Acceptance = fraction of rounds with >= 1 swap, not the pair rate."""
    from nmc_tpu_torch.models.npt import NPTResult
    res = NPTResult(M=None, Energy=np.zeros(2), energy_trace=np.zeros((2, 1)),
                    min_energy=0.0, best_state=np.zeros(2),
                    swap_counts=np.array([0, 2, 1, 0.0]),
                    swap_attempted=np.zeros((4, 2)),
                    swap_accepted=np.zeros((4, 2)),
                    beta_list=np.array([1.0, 2.0]), norm_factor=1.0)
    assert res.acceptance_rate == 0.5


def test_rng_chain_independence():
    """Batched chains draw independent streams (the sequential route's
    CPU twin): same start, different trajectories, near-zero correlation."""
    import torch
    from nmc_tpu_torch.core.problem import IsingProblem
    from nmc_tpu_torch.ops.engine import SweepEngine
    eng = SweepEngine(IsingProblem(np.zeros((16, 16)), np.zeros(16)),
                      block_size=16, device="cpu")
    assert eng.sweep_kernel == "colored_sweeps"   # no coupling: one class
    res = eng.run(np.ones((2, 16)), torch.Generator().manual_seed(3),
                  num_sweeps=200, beta=1.0, record_m=True)
    M = res.M.numpy()
    a, b = M[:, 0, :].ravel(), M[:, 1, :].ravel()
    assert not np.array_equal(a, b)
    assert abs(np.corrcoef(a, b)[0, 1]) < 0.05


def test_rng_different_seeds_differ():
    import torch
    from nmc_tpu_torch.io.generators import random_sk
    from nmc_tpu_torch.ops.engine import SweepEngine
    eng = SweepEngine(random_sk(12, seed=2), block_size=16, device="cpu")
    assert eng.sweep_kernel == "sequential_sweeps"
    a = eng.run(np.ones((1, 12)), torch.Generator().manual_seed(1), 30, 0.5)
    b = eng.run(np.ones((1, 12)), torch.Generator().manual_seed(2), 30, 0.5)
    assert not torch.equal(a.m, b.m)


def test_float64_mode_end_to_end():
    import torch
    from nmc_tpu_torch import NMCConfig, nmc_run
    from nmc_tpu_torch.io.generators import random_sk
    prob = random_sk(10, seed=4)
    cfg = NMCConfig(num_sweeps_initial=30, num_sweeps_per_NMC_phase=20,
                    num_NMC_cycles=1, global_beta=1.5, dtype="float64",
                    block_size=16, record_m=False, lambda_start=3.0,
                    tolerance=1e-10, max_iterations=300)
    res = nmc_run(prob, cfg, torch.Generator().manual_seed(0), device="cpu")
    np.testing.assert_allclose(res.min_energy,
                               prob.normalized()[0].energy(res.m_best),
                               rtol=1e-12)
