"""EnsembleNMC's plain route against nmc_tpu's XLA round, f64.

The port's plain round (`round_kernel="off"`: per instance and phase a
fresh phi and one `run_sweeps` call) against JAX's EnsembleNMC with
round_kernel="off", both in f64, from the same state, with JAX's
per-phase uniforms and swap draws replayed (tests/torch_parity.
ensemble_replay): m, beta_to_slot, cl and do_nmc_slot exact, e_best to
1e-10, m_best through its energy, for each LBP mode. The plain round heats
by base_row * f32(1 / temp_x) as the XLA round does; the kernels' heated
factor is pinned in tests/test_torch_round.py.
"""

import numpy as np
import pytest

from test_torch_ensemble_nmc import assert_states_equal, config, run_both


@pytest.mark.parametrize("lbp_mode", ["dense", "sparse", "planes"])
def test_plain_route_matches_jax(lbp_mode):
    js, ts, te, probs = run_both(
        config(lbp_mode=lbp_mode, dtype="float64", round_kernel="off",
               lbp_tolerance=1e-10, lbp_max_iterations=40),
        plain=True, dtype="float64")
    assert te.round_path == "plain"
    assert_states_equal(js, ts, te, probs, atol=1e-10)


def test_plain_route_on_an_uncoloured_family():
    """'auto' on an uncoloured (wishart-like dense) family takes the plain
    route with sequential in-block sweeps, as JAX takes its XLA round."""
    js, ts, te, probs = run_both(
        config(lbp_mode="dense", dtype="float64", use_coloring=False,
               round_kernel="auto", lbp_tolerance=1e-10,
               lbp_max_iterations=40),
        plain=True, dtype="float64")
    assert te.cfg.within_block == "sequential"
    assert_states_equal(js, ts, te, probs, atol=1e-10)
    assert np.isfinite(ts.e_best.numpy()).all()
