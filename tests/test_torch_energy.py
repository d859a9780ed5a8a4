"""nmc_tpu_torch.core.energy against nmc_tpu.core.energy (f64, atol 1e-12)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmc_tpu.core import energy as je
from nmc_tpu_torch.core import energy as te

from conftest import random_sk


@pytest.mark.parametrize("n,batch", [(7, ()), (16, (5,)), (12, (2, 3))])
def test_energy_functions_match_jax(rng, n, batch):
    J, h = random_sk(rng, n)
    m = np.where(rng.random(batch + (n,)) < 0.5, -1.0, 1.0)
    Jt, ht, mt = (torch.as_tensor(x, dtype=torch.float64) for x in (J, h, m))
    Jj, hj, mj = (jnp.asarray(x, dtype=jnp.float64) for x in (J, h, m))

    phi_t = te.local_fields(Jt, ht, mt).numpy()
    phi_j = np.asarray(je.local_fields(Jj, hj, mj))
    np.testing.assert_allclose(phi_t, phi_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(te.energy(Jt, ht, mt).numpy(),
                               np.asarray(je.energy(Jj, hj, mj)),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        te.energy_from_fields(ht, mt, torch.as_tensor(phi_t)).numpy(),
        np.asarray(je.energy_from_fields(hj, mj, jnp.asarray(phi_j))),
        rtol=0, atol=1e-12)
    # E from cached fields equals the quadratic form
    np.testing.assert_allclose(
        te.energy_from_fields(ht, mt, torch.as_tensor(phi_t)).numpy(),
        te.energy(Jt, ht, mt).numpy(), rtol=0, atol=1e-12)
