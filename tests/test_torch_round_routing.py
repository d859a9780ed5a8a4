"""EnsembleNMC's round route (`round_path`) on colored layouts above n_pad
1536, on the CPU: every colored float32 layout inside the round kernels'
own limits (`round_kernel_limit`: the neighbour layout's int16 spin
indices, the CTA's shared memory) takes K5 or K4, never a raise; past
those limits `round_kernel="on"` raises naming the limit.

K5's old gate (union tile count K <= max(nB - 1, 1)) always holds on a
colored layout: each row block is an independent set of one colour class,
so its diagonal tile is zero in every instance. That is asserted as a
property on several random families.
"""

import numpy as np
import pytest

from nmc_tpu_torch.core.problem import IsingProblem, block_problem
from nmc_tpu_torch.io.generators import chimera_graph
from nmc_tpu_torch.ops.coloring import color_groups
from nmc_tpu_torch.ops.engine import K1_MAX_N_PAD
from nmc_tpu_torch.ops.round_cuda import round_kernel_limit
from nmc_tpu_torch.ops.sweeps_cuda import MAX_SHARED_BYTES
from nmc_tpu_torch.parallel import EnsembleNMC, ShardedNPTConfig
from nmc_tpu_torch.parallel import ensemble_nmc as ten


def _regular(n, degree, seed):
    """The union of `degree` random perfect matchings, +-1 weights."""
    rng = np.random.default_rng(seed)
    J = np.zeros((n, n))
    for _ in range(degree):
        p = rng.permutation(n)
        a, c = p[:n // 2], p[n // 2:]
        w = rng.choice([-1.0, 1.0], size=n // 2)
        J[a, c] = w
        J[c, a] = w
    return IsingProblem(J, np.zeros(n))


def _erdos_renyi(n, p, seed):
    rng = np.random.default_rng(seed)
    J = np.triu(rng.normal(size=(n, n)) * (rng.random((n, n)) < p), 1)
    return IsingProblem(J + J.T, np.zeros(n))


FAMILIES = {
    "chimera_16x16": lambda s: chimera_graph(16, 16, seed=s),
    "regular3_2048": lambda s: _regular(2048, 3, 10 + s),
    "regular6_1800": lambda s: _regular(1800, 6, 20 + s),
    "erdos_renyi_1700": lambda s: _erdos_renyi(1700, 0.004, 30 + s),
    "erdos_renyi_2500": lambda s: _erdos_renyi(2500, 0.01, 40 + s),
}


def _ensemble(probs, **cfg):
    return EnsembleNMC(probs, np.geomspace(0.3, 3.0, 4), [False] * 4,
                       ShardedNPTConfig(use_coloring=True, **cfg),
                       device="cpu")


@pytest.mark.parametrize("name", sorted(FAMILIES))
@pytest.mark.parametrize("seed", [0, 1])
def test_union_diagonal_tiles_are_zero(name, seed):
    """On the union colouring every row block's diagonal tile is zero in
    every instance, so K <= nB - 1 whenever nB > 1."""
    probs = [FAMILIES[name](seed + 2 * i) for i in range(2)]
    J_union = sum(np.abs(np.asarray(p.J)) for p in probs)
    blocked = [block_problem(p, groups=color_groups(J_union),
                             dtype=np.float32) for p in probs]
    assert blocked[0].colored
    nB, B = blocked[0].num_blocks, blocked[0].block_size
    for bl in blocked:
        rows = bl.J_rows.reshape(nB, B, nB, B)
        for b in range(nB):
            assert not rows[b, :, b, :].any()
    col_idx, _ = ten._union_tiles(blocked)
    assert nB > 1 and col_idx.shape[1] <= nB - 1


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_colored_layout_above_1536_takes_k5(name):
    """round_kernel="on" (which raises when no kernel fits) takes K5 over
    the union tiles at every colored n_pad above 1536."""
    ens = _ensemble([FAMILIES[name](s) for s in range(2)], round_kernel="on")
    assert ens.n_pad > K1_MAX_N_PAD
    assert ens.round_path == "K5" and ens._stream_tiles is not None
    assert ens.round_nbrs is not None


@pytest.mark.parametrize("n_pad,block_size,limit", [
    (32768, 128, None), (32896, 128, "int16"), (65536, 128, "int16"),
    (32768, 4096, "shared memory"), (16384, 32768, "shared memory")])
def test_round_kernel_limit_names_the_limit(n_pad, block_size, limit):
    got = round_kernel_limit(n_pad, block_size)
    if limit is None:
        assert got is None
    else:
        assert limit in got and str(n_pad) in got
        if limit == "shared memory":
            assert str(MAX_SHARED_BYTES) in got


@pytest.mark.parametrize("limit", ["n_pad 40000 > 32768, the int16 spin "
                                   "indices of the round kernels' neighbour "
                                   "layout",
                                   "n_pad 40000 needs 280512 bytes of shared "
                                   "memory per CTA, above the 232448 a CTA "
                                   "has"])
def test_layout_past_the_limits_raises_with_it(limit, monkeypatch):
    """A layout past the kernels' limits (stood in for by the limit check:
    a real one holds 40000^2 dense couplings) raises under "on", naming the
    limit, and runs the plain round under "auto" on the CPU."""
    monkeypatch.setattr(ten, "round_kernel_limit", lambda n, b: limit)
    probs = [chimera_graph(8, 8, seed=s) for s in range(2)]
    with pytest.raises(ValueError, match="no round kernel fits") as err:
        _ensemble(probs, round_kernel="on")
    assert limit in str(err.value)
    assert _ensemble(probs, round_kernel="auto").round_path == "plain"
