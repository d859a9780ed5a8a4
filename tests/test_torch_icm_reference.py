"""The benchmark's plain APT+ICM reference (`perfbench/reference/
ensemble_icm.py` and `houdayer.py`) against the program on the CPU.

The ICM cell at its tiny size runs correct through the harness, the state
bit for bit; the reference's union-find labels equal the minima of the
host's connected components (scipy); and its move equals the program's
`houdayer_move_sparse` from the same uniforms, in both branches: a
cluster exchanged, and Katzgraber's flip of the first chain.
"""

import time

import numpy as np
import pytest
import torch

from nmc_tpu_torch.ops import clusters
from perfbench import check, harness, instances
from perfbench.conftest import tiny_cell
from perfbench.reference import houdayer

WORKLOAD = "chimera2048_icm_x20.pt"
# the share of spins on which the second chain of a pair is the first one
# flipped: sparse sets give small clusters, a whole flip one cluster of
# every spin (past n // 2, so Katzgraber's branch)
DISAGREE = (0.1, 0.3, 0.5, 0.7, 0.9, 1.0)


def test_the_tiny_icm_cell_runs_correct_bit_for_bit():
    cell = tiny_cell(WORKLOAD)
    rec = harness.run_rank(cell, 2147483689, 0.2, False,
                           t_process=time.time(), device="cpu")
    line = harness.assemble(cell, [rec], False)
    nums = check.numbers(rec["tally"])
    assert line["correct"], line["checks"]
    assert nums["spin_diff"] == 0 and nums["label_diff"] == 0
    assert rec["rounds"] >= 3


def _pairs(seed, per_share=4, m=3):
    """(J [n, n], s1, s2 [P, n] float32) on one chimera C_m instance."""
    J = instances.chimera_family(m, 4, 1,
                                 torch.Generator().manual_seed(seed))[0]
    n = J.shape[0]
    g = torch.Generator().manual_seed(seed + 1)
    P = per_share * len(DISAGREE)
    s1 = torch.where(torch.rand((P, n), generator=g) < 0.5, -1.0, 1.0)
    share = torch.tensor(DISAGREE).repeat_interleave(per_share)[:, None]
    flip = torch.rand((P, n), generator=g) < share
    return J, s1, torch.where(flip, -s1, s1)


def _edges(J):
    u, v = np.nonzero(J)
    return torch.as_tensor(u), torch.as_tensor(v)


@pytest.mark.parametrize("seed", [3, 17, 2147483647])
def test_union_find_labels_are_the_minima_of_the_host_components(seed):
    J, s1, s2 = _pairs(seed)
    P, n = s1.shape
    src, dst = _edges(J)
    live = torch.ones((P, src.numel()), dtype=torch.bool)
    got = houdayer.components(src, dst, live, s1 * s2 < 0)
    for p in range(P):
        want = np.full(n, n)
        for comp in clusters.disagreement_clusters(J, s1[p].numpy(),
                                                   s2[p].numpy()):
            want[comp] = comp.min()
        np.testing.assert_array_equal(got[p].numpy(), want)


def test_dead_couplings_split_components():
    """A pair's instance without a coupling joins nothing across it."""
    J, s1, _ = _pairs(5, per_share=1)
    n = J.shape[0]
    src, dst = _edges(J)
    live = torch.ones((1, src.numel()), dtype=torch.bool)
    dead = live.clone()
    dead[0, src == 0] = False
    dead[0, dst == 0] = False
    diff = torch.ones((1, n), dtype=torch.bool)
    assert bool((houdayer.components(src, dst, live, diff) == 0).all())
    cut = houdayer.components(src, dst, dead, diff)
    assert cut[0, 0] == 0 and bool((cut[0, 1:] == 1).all())


@pytest.mark.parametrize("seed", [3, 17, 2147483647])
def test_the_move_equals_the_programs_in_both_branches(seed):
    J, s1, s2 = _pairs(seed)
    P, n = s1.shape
    src, dst = _edges(J)
    u = torch.rand((P, n), generator=torch.Generator().manual_seed(seed + 2))
    a1, a2, moved, flipped = clusters.houdayer_move_sparse(
        src, dst, s1, s2, g=u, use_katzgraber=True)
    labels = houdayer.components(
        src, dst, torch.ones((P, src.numel()), dtype=torch.bool),
        s1 * s2 < 0)
    b1, b2 = houdayer.move(labels, s1, s2, u, n // 2)
    assert torch.equal(a1, b1) and torch.equal(a2, b2)
    assert bool(moved.any()) and bool(flipped.any())
    # an exchange leaves the pair's spins as a multiset; a flip negates s1
    ex, fl = moved.nonzero()[:, 0], flipped.nonzero()[:, 0]
    assert torch.equal((b1 + b2)[ex], (s1 + s2)[ex])
    assert torch.equal(b1[fl], -s1[fl]) and torch.equal(b2[fl], s2[fl])
