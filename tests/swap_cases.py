"""Label-swap cases shared by the CPU and the card tests of
`nmc_tpu_torch.parallel.swaps` (no JAX here: the card's machine has none).

CASES maps a name to (I ladders, R labels, num_pairs, energies' kind):
the benchmark cells' ladder shapes, then edge cases. `make_case` builds a
case's inputs and draws from a seed on a device; `old_select_pairs` and
`old_label_swap` are the swap stage as torch operations before it became
one kernel (its -inf a copy from host memory), kept as the oracle.
"""

import numpy as np
import torch

CASES = {
    # the cells: I x R x pairs
    "chimera2048_x20.pt": (20, 32, 8, "spread"),
    "chimera2048_x20.nmc": (20, 32, 8, "close"),
    "chimera2048_icm_x20.pt": (200, 32, 8, "spread"),
    "chimera5408_sharded.pt_4chip": (1, 64, 16, "spread"),
    "sk1000_x100.pt": (100, 64, 4, "close"),
    # edges
    "two_labels": (7, 2, 2, "spread"),            # one pair, the second -1
    "more_pairs_than_fit": (9, 8, 6, "close"),    # some picks -1
    "lanes_hold_two": (13, 40, 12, "spread"),     # R - 1 > 32
    "lanes_hold_four": (5, 100, 40, "close"),     # R - 1 > 64
    "equal_energies": (11, 16, 5, "equal"),       # dE = 0, always accepted
    "exp_overflows": (11, 16, 5, "huge"),         # exp(dB dE) = inf -> 1
    "nan_from_inf": (11, 16, 5, "inf"),           # inf - inf: never accepted
    "int32_labels": (6, 12, 4, "spread"),
}


def make_case(name, seed, device):
    """(beta_to_slot, beta_list, slot_energies, gumbels, uniforms) of case
    `name`: shuffled labels, a geometric ladder, energies of the case's
    kind (float32), and Gumbels and uniforms drawn as the engines draw
    them (`swaps.swap_draws`' distributions)."""
    I, R, num_pairs, kind = CASES[name]
    rng = np.random.default_rng(seed)
    b2s = np.stack([rng.permutation(R) for _ in range(I)])
    beta = np.geomspace(0.25, 32.0, R).astype(np.float32)
    if kind == "spread":
        e = rng.normal(size=(I, R)) * 3.0
    elif kind == "close":
        e = rng.normal(size=(I, R)) * 0.05
    elif kind == "equal":
        e = np.full((I, R), -7.5)
    elif kind == "huge":
        e = rng.normal(size=(I, R)) * 1e30
    else:
        e = rng.normal(size=(I, R))
        e[rng.random((I, R)) < 0.3] = np.inf
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand((I, num_pairs, R - 1), generator=gen)
    g = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    su = torch.rand((I, num_pairs), generator=gen)
    dtype = torch.int32 if name == "int32_labels" else torch.int64
    return (torch.as_tensor(b2s, dtype=dtype, device=device),
            torch.as_tensor(beta, device=device),
            torch.as_tensor(e, dtype=torch.float32, device=device),
            g.to(device), su.to(device))


def old_select_pairs(num_replicas, num_pairs, gumbels):
    """select_pairs_device before the kernel, with injected Gumbels."""
    P = num_replicas - 1
    device = gumbels.device
    I = gumbels.shape[0]
    avail = torch.ones((I, P), dtype=torch.bool, device=device)
    cols = torch.arange(P, device=device)
    neg_inf = torch.tensor(float("-inf"), dtype=gumbels.dtype, device=device)
    picks = []
    for k in range(num_pairs):
        scores = torch.where(avail, gumbels[:, k], neg_inf)
        idx = torch.argmax(scores, dim=1)
        valid = avail.any(dim=1)
        picks.append(torch.where(valid, idx, torch.full_like(idx, -1)))
        near = (cols[None, :] - idx[:, None]).abs() <= 1
        avail = avail & ~(near & valid[:, None])
    return torch.stack(picks, dim=1)


def old_label_swap(beta_to_slot, beta_list, slot_energies, gumbels, uniforms):
    """metropolis_label_swap before the kernel, with injected draws:
    (beta_to_slot, slot_to_beta, accepted, pairs)."""
    I, R = beta_to_slot.shape
    num_pairs = uniforms.shape[1]
    device = beta_to_slot.device
    picks = old_select_pairs(R, num_pairs, gumbels)
    b2s = beta_to_slot.clone()
    rows = torch.arange(I, device=device)
    accepted = []
    for k in range(num_pairs):
        b = picks[:, k]
        valid = b >= 0
        bc = b.clamp(0, R - 2)
        s_lo = b2s[rows, bc]
        s_hi = b2s[rows, bc + 1]
        dB = beta_list[bc + 1] - beta_list[bc]
        dE = slot_energies[rows, s_hi] - slot_energies[rows, s_lo]
        accept = valid & (uniforms[:, k] < torch.exp(dB * dE).clamp(max=1.0))
        b2s[rows, bc] = torch.where(accept, s_hi, s_lo)
        b2s[rows, bc + 1] = torch.where(accept, s_lo, s_hi)
        accepted.append(accept)
    slot_to_beta = torch.empty_like(b2s)
    slot_to_beta.scatter_(1, b2s, torch.arange(R, dtype=b2s.dtype,
                                               device=device).expand(I, R))
    return b2s, slot_to_beta, torch.stack(accepted, dim=1), picks


def assert_same(got, want):
    """Every output element for element, with its dtype."""
    for name, a, b in zip(("beta_to_slot", "slot_to_beta", "accepted",
                           "pairs"), got, want):
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        assert torch.equal(a, b), name
