"""Replica exchange by label swaps, on the device and batched over instances.

The counterpart of ``nmc_tpu/parallel/swaps.py``. Replicas never move: a
permutation pair (beta_to_slot, slot_to_beta) maps temperature indices to
chain slots, and a swap exchanges two LABELS. Selection keeps the
reference's sequential draw of non-overlapping adjacent pairs with a fixed
trip count (a Gumbel argmax over the shrinking availability mask, -1 where
no pair is left), and the Metropolis rule is u < min(1, exp(dB * dE)) with
states fixed and labels exchanged.

Both functions take a leading instance axis I (the JAX engine vmaps them
over instances) and read nothing back to the host. On CUDA tensors
`metropolis_label_swap` is one launch of `csrc/label_swaps.cu` (through
`ops.swaps_cuda.label_swaps`, which counts them), so the host enqueues the
next round while the card still sweeps this one; on CPU tensors it runs
its plain twin, `label_swap_reference`, whose torch operations the kernel
repeats bit for bit. Their draws come from a `torch.Generator`, or are
injected (`gumbels` [I, num_pairs, R - 1], `uniforms` [I, num_pairs]) so
that tests can replay JAX's keys.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.swaps_cuda import label_swaps


def _gumbel(shape, generator, dtype, device):
    """-log(-log(u)), u uniform in (0, 1), as jax.random.gumbel draws."""
    tiny = torch.finfo(dtype).tiny
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def _gumbels(I, num_pairs, P, generator, gumbels):
    """The Gumbels [I, num_pairs, P]: drawn from `generator` on its device,
    or the injected ones, checked."""
    if gumbels is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or injected gumbels")
        gumbels = _gumbel((I, num_pairs, P), generator, torch.float32,
                          generator.device)
    if tuple(gumbels.shape) != (I, num_pairs, P):
        raise ValueError(f"gumbels must be [I, {num_pairs}, {P}], "
                         f"got {tuple(gumbels.shape)}")
    return gumbels


def select_pairs_device(
    num_replicas: int,
    num_pairs: int,
    *,
    num_instances: int = 1,
    generator: Optional[torch.Generator] = None,
    gumbels: Optional[torch.Tensor] = None,   # [I, num_pairs, R - 1]
    device=None,
) -> torch.Tensor:
    """Draw `num_pairs` non-overlapping adjacent pairs per instance, one
    after another. Returns [I, num_pairs] pair base indices b (the pair is
    (b, b + 1) over temperature indices), or -1 where no pair was left."""
    P = num_replicas - 1
    if P < 1:
        raise ValueError(f"need at least 2 replicas, got {num_replicas}")
    I = num_instances if gumbels is None else gumbels.shape[0]
    gumbels = _gumbels(I, num_pairs, P, generator, gumbels)
    device = gumbels.device if device is None else torch.device(device)
    gumbels = gumbels.to(device)
    avail = torch.ones((I, P), dtype=torch.bool, device=device)
    cols = torch.arange(P, device=device)
    picks = []
    for k in range(num_pairs):
        scores = torch.where(avail, gumbels[:, k], float("-inf"))
        idx = torch.argmax(scores, dim=1)                   # first max, as JAX
        valid = avail.any(dim=1)
        picks.append(torch.where(valid, idx, torch.full_like(idx, -1)))
        # pairs overlapping (idx, idx + 1) are idx - 1, idx and idx + 1
        near = (cols[None, :] - idx[:, None]).abs() <= 1
        avail = avail & ~(near & valid[:, None])
    return torch.stack(picks, dim=1)


class SwapResult(NamedTuple):
    beta_to_slot: torch.Tensor   # [I, R] temperature index -> chain slot
    slot_to_beta: torch.Tensor   # [I, R] chain slot -> temperature index
    accepted: torch.Tensor       # [I, num_pairs] bool (False for invalid picks)
    pairs: torch.Tensor          # [I, num_pairs] pair base temperature indices


def label_swap_reference(beta_to_slot, beta_list, slot_energies, gumbels,
                         uniforms) -> SwapResult:
    """The plain twin of the kernel: the picks of `select_pairs_device`,
    then the Metropolis steps in order, then the inverse permutation."""
    I, R = beta_to_slot.shape
    device = beta_to_slot.device
    num_pairs = uniforms.shape[1]
    picks = select_pairs_device(R, num_pairs, gumbels=gumbels, device=device)
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
    return SwapResult(beta_to_slot=b2s, slot_to_beta=slot_to_beta,
                      accepted=torch.stack(accepted, dim=1), pairs=picks)


def metropolis_label_swap(
    beta_to_slot: torch.Tensor,   # [I, R] int
    beta_list: torch.Tensor,      # [R] temperatures by index
    slot_energies: torch.Tensor,  # [I, R] energy of each chain slot's state
    *,
    num_pairs: int,
    generator: Optional[torch.Generator] = None,
    gumbels: Optional[torch.Tensor] = None,    # [I, num_pairs, R - 1]
    uniforms: Optional[torch.Tensor] = None,   # [I, num_pairs]
) -> SwapResult:
    """One swap round over temperature labels, per instance: accept iff
    u < min(1, exp((beta[b+1] - beta[b]) * (E[slot(b+1)] - E[slot(b)]))).
    The kernel on CUDA tensors, `label_swap_reference` on CPU tensors."""
    I, R = beta_to_slot.shape
    device = beta_to_slot.device
    if R < 2:
        raise ValueError(f"need at least 2 replicas, got {R}")
    if num_pairs < 1:
        raise ValueError(f"num_pairs must be at least 1, got {num_pairs}")
    gumbels = _gumbels(I, num_pairs, R - 1, generator, gumbels).to(device)
    if uniforms is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or injected uniforms")
        uniforms = torch.rand((I, num_pairs), generator=generator,
                              dtype=slot_energies.dtype,
                              device=generator.device)
    if tuple(uniforms.shape) != (I, num_pairs):
        raise ValueError(f"uniforms must be [{I}, {num_pairs}], "
                         f"got {tuple(uniforms.shape)}")
    uniforms = uniforms.to(device)
    if device.type == "cpu":
        return label_swap_reference(beta_to_slot, beta_list, slot_energies,
                                    gumbels, uniforms)
    return SwapResult(*label_swaps(beta_to_slot, beta_list, slot_energies,
                                   gumbels.contiguous(),
                                   uniforms.contiguous()))


def swap_draws(generator: torch.Generator, num_rows: int, num_pairs: int,
               num_replicas: int, offset: int = 0,
               count: Optional[int] = None):
    """(gumbels [count, num_pairs, R - 1], uniforms [count, num_pairs]):
    the draws `metropolis_label_swap` makes for `num_rows` ladders, drawn
    for all of them in its order and cut to rows [offset, offset + count),
    so that a rank holding some of the ladders swaps them as the whole
    batch would."""
    count = num_rows - offset if count is None else count
    g = _gumbel((num_rows, num_pairs, num_replicas - 1), generator,
                torch.float32, generator.device)
    u = torch.rand((num_rows, num_pairs), generator=generator,
                   dtype=torch.float32, device=generator.device)
    return g[offset:offset + count], u[offset:offset + count]
