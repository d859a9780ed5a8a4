"""Replica exchange by temperature labels (a frozen copy of the program's
rule, so that the swap decisions follow the same draws).

Per instance, `num_pairs` non-overlapping adjacent pairs are drawn one
after another (a Gumbel argmax over the pairs still free), and pair
(b, b + 1) exchanges labels iff u < min(1, exp((beta[b+1] - beta[b]) *
(E[slot(b+1)] - E[slot(b)]))). States never move.
"""

from __future__ import annotations

import torch


def gumbel(shape, generator, dtype=torch.float32):
    tiny = torch.finfo(dtype).tiny
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def swap_draws(generator, rows: int, num_pairs: int, replicas: int):
    """(gumbels [rows, num_pairs, R - 1], uniforms [rows, num_pairs]), drawn
    in that order."""
    g = gumbel((rows, num_pairs, replicas - 1), generator)
    u = torch.rand((rows, num_pairs), generator=generator,
                   dtype=torch.float32, device=generator.device)
    return g, u


def label_swap(beta_to_slot, beta, energies, gumbels, uniforms):
    """(beta_to_slot, slot_to_beta) [I, R] after one swap round;
    `energies` [I, R] by chain slot, `beta` [R] float32."""
    I, R = beta_to_slot.shape
    dev = beta_to_slot.device
    num_pairs = gumbels.shape[1]
    gumbels, uniforms = gumbels.to(dev), uniforms.to(dev)
    avail = torch.ones((I, R - 1), dtype=torch.bool, device=dev)
    cols = torch.arange(R - 1, device=dev)
    neg_inf = torch.tensor(float("-inf"), dtype=gumbels.dtype, device=dev)
    picks = []
    for k in range(num_pairs):
        idx = torch.argmax(torch.where(avail, gumbels[:, k], neg_inf), dim=1)
        valid = avail.any(dim=1)
        picks.append(torch.where(valid, idx, torch.full_like(idx, -1)))
        near = (cols[None, :] - idx[:, None]).abs() <= 1
        avail = avail & ~(near & valid[:, None])
    b2s = beta_to_slot.clone()
    rows = torch.arange(I, device=dev)
    for k in range(num_pairs):
        b = picks[k]
        bc = b.clamp(0, R - 2)
        s_lo, s_hi = b2s[rows, bc], b2s[rows, bc + 1]
        dB = beta[bc + 1] - beta[bc]
        dE = energies[rows, s_hi] - energies[rows, s_lo]
        accept = (b >= 0) & (uniforms[:, k] < torch.exp(dB * dE).clamp(max=1.0))
        b2s[rows, bc] = torch.where(accept, s_hi, s_lo)
        b2s[rows, bc + 1] = torch.where(accept, s_lo, s_hi)
    s2b = torch.empty_like(b2s)
    s2b.scatter_(1, b2s, torch.arange(R, dtype=b2s.dtype,
                                      device=dev).expand(I, R))
    return b2s, s2b
