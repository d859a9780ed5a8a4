"""Heat-bath sweeps in plain torch: a whole NMC / PT round of colour-class
block sweeps, and the sequential fixed-order sweep.

Both follow the definitions the program states for its kernels, with the
association of every floating sum spelled out where it decides bits:

  * `round_sweeps` (what one launch of the program's whole-round kernel
    computes): per phase of the static list (C, NC and ALL), the update
    mask and heated beta from the activity mask, the backbone masks and
    the NMC flags; phi = J m + h afresh; `T` sweeps over the row blocks,
    each block drawn at once from the same phi (a block lies in one colour
    class), then phi += dm J; a strict-< phase best at sweep ends from
    +inf; NMC slots jump to their phase best; the round best takes a lower
    phase best. A run of consecutive blocks with no coupling between any
    two of them (`steps`) is drawn as one: no block of it changes
    another's fields, so that is the same sweep. On integer couplings
    every field and energy is an integer, so no association changes a
    bit; the round engines' references take integer couplings only.
  * `sequential_sweeps` (the sequential kernel's function): spin after
    spin within a block from x = phi + corr, corr += d J_diag row in flip
    order; after the block, per target acc = 0, acc += dm_k J_kj over the
    block's spins in ascending k, phi += acc; energies summed as one warp
    of 32 lanes sums them (lane-strided, then an xor butterfly).

A draw is new = +1 iff u < 0.5 (1 + tanh(beta x)).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .precision import Precision


def phase_list(num_cycles: int, full_update_frequency: int):
    out = []
    for cycle in range(num_cycles):
        out += ["C", "NC"] + (["ALL"] if cycle % full_update_frequency == 0
                              else [])
    return out


def heated_factor(temp_x: float) -> float:
    """1 + f32(1 / temp_x - 1), in float32."""
    f = torch.tensor(1.0 / temp_x - 1.0, dtype=torch.float64).float()
    return float(torch.tensor(1.0, dtype=torch.float32) + f)


def steps(J, B: int):
    """[(start, end)] spin ranges of the sweep's steps: maximal runs of
    consecutive blocks of B spins with no coupling between any two of them
    in any instance of J [I, n_pad, n_pad] (numpy)."""
    nB = J.shape[-1] // B
    coupled = np.any(J.reshape(J.shape[0], nB, B, nB, B) != 0, axis=(0, 2, 4))
    out, start = [], 0
    for b in range(1, nB + 1):
        if b == nB or coupled[start:b, b].any():
            out.append((start * B, b * B))
            start = b
    return out


def _draw(beta, x, u, dt):
    p_up = 0.5 * (1.0 + torch.tanh(beta * x))
    return torch.where(u < p_up, 1.0, -1.0).to(dt)


def round_sweeps(prec: Precision, J, h, act, m0, cl, dn, beta_row,
                 draw: Callable[[int, int], torch.Tensor], *,
                 phases: Sequence[str], T: int, heat: float,
                 ranges: Sequence[tuple]):
    """One round of every (instance, slot): J [I, n_pad, n_pad], h [I,
    n_pad], act [n_pad] bool, m0 [I, R, n_pad], cl [I, R, n_pad] bool, dn
    [I, R] bool, beta_row [I, R]; `draw(p, t)` gives phase p's sweep t's
    uniforms [I, R, n_pad]; `ranges` the sweep's steps (`steps`). Returns
    float32 (m, m_best, e_best, e_carried)."""
    I, R, n_pad = m0.shape
    dt = prec.dtype
    J = prec(J)
    h3 = prec(h)[:, None, :]
    act = act.expand(I, R, n_pad)
    dn3 = dn.reshape(I, R, 1)
    beta = prec(beta_row.reshape(I, R, 1))
    beta_hot = beta * prec(torch.tensor(heat, device=beta.device))
    m = prec(m0).clone()
    m_best = m.clone()
    inf = torch.tensor(float("inf"), dtype=dt, device=m.device)
    e_best = inf.expand(I, R).clone()

    def phi_of(x):
        return prec.mm(x, J).to(dt) + h3

    for p, kind in enumerate(phases):
        if kind == "C":
            mask = torch.where(dn3, cl & act, act)
            betas = torch.where(dn3 & cl, beta_hot, beta)
        elif kind == "NC":
            mask, betas = torch.where(dn3, ~cl & act, act), beta
        else:
            mask, betas = act, beta
        phi = phi_of(m)
        e_phase = inf.expand(I, R).clone()
        m_phase = m.clone()
        for t in range(T):
            u = prec(draw(p, t))
            for s0, s1 in ranges:
                blk = slice(s0, s1)
                bb = betas if betas.shape[-1] == 1 else betas[..., blk]
                old = m[..., blk]
                new = torch.where(mask[..., blk],
                                  _draw(bb, phi[..., blk], u[..., blk], dt),
                                  old)
                dm = new - old
                m[..., blk] = new
                phi = phi + prec.mm(dm, J[:, blk, :]).to(dt)
            e = -0.5 * torch.sum(m * (phi + h3), dim=-1)
            better = e < e_phase
            e_phase = torch.where(better, e, e_phase)
            m_phase = torch.where(better[..., None], m, m_phase)
        m = torch.where(dn3, m_phase, m)
        better = e_phase < e_best
        e_best = torch.where(better, e_phase, e_best)
        m_best = torch.where(better[..., None], m_phase, m_best)
    e_carried = -0.5 * torch.sum(m * (phi_of(m) + h3), dim=-1)
    return m.float(), m_best.float(), e_best.float(), e_carried.float()


def warp_energy(h, m, phi):
    """E = -1/2 m.(phi + h) over [..., n_pad] as 32 lanes sum it: lane l
    adds j = l, l + 32, ... in order from 0, then an xor butterfly."""
    *lead, n_pad = m.shape
    lanes = -(-n_pad // 32)
    x = torch.zeros(tuple(lead) + (lanes * 32,), dtype=m.dtype,
                    device=m.device)
    x[..., :n_pad] = m * (phi + h)
    x = x.reshape(tuple(lead) + (lanes, 32))
    acc = torch.zeros(tuple(lead) + (32,), dtype=m.dtype, device=m.device)
    for i in range(lanes):
        acc = acc + x[..., i, :]
    lane = torch.arange(32, device=m.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lane ^ off]
    return -0.5 * acc[..., 0]


def sequential_sweeps(prec: Precision, J, h, active, m0, phi0, beta,
                      draw: Callable[[int], torch.Tensor], *, T: int, B: int):
    """T sequential sweeps of I instances: J [I, n_pad, n_pad], h [I, n_pad],
    active [n_pad] (a host bool array; padding is never updated), m0 / phi0
    [I, R, n_pad], beta [I, R]; `draw(t)` gives sweep t's uniforms [I, R,
    n_pad]. Returns float32 (m, m_best, e_best, energies [I, T, R])."""
    I, R, n_pad = m0.shape
    dt = prec.dtype
    J = prec(J)
    hb = prec(h)[:, None, :]
    beta = prec(beta.reshape(I, R))
    m = prec(m0).clone()
    phi = prec(phi0).clone()
    m_best = m.clone()
    e_best = torch.full((I, R), float("inf"), dtype=dt, device=m.device)
    energies = []
    for t in range(T):
        u = prec(draw(t))
        for s in range(0, n_pad, B):
            blk = slice(s, s + B)
            diag = J[:, None, blk, blk]                     # [I, 1, B, B]
            mb = m[..., blk].clone()
            xb = phi[..., blk]
            corr = torch.zeros_like(xb)
            for i in range(B):
                if not active[s + i]:
                    continue
                old = mb[..., i]
                new = _draw(beta, xb[..., i] + corr[..., i], u[..., s + i], dt)
                corr = corr + (new - old)[..., None] * diag[..., i, :]
                mb[..., i] = new
            dm = mb - m[..., blk]
            acc = torch.zeros_like(phi)
            for k in range(B):
                acc = acc + dm[..., k:k + 1] * J[:, None, s + k, :]
            phi = phi + acc
            m[..., blk] = mb
        e = warp_energy(hb, m, phi)
        better = e < e_best
        m_best = torch.where(better[..., None], m, m_best)
        e_best = torch.where(better, e, e_best)
        energies.append(e)
    return (m.float(), m_best.float(), e_best.float(),
            torch.stack(energies, dim=1).float())
