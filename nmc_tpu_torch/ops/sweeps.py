"""Blocked heat-bath Gibbs sweeps in plain torch.

The counterpart of ``nmc_tpu/ops/sweeps.py`` (which JAX ran through XLA,
not Pallas):

  * Local fields phi = J@m + h are cached and updated incrementally.
  * Spins are processed in blocks of `block_size`. Within a block the
    update is either
      - 'sequential': exact heat-bath Gibbs with a running intra-block
        correction (rank-1 updates), so spin i sees every earlier flip in
        its block; or
      - 'jacobi': all block spins at once, which is EXACT Gibbs whenever the
        block is an independent set (graph-colored blocks).
    After each block, phi += dm @ J[block, :].
  * Blocks go in index order ('fixed') or, with block_order='random', in a
    fresh permutation per sweep (drawn after the sweep's uniforms, as JAX
    splits each sweep key into a uniform key and a permutation key).
  * Heating and freezing are a per-spin beta multiplier and an update mask.
  * Per-sweep energies come from phi: E = -0.5 * m.(phi + h), and the
    per-replica argmin-energy state is tracked as a running best.

Randomness comes either from a `torch.Generator` (one [R, n_pad] uniform
draw per sweep, then the block permutation under 'random') or from
injected uniforms [T, R, n_pad] in blocked layout and block orders [T, nB],
which lets tests replay another implementation's draws exactly.

Heat-bath rule: m_k <- +1 with probability (1 + tanh(beta_k * phi_k)) / 2.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.energy import energy_from_fields


class SweepResult(NamedTuple):
    m: torch.Tensor          # [R, n_pad] final states
    phi: torch.Tensor        # [R, n_pad] final local fields (J@m + h)
    m_best: torch.Tensor     # [R, n_pad] per-replica argmin-energy state seen
    e_best: torch.Tensor     # [R] its energy
    energies: torch.Tensor   # [T, R] post-sweep energies
    M: Optional[torch.Tensor]  # [T, R, n_pad] recorded states (None unless record_m)


def heat_bath_update(x, beta_eff, u, m_old, mask):
    """One heat-bath draw: P(m=+1) = (1 + tanh(beta*x)) / 2, masked."""
    p_up = 0.5 * (1.0 + torch.tanh(beta_eff * x))
    m_new = torch.where(u < p_up, 1.0, -1.0).to(m_old.dtype)
    return torch.where(mask, m_new, m_old)


def _uniforms(generator: Optional[torch.Generator],
              uniforms: Optional[torch.Tensor], t: int, shape,
              dtype, device) -> torch.Tensor:
    """Sweep t's uniforms: injected slice, or a fresh draw from `generator`."""
    if uniforms is not None:
        return uniforms[t]
    if generator is None:
        raise ValueError("pass a torch.Generator or injected uniforms")
    return torch.rand(shape, generator=generator, dtype=dtype, device=device)


def run_sweeps(
    J_rows,        # [nB, B, n_pad]
    J_diag,        # [nB, B, B] (read by 'sequential' only)
    h,             # [n_pad]
    m0,            # [R, n_pad] in {-1, +1}
    phi0,          # [R, n_pad] cached local fields for m0
    generator,     # torch.Generator on m0's device, or None with `uniforms`
    beta_sweep,    # [T] per-sweep inverse temperature (anneal ramps live here)
    beta_spin,     # broadcastable to [R, n_pad]; multiplies beta_sweep (heating)
    update_mask,   # broadcastable to [R, n_pad] bool; False = frozen / padding
    *,
    num_sweeps: int,
    within_block: str = "sequential",
    block_order: str = "fixed",
    record_m: bool = False,
    uniforms: Optional[torch.Tensor] = None,   # [T, R, n_pad] injected draws
    block_orders: Optional[torch.Tensor] = None,  # [T, nB] injected orders
) -> SweepResult:
    """Run `num_sweeps` Gibbs sweeps for a batch of replicas."""
    if within_block not in ("jacobi", "sequential"):
        raise ValueError(f"unknown within_block={within_block!r}")
    if block_order not in ("fixed", "random"):
        raise ValueError(f"unknown block_order={block_order!r}")
    nB, B, n_pad = J_rows.shape
    R = m0.shape[0]
    dtype, device = m0.dtype, m0.device
    if uniforms is not None and tuple(uniforms.shape) != (num_sweeps, R, n_pad):
        raise ValueError(f"uniforms must be [{num_sweeps}, {R}, {n_pad}], "
                         f"got {tuple(uniforms.shape)}")
    if block_orders is not None:
        block_orders = torch.as_tensor(block_orders).tolist()
        if (len(block_orders) != num_sweeps
                or any(sorted(o) != list(range(nB)) for o in block_orders)):
            raise ValueError(f"block_orders must hold {num_sweeps} "
                             f"permutations of {nB} blocks")

    beta_sweep = torch.as_tensor(beta_sweep, dtype=dtype,
                                 device=device).expand(num_sweeps)
    beta_spin = torch.as_tensor(beta_spin, dtype=dtype,
                                device=device).expand(R, n_pad)
    update_mask = torch.as_tensor(update_mask, device=device).expand(R, n_pad)
    h = h.to(dtype)

    m = m0.clone()
    phi = phi0.clone()
    m_best = m0.clone()
    # best-so-far covers SWEPT states only, like the reference's argmin over
    # a phase's sweep history
    e_best = torch.full((R,), float("inf"), dtype=dtype, device=device)
    energies = torch.empty((num_sweeps, R), dtype=dtype, device=device)
    M = (torch.empty((num_sweeps, R, n_pad), dtype=dtype, device=device)
         if record_m else None)

    for t in range(num_sweeps):
        u = _uniforms(generator, uniforms, t, (R, n_pad), dtype, device)
        beta_t = beta_sweep[t]
        for b in _block_order(block_order, block_orders, generator, t, nB):
            s = b * B
            xb = phi[:, s:s + B]
            mb = m[:, s:s + B]
            ub = u[:, s:s + B]
            betab = beta_t * beta_spin[:, s:s + B]
            maskb = update_mask[:, s:s + B]
            if within_block == "jacobi":
                mb_new = heat_bath_update(xb, betab, ub, mb, maskb)
            else:
                Jbb = J_diag[b]
                mb_new = mb.clone()
                corr = torch.zeros_like(xb)
                for i in range(B):
                    old_i = mb_new[:, i:i + 1]
                    new_i = heat_bath_update(
                        xb[:, i:i + 1] + corr[:, i:i + 1], betab[:, i:i + 1],
                        ub[:, i:i + 1], old_i, maskb[:, i:i + 1])
                    corr = corr + (new_i - old_i) * Jbb[i:i + 1, :]
                    mb_new[:, i:i + 1] = new_i
            dm = mb_new - mb
            phi = phi + torch.matmul(dm, J_rows[b])
            m[:, s:s + B] = mb_new

        e = energy_from_fields(h, m, phi)
        better = e < e_best
        m_best = torch.where(better[:, None], m, m_best)
        e_best = torch.where(better, e, e_best)
        energies[t] = e
        if record_m:
            M[t] = m
    return SweepResult(m=m, phi=phi, m_best=m_best, e_best=e_best,
                       energies=energies, M=M)


def _block_order(block_order, block_orders, generator, t, nB):
    """Sweep t's block order: index order, an injected order, or a fresh
    permutation from `generator`."""
    if block_order == "fixed":
        return range(nB)
    if block_orders is not None:
        return block_orders[t]
    if generator is None:
        raise ValueError("block_order='random' needs a torch.Generator or "
                         "injected block_orders")
    return torch.randperm(nB, generator=generator,
                          device=generator.device).tolist()


def anneal_schedule(num_sweeps: int, beta: float, initial_beta: float,
                    sweeps_per_beta: int, dtype=torch.float32,
                    device=None) -> torch.Tensor:
    """Per-sweep beta ramp, matching the reference's annealing loop.

    The reference builds beta_vals = linspace(initial_beta, beta,
    num_sweeps // sweeps_per_beta) and advances its index BEFORE using it on
    sweep 0, so beta_vals[0] (= initial_beta) is never used when
    num_betas > 1, and the final level is held for the remaining sweeps.
    """
    num_betas = max(num_sweeps // sweeps_per_beta, 1)
    beta_vals = torch.linspace(initial_beta, beta, num_betas, dtype=dtype,
                               device=device)
    # index used on sweep jj: idx(jj) = min(jj // sweeps_per_beta + 1, num_betas - 1)
    jj = torch.arange(num_sweeps, device=device)
    idx = torch.clamp(jj // sweeps_per_beta + 1, max=num_betas - 1)
    return beta_vals[idx]
