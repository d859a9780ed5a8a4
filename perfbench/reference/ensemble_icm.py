"""Reference of the instance-ensemble APT+ICM engine (one card): the
campaign's icm arm.

Every (instance, sub-replica, temperature label) chain is one slot of
[I, S, R]. A round, for the family's instances at once, drawing in this
order from one generator:
  (a) the whole-round sweeps (`sweeps.round_sweeps`) over the [I, S * R]
      slots at each slot's label temperature, with empty backbone masks
      and no NMC flags: phases C, NC and ALL of sweeps_per_round / 3
      sweeps each; on a card the kernels' Philox draws over slot ids
      0 .. S * R - 1 (`draws.PhaseUniforms`), on the CPU one torch.rand a
      sweep;
  (b) the fold of each instance's lowest slot best into its best
      (strict <);
  (c) per instance one pairing of the sub-replicas, argsort(rand(I, S)):
      pairs (perm[0], perm[1]), (perm[2], perm[3]), ...; for each pair and
      each temperature the two chains that hold it;
  (d) the cluster uniforms rand(I * (S // 2) * R, n_pad);
  (e) the disagreement components of every pair (`houdayer.components`);
  (f) one move a pair (`houdayer.move`): the chosen component exchanged,
      or the first chain flipped past n_pad // 2 spins (Katzgraber);
      padded spins re-pinned to +1;
  (g) the energies of the states after the moves, and the fold of each
      instance's lowest into its best (strict <);
  (h) one label-swap round on each of the I * S sub-replica ladders
      (`swaps.swap_draws`, `swaps.label_swap`) on those energies.
State is held in the blocked layout, as the program holds it.

Departures from the reference implementation's `NPT/apt_ICM.py`
(APT_ICM.run):
  * the moves are carried on: the next round sweeps the moved chains; the
    reference writes its moves only into its record M and restarts the
    next round from the unmoved chains;
  * a move acts on each chain's state at the end of the round's sweeps;
    the reference moves the first sweep's state of each chain;
  * the sweeps are colour-class heat-bath sweeps, three phases of
    sweeps_per_round / 3 (what the program's whole-round kernel runs);
    the reference runs random-scan single-spin Gibbs sweeps;
  * the component is chosen by the smallest uniform over the components'
    roots (uniform over components), the components found by union-find;
    the reference finds them by breadth-first search and draws one;
  * Katzgraber's threshold is half the padded spin count, which on the
    cell's Chimera C16 layout is half of N, as in the reference;
  * the swaps draw `num_swapping_pairs` non-overlapping adjacent pairs a
    ladder by Gumbel argmax (the program's rule, as in NPT);
  * the best is folded from every sweep's end and from the states after
    the moves.
"""

from __future__ import annotations

import numpy as np
import torch

from . import draws, houdayer, layout, sweeps, swaps
from .precision import Precision


class Reference:
    def __init__(self, inputs, device, rank=0, world=1):
        cfg = inputs.config
        self.device = device
        self.cfg = cfg
        self.lay = layout.family_layout(inputs.J, cfg["block_size"],
                                        cfg["use_coloring"])
        Jb, hb = layout.to_blocked(inputs.J, inputs.h, self.lay)
        if not np.array_equal(Jb, np.round(Jb)):
            raise ValueError("the round reference is exact on integer "
                             "couplings only")
        self.ranges = sweeps.steps(Jb, cfg["block_size"])
        self.I, self.n_pad = Jb.shape[0], self.lay.n_pad
        self.R = inputs.beta.shape[0]
        self.S = cfg["subreplicas"]
        self.T = cfg["sweeps_per_round"] // 3
        self.J = torch.as_tensor(Jb, device=device)
        self.h = torch.as_tensor(hb, device=device)
        self.act = torch.as_tensor(self.lay.active, device=device)
        self.beta = torch.as_tensor(inputs.beta, dtype=torch.float32,
                                    device=device)
        u, v = np.nonzero(np.any(Jb != 0, axis=0))
        self.src = torch.as_tensor(u, device=device)
        self.dst = torch.as_tensor(v, device=device)
        self.live = torch.as_tensor(Jb[:, u, v] != 0, device=device)
        self.threshold = (self.n_pad // 2 if cfg["use_katzgraber"]
                          else self.n_pad)

    # ------------------------------------------------------------------
    def initial(self, gen_state):
        g = draws.generator_at(gen_state, self.device)
        I, S, R, n = self.I, self.S, self.R, self.n_pad
        u = torch.rand((I, S, R, n), generator=g, device=self.device)
        m = torch.where(u < 0.5, -1.0, 1.0)
        m = torch.where(self.act, m, 1.0)
        ids = torch.arange(R, device=self.device).expand(I, S, R)
        return dict(m=m, beta_to_slot=ids.clone(), slot_to_beta=ids.clone(),
                    m_best=torch.ones((I, n), device=self.device),
                    e_best=torch.full((I,), float("inf"), device=self.device),
                    round_index=0)

    def _uniforms(self, g):
        slots = self.S * self.R
        if self.device.type == "cuda":
            dev = self.device
            return draws.PhaseUniforms(
                draws.seed_words(g), self.n_pad,
                torch.arange(slots, device=dev),
                torch.arange(self.I, device=dev), self.T)
        shape = (self.I, slots, self.n_pad)
        return lambda p, t: torch.rand(shape, generator=g, device=self.device)

    @staticmethod
    def _fold(m, e, m_best, e_best):
        """Each instance's lowest of m [I, C, n] with energies e [I, C]
        into its best, where strictly lower."""
        r = torch.argmin(e, dim=1, keepdim=True)
        e_r = torch.gather(e, 1, r)[:, 0]
        m_r = torch.gather(m, 1, r[..., None].expand(-1, 1, m.shape[-1]))[:, 0]
        imp = e_r < e_best
        return (torch.where(imp[:, None], m_r, m_best),
                torch.where(imp, e_r, e_best))

    def _moves(self, m, b2s, g):
        """m [I, S, R, n] after the Houdayer moves of one pairing of the
        sub-replicas per instance, drawn from `g`."""
        I, S, R, n = m.shape
        half = S // 2
        if half == 0:
            return m
        dev = self.device
        perm = torch.argsort(torch.rand((I, S), generator=g, device=dev),
                             dim=1)
        inst = torch.arange(I, device=dev)[:, None, None]
        temp = torch.arange(R, device=dev)[None, None, :]
        sub_a = perm[:, 0:2 * half:2, None]                 # [I, half, 1]
        sub_b = perm[:, 1:2 * half:2, None]
        slot_a = b2s[inst, sub_a, temp]                     # [I, half, R]
        slot_b = b2s[inst, sub_b, temp]
        s1 = m[inst, sub_a, slot_a].reshape(-1, n)
        s2 = m[inst, sub_b, slot_b].reshape(-1, n)
        u = torch.rand((I * half * R, n), generator=g, device=dev)
        pair_inst = torch.arange(I, device=dev).repeat_interleave(half * R)
        labels = houdayer.components(self.src, self.dst,
                                     self.live[pair_inst], s1 * s2 < 0)
        s1, s2 = houdayer.move(labels, s1, s2, u, self.threshold)
        m = m.clone()
        m[inst, sub_a, slot_a] = s1.reshape(I, half, R, n)
        m[inst, sub_b, slot_b] = s2.reshape(I, half, R, n)
        return torch.where(self.act, m, 1.0)

    def _energies(self, prec, flat):
        """E = -(m J m / 2 + h m) of flat [I, C, n] in `prec`, as float32."""
        x = prec(flat)
        Jm = prec.mm(x, prec(self.J)).to(prec.dtype)
        return -(0.5 * torch.sum(x * Jm, dim=-1)
                 + torch.sum(x * prec(self.h)[:, None, :], dim=-1)).float()

    def replay(self, state, gen_state, rounds, prec=Precision()):
        """The states after each of `rounds` rounds from `state` (a dict as
        `initial` returns), drawing from a generator at `gen_state`."""
        g = draws.generator_at(gen_state, self.device)
        I, S, R, n = self.I, self.S, self.R, self.n_pad
        none = torch.zeros((I, S * R), dtype=torch.bool, device=self.device)
        out = []
        for _ in range(rounds):
            base = self.beta[state["slot_to_beta"]].reshape(I, S * R)
            m, mb, eb, _ = sweeps.round_sweeps(
                prec, self.J, self.h, self.act,
                state["m"].reshape(I, S * R, n),
                none[..., None].expand(I, S * R, n), none, base,
                self._uniforms(g), phases=sweeps.phase_list(1, 1), T=self.T,
                heat=1.0, ranges=self.ranges)
            m_best, e_best = self._fold(mb, eb, state["m_best"],
                                        state["e_best"])
            m = self._moves(m.reshape(I, S, R, n), state["beta_to_slot"], g)
            flat = m.reshape(I, S * R, n)
            e = self._energies(prec, flat)
            m_best, e_best = self._fold(flat, e, m_best, e_best)
            gum, su = swaps.swap_draws(g, I * S, self.cfg["num_swapping_pairs"],
                                       R)
            b2s, s2b = swaps.label_swap(state["beta_to_slot"].reshape(I * S, R),
                                        self.beta, e.reshape(I * S, R), gum, su)
            state = dict(m=m, beta_to_slot=b2s.reshape(I, S, R),
                         slot_to_beta=s2b.reshape(I, S, R), m_best=m_best,
                         e_best=e_best, round_index=state["round_index"] + 1)
            out.append(state)
        return out

    def original_order(self, m):
        return m[..., torch.as_tensor(self.lay.inv_perm, device=m.device)]
