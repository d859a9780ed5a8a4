"""Reference of the instance-ensemble parallel tempering engine (one card).

A round, per instance: fresh local fields phi = m J + h; T sequential
sweeps at each slot's beta (`sweeps.sequential_sweeps`); one label-swap
round on the last sweep's energies; the fold of the instance's lowest slot
best into its best-ever (strict <). The layout is uncoloured: all spins in
order, padded to whole blocks.
"""

from __future__ import annotations

import torch

from . import draws, layout, sweeps, swaps
from .precision import Precision


class Reference:
    def __init__(self, inputs, device, rank=0, world=1):
        cfg = inputs.config
        self.device, self.cfg = device, cfg
        self.lay = layout.family_layout(inputs.J, cfg["block_size"], False)
        Jb, hb = layout.to_blocked(inputs.J, inputs.h, self.lay)
        self.I, self.n_pad = Jb.shape[0], self.lay.n_pad
        self.R = inputs.beta.shape[0]
        self.J = torch.as_tensor(Jb, device=device)
        self.h = torch.as_tensor(hb, device=device)
        self.act = torch.as_tensor(self.lay.active, device=device)
        self.beta = torch.as_tensor(inputs.beta, dtype=torch.float32,
                                    device=device)

    def initial(self, gen_state):
        g = draws.generator_at(gen_state, self.device)
        u = torch.rand((self.I, self.R, self.n_pad), generator=g,
                       device=self.device)
        m = torch.where(self.act, torch.where(u < 0.5, -1.0, 1.0), 1.0)
        ids = torch.arange(self.R, device=self.device).expand(self.I, self.R)
        return dict(m=m, beta_to_slot=ids.clone(), slot_to_beta=ids.clone(),
                    m_best=torch.ones((self.I, self.n_pad), device=self.device),
                    e_best=torch.full((self.I,), float("inf"),
                                      device=self.device),
                    round_index=0)

    def _uniforms(self, g):
        T, shape = self.cfg["sweeps_per_round"], (self.R, self.n_pad)
        dev = self.device
        if dev.type == "cuda":
            seeds = draws.seed_words(g, (self.I, 1))[:, 0]
            reps = torch.arange(self.R, device=dev)
            zero = torch.zeros(self.I, dtype=torch.int64, device=dev)
            return lambda t: draws.kernel_uniforms(
                seeds, self.n_pad, reps,
                torch.tensor([t], device=dev), zero)[0]
        # the plain version draws instance after instance, sweep after sweep
        u = torch.stack([torch.stack([torch.rand(shape, generator=g)
                                      for _ in range(T)])
                         for _ in range(self.I)], dim=1)
        return lambda t: u[t]

    def replay(self, state, gen_state, rounds, prec=Precision()):
        cfg = self.cfg
        g = draws.generator_at(gen_state, self.device)
        out = []
        for _ in range(rounds):
            beta_slot = self.beta[state["slot_to_beta"]]
            draw = self._uniforms(g)
            phi = prec.mm(prec(state["m"]), prec(self.J)) + prec(self.h)[:, None, :]
            m, mb, eb, energies = sweeps.sequential_sweeps(
                prec, self.J, self.h, self.lay.active, state["m"], phi,
                beta_slot, draw, T=cfg["sweeps_per_round"],
                B=cfg["block_size"])
            gum, su = swaps.swap_draws(g, self.I, cfg["num_swapping_pairs"],
                                       self.R)
            b2s, s2b = swaps.label_swap(state["beta_to_slot"], self.beta,
                                        energies[:, -1], gum, su)
            r = torch.argmin(eb, dim=1, keepdim=True)
            e_r = torch.gather(eb, 1, r)[:, 0]
            m_r = torch.gather(mb, 1, r[..., None].expand(-1, 1, self.n_pad))[:, 0]
            imp = e_r < state["e_best"]
            state = dict(m=m, beta_to_slot=b2s, slot_to_beta=s2b,
                         m_best=torch.where(imp[:, None], m_r, state["m_best"]),
                         e_best=torch.where(imp, e_r, state["e_best"]),
                         round_index=state["round_index"] + 1)
            out.append(state)
        return out

    def original_order(self, m):
        return m[..., torch.as_tensor(self.lay.inv_perm, device=m.device)]
