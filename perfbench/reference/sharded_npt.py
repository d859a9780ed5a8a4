"""Reference of replica-sharded parallel tempering over ranks.

One instance; the ladder's R chain slots are split over W ranks, rank k
holding slots [k R / W, (k + 1) R / W). A round without NMC labels: the
whole-round sweeps of the rank's slots (`sweeps.round_sweeps`, their draws
keyed by the global slot index), each slot's best-ever folded in (strict
<), the R carried energies gathered from every rank, and one label-swap
round that every rank computes alike. The gather here is torch.distributed's
own all_gather; at world 1 there is none.
"""

from __future__ import annotations

import numpy as np
import torch

from . import draws, layout, sweeps, swaps
from .precision import Precision


class Reference:
    def __init__(self, inputs, device, rank=0, world=1):
        cfg, tr = inputs.config, inputs.traffic
        if inputs.do_nmc.any():
            raise ValueError("this reference follows rounds without NMC labels")
        self.device, self.cfg = device, cfg
        self.lay = layout.family_layout(inputs.J, cfg["block_size"],
                                        cfg["use_coloring"])
        Jb, hb = layout.to_blocked(inputs.J, inputs.h, self.lay)
        if not np.array_equal(Jb, np.round(Jb)):
            raise ValueError("the round reference is exact on integer "
                             "couplings only")
        self.ranges = sweeps.steps(Jb, cfg["block_size"])
        self.n_pad = self.lay.n_pad
        self.R = inputs.beta.shape[0]
        self.world, self.Rl = world, self.R // world
        self.r0 = rank * self.Rl
        self.J = torch.as_tensor(Jb, device=device)          # [1, n_pad, n_pad]
        self.h = torch.as_tensor(hb, device=device)
        self.act = torch.as_tensor(self.lay.active, device=device)
        self.beta = torch.as_tensor(inputs.beta, dtype=torch.float32,
                                    device=device)
        self.phases = sweeps.phase_list(cfg["num_cycles"],
                                        cfg["full_update_frequency"])
        self.heat = sweeps.heated_factor(cfg["temp_x"])

    def _rows(self, x):
        return x[self.r0:self.r0 + self.Rl]

    def initial(self, gen_state):
        g = draws.generator_at(gen_state, self.device)
        u = torch.rand((self.R, self.n_pad), generator=g, device=self.device)
        m = self._rows(torch.where(self.act, torch.where(u < 0.5, -1.0, 1.0),
                                   1.0))
        ids = torch.arange(self.R, device=self.device)
        return dict(m=m, beta_to_slot=ids, slot_to_beta=ids.clone(),
                    m_best=m.clone(),
                    e_best=torch.full((self.Rl,), float("inf"),
                                      device=self.device),
                    round_index=0)

    def _uniforms(self, g):
        T = self.cfg["sweeps_per_phase"]
        dev = self.device
        if dev.type == "cuda":
            return draws.PhaseUniforms(
                draws.seed_words(g), self.n_pad,
                torch.arange(self.r0, self.r0 + self.Rl, device=dev),
                torch.zeros(1, dtype=torch.int64, device=dev), T)
        shape = (1, self.R, self.n_pad)
        return lambda p, t: torch.rand(shape, generator=g, device=dev)[
            :, self.r0:self.r0 + self.Rl]

    def _gather(self, e):
        if self.world == 1:
            return e
        import torch.distributed as dist
        parts = [torch.empty_like(e) for _ in range(self.world)]
        dist.all_gather(parts, e)
        return torch.cat(parts)

    def replay(self, state, gen_state, rounds, prec=Precision()):
        cfg = self.cfg
        g = draws.generator_at(gen_state, self.device)
        out = []
        for _ in range(rounds):
            base = self.beta[self._rows(state["slot_to_beta"])]
            cl = self.act.expand(1, self.Rl, self.n_pad)
            dn = torch.zeros((1, self.Rl), dtype=torch.bool, device=self.device)
            m, mb, eb, ecar = sweeps.round_sweeps(
                prec, self.J, self.h, self.act, state["m"][None], cl, dn,
                base[None], self._uniforms(g), phases=self.phases,
                T=cfg["sweeps_per_phase"], heat=self.heat, ranges=self.ranges)
            imp = eb[0] < state["e_best"]
            e_all = self._gather(ecar[0].contiguous())
            gum, su = swaps.swap_draws(g, 1, cfg["num_swapping_pairs"], self.R)
            b2s, s2b = swaps.label_swap(state["beta_to_slot"][None], self.beta,
                                        e_all[None], gum, su)
            state = dict(m=m[0], beta_to_slot=b2s[0], slot_to_beta=s2b[0],
                         m_best=torch.where(imp[:, None], mb[0], state["m_best"]),
                         e_best=torch.where(imp, eb[0], state["e_best"]),
                         slot_energies=e_all,
                         round_index=state["round_index"] + 1)
            out.append(state)
        return out

    def original_order(self, m):
        return m[..., torch.as_tensor(self.lay.inv_perm, device=m.device)]
