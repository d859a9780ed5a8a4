"""Reference of the instance-ensemble NMC / PT engine (one card).

A round, for the family's instances at once: every `lbp_every` rounds the
backbone masks of the slots holding an NMC label (LBP clamped at each
such slot's state, at the global beta), the NMC flags frozen with them;
the whole-round sweeps (`sweeps.round_sweeps`) at each slot's beta, the
global beta on NMC slots; the fold of each instance's lowest slot best
into its best-ever (strict <); one label-swap round on the carried
energies. State is held in the blocked layout, as the program holds it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import draws, lbp, layout, sweeps, swaps
from .precision import Precision


class Reference:
    def __init__(self, inputs, device, rank=0, world=1):
        cfg, tr = inputs.config, inputs.traffic
        self.device = device
        self.cfg, self.tr = cfg, tr
        self.lay = layout.family_layout(inputs.J, cfg["block_size"],
                                        cfg["use_coloring"])
        Jb, hb = layout.to_blocked(inputs.J, inputs.h, self.lay)
        if not np.array_equal(Jb, np.round(Jb)):
            raise ValueError("the round reference is exact on integer "
                             "couplings only")
        self.ranges = sweeps.steps(Jb, cfg["block_size"])
        self.I, self.n_pad = Jb.shape[0], self.lay.n_pad
        self.R = inputs.beta.shape[0]
        self.J = torch.as_tensor(Jb, device=device)
        self.h = torch.as_tensor(hb, device=device)
        self.act = torch.as_tensor(self.lay.active, device=device)
        self.beta = torch.as_tensor(inputs.beta, dtype=torch.float32,
                                    device=device)
        self.nmc_by_beta = torch.as_tensor(inputs.do_nmc, device=device)
        self.k = int(inputs.do_nmc.sum())
        self.phases = sweeps.phase_list(cfg["num_cycles"],
                                        cfg["full_update_frequency"])
        self.heat = sweeps.heated_factor(cfg["temp_x"])
        if self.k:
            nbr, rev = lbp.neighbour_slots(np.any(Jb != 0, axis=0))
            w = np.where(nbr[None] >= 0,
                         np.take_along_axis(
                             Jb, np.maximum(nbr, 0)[None].repeat(self.I, 0),
                             axis=2), 0.0).astype(np.float32)
            self.nbr, self.rev = nbr, rev
            self.w = torch.as_tensor(w, device=device)
            self.eps = torch.as_tensor(
                np.abs(hb) + np.abs(Jb).sum(-1), device=device)
            self.ladder = lbp.lambda_ladder(cfg["lambda_start"],
                                            cfg["lambda_end"],
                                            cfg["lambda_reduction_factor"])

    # ------------------------------------------------------------------
    def initial(self, gen_state):
        g = draws.generator_at(gen_state, self.device)
        u = torch.rand((self.I, self.R, self.n_pad), generator=g,
                       device=self.device)
        m = torch.where(u < 0.5, -1.0, 1.0)
        m = torch.where(self.act, m, 1.0)
        ids = torch.arange(self.R, device=self.device).expand(self.I, self.R)
        return dict(m=m, beta_to_slot=ids.clone(), slot_to_beta=ids.clone(),
                    m_best=torch.ones((self.I, self.n_pad), device=self.device),
                    e_best=torch.full((self.I,), float("inf"),
                                      device=self.device),
                    cl=torch.zeros_like(m, dtype=torch.bool),
                    do_nmc=self.nmc_by_beta.expand(self.I, self.R).clone(),
                    round_index=0)

    def masks(self, m, slot_to_beta, prec=Precision()):
        """(backbone masks [I, R, n_pad], NMC flags [I, R]); the beliefs
        in `prec`'s floating type."""
        cfg = self.cfg
        I, R, n = m.shape
        dn = self.nmc_by_beta[slot_to_beta]
        slots = torch.argsort(dn.to(torch.int8), dim=1, stable=True)[:, R - self.k:]
        idx = slots[..., None].expand(I, self.k, n)
        m_star = torch.gather(m, 1, idx).reshape(I * self.k, n)
        inst = torch.arange(I, device=self.device).repeat_interleave(self.k)
        logits = lbp.beliefs(
            self.nbr, self.rev, prec(self.w[inst]), prec(self.h[inst]),
            prec(self.eps[inst]), prec(m_star),
            beta=self.tr["global_beta"], ladder=self.ladder,
            max_iterations=cfg["lbp_max_iterations"],
            tolerance=cfg["lbp_tolerance"])
        cl_k = lbp.backbone_mask(
            logits.float().reshape(I, self.k, n), torch.abs(self.J), self.act,
            cfg["threshold_initial"], cfg["threshold_cutoff"],
            cfg["threshold_step"])
        cl = torch.zeros((I, R, n), dtype=torch.bool, device=self.device)
        cl.scatter_(1, idx, cl_k)
        return cl & self.act, dn

    def _uniforms(self, g):
        T = self.cfg["sweeps_per_phase"]
        if self.device.type == "cuda":
            dev = self.device
            return draws.PhaseUniforms(
                draws.seed_words(g), self.n_pad,
                torch.arange(self.R, device=dev), torch.arange(self.I, device=dev),
                T)
        shape = (self.I, self.R, self.n_pad)
        return lambda p, t: torch.rand(shape, generator=g, device=self.device)

    def replay(self, state, gen_state, rounds, prec=Precision()):
        """The states after each of `rounds` rounds from `state` (a dict as
        `initial` returns), drawing from a generator at `gen_state`."""
        cfg = self.cfg
        g = draws.generator_at(gen_state, self.device)
        out = []
        for _ in range(rounds):
            refresh = bool(self.k) and (
                state["round_index"] % self.tr["lbp_every"] == 0)
            if refresh:
                cl, dn = self.masks(state["m"], state["slot_to_beta"], prec)
            else:
                cl, dn = state["cl"], state["do_nmc"]
            base = torch.where(dn, self.tr["global_beta"],
                               self.beta[state["slot_to_beta"]]).float()
            m, mb, eb, ecar = sweeps.round_sweeps(
                prec, self.J, self.h, self.act, state["m"], cl, dn, base,
                self._uniforms(g), phases=self.phases,
                T=cfg["sweeps_per_phase"], heat=self.heat, ranges=self.ranges)
            r = torch.argmin(eb, dim=1, keepdim=True)
            e_r = torch.gather(eb, 1, r)[:, 0]
            m_r = torch.gather(mb, 1, r[..., None].expand(-1, 1, self.n_pad))[:, 0]
            imp = e_r < state["e_best"]
            gum, su = swaps.swap_draws(g, self.I, cfg["num_swapping_pairs"],
                                       self.R)
            b2s, s2b = swaps.label_swap(state["beta_to_slot"], self.beta, ecar,
                                        gum, su)
            state = dict(m=m, beta_to_slot=b2s, slot_to_beta=s2b,
                         m_best=torch.where(imp[:, None], m_r, state["m_best"]),
                         e_best=torch.where(imp, e_r, state["e_best"]),
                         cl=cl, do_nmc=dn, refreshed=refresh,
                         round_index=state["round_index"] + 1)
            out.append(state)
        return out

    def original_order(self, m):
        return m[..., torch.as_tensor(self.lay.inv_perm, device=m.device)]
