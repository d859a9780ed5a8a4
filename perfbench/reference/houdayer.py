"""Houdayer's isoenergetic cluster move in plain torch, batched over pairs.

Two chains s1, s2 at one temperature disagree on the spins where s1 * s2
= -1. The disagreement components are the connected components of the
coupling graph cut down to those spins (an edge is live where the pair's
instance has a nonzero coupling). One component is chosen uniformly and
exchanged between the two chains, which leaves the pair's total energy
unchanged; with Katzgraber's modification a component of more than
`threshold` spins flips all of s1 instead.

The components come from a parallel union-find: every spin starts as its
own parent; each pass hooks, for every live edge (u, v), the parent of u's
parent onto the smaller of its own parent and v's parent (parents only
decrease and stay inside a component), then follows parent pointers until
every spin points at a root. A pass that hooks nothing leaves one root a
component, and that root is the component's smallest spin. The choice is
the root with the smallest of the pair's uniforms `g` [P, n].
"""

from __future__ import annotations

import torch


def components(src, dst, live, diff):
    """Labels [P, n] int64: each disagreeing spin the smallest spin of its
    disagreement component, every other spin n. `src`, `dst` [E] int64
    directed edges (both directions of each coupling), `live` [P, E] bool
    (the pair's instance has the coupling), `diff` [P, n] bool."""
    P, n = diff.shape
    src = src.expand(P, -1)
    dst = dst.expand(P, -1)
    on = live & diff.gather(1, src) & diff.gather(1, dst)
    parent = torch.arange(n, device=diff.device).expand(P, n).clone()
    while True:
        pu = parent.gather(1, src)
        pv = torch.where(on, parent.gather(1, dst), n)
        hooked = parent.scatter_reduce(1, pu, pv, reduce="amin",
                                       include_self=True)
        while True:
            up = hooked.gather(1, hooked)
            if torch.equal(up, hooked):
                break
            hooked = up
        if torch.equal(hooked, parent):
            break
        parent = hooked
    return torch.where(diff, parent, n)


def move(labels, s1, s2, g, threshold: int):
    """(s1', s2') [P, n] after one move per pair from its component labels:
    the component whose root has the smallest uniform in `g` is exchanged
    between s1 and s2, or, past `threshold` spins, s1 is flipped whole; a
    pair that agrees everywhere is left as it is."""
    n = labels.shape[1]
    roots = labels == torch.arange(n, device=labels.device)
    any_root = roots.any(dim=1, keepdim=True)
    pick = torch.where(roots, g, float("inf")).argmin(dim=1, keepdim=True)
    member = (labels == pick) & any_root
    flip = member.sum(dim=1, keepdim=True) > threshold
    swap = member & ~flip
    return (torch.where(flip, -s1, torch.where(swap, s2, s1)),
            torch.where(swap, s1, s2))
