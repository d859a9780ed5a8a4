"""Where a round's uniforms come from, as the program states it per platform.

On a card every kernel draws its own: the launch takes two seed words,
drawn from the chains' torch.Generator as int32 in [0, 2^31 - 1), and
each spin visit is one Philox-4x32-10 word at a counter of (blocked spin
index, global replica, sweep, instance) for the whole-round kernel, or
(blocked spin index, global replica, sweep, 0) under the instance's own
seed words for the sequential kernel. On the CPU the program runs plain
versions that draw torch.rand from the generator, launch by launch in a
fixed order, which the engines' references reproduce.
"""

from __future__ import annotations

import torch

from . import philox


def generator_at(state: torch.Tensor, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


def seed_words(generator, shape=()) -> torch.Tensor:
    """int32 [*shape, 2], as the program draws a launch's seed words."""
    return torch.randint(0, 2 ** 31 - 1, tuple(shape) + (2,),
                         generator=generator, dtype=torch.int32,
                         device=generator.device)


def kernel_uniforms(seed, cols: int, replicas, sweeps, instances):
    """Uniforms [len(sweeps), I, R, cols] of the kernels' Philox draws.
    `seed` int32 [2] (one launch) or [I, 2] (per-instance keys);
    `replicas`, `sweeps`, `instances` int64 tensors of the counter words
    (global replica indices [R], sweep indices, instance words [I])."""
    dev = replicas.device
    k0, k1 = philox.seed_words(seed.to(dev))
    if k0.ndim:                       # per-instance keys
        k0, k1 = k0[None, :, None, None], k1[None, :, None, None]
    c0 = torch.arange(cols, dtype=torch.int64, device=dev)[None, None, None]
    c1 = replicas[None, None, :, None]
    c2 = sweeps[:, None, None, None]
    c3 = instances[None, :, None, None]
    return philox.uniforms(philox.word0(c0, c1, c2, c3, k0, k1))


class PhaseUniforms:
    """draw(p, t) of a whole-round launch on a card: the launch's uniforms
    for phase p, sweep t, made `chunk` sweeps at a time."""

    def __init__(self, seed, cols, replicas, instances, T, chunk=8):
        self.seed, self.cols, self.T, self.chunk = seed, cols, T, chunk
        self.replicas, self.instances = replicas, instances
        self._key, self._block = None, None

    def __call__(self, p, t):
        key = (p, t // self.chunk)
        if key != self._key:
            t0 = key[1] * self.chunk
            sweeps = p * self.T + torch.arange(
                t0, min(t0 + self.chunk, self.T), dtype=torch.int64,
                device=self.replicas.device)
            self._block = kernel_uniforms(self.seed, self.cols, self.replicas,
                                          sweeps, self.instances)
            self._key = key
        return self._block[t % self.chunk]
