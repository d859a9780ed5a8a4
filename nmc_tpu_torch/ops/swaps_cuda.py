"""The label-swap kernel's wrapper: one launch of ``csrc/label_swaps.cu``.

Replaces no Pallas kernel: the JAX package runs the swap stage of a PT
round (``nmc_tpu/parallel/swaps.py``) as XLA ops. `label_swaps` runs the
whole stage of I ladders in one launch, one warp (one CTA) a ladder: the
sequential Gumbel-argmax pair selection, the Metropolis tests in order,
and the inverse permutation. Its plain twin is
`parallel.swaps.label_swap_reference`, which `parallel.swaps.
metropolis_label_swap` runs on CPU tensors; this wrapper takes CUDA
tensors only and raises on any other. Launches are counted in
`label_swaps.launches`.
"""

from __future__ import annotations

import torch

from ._build import bind, load_library
from .sweeps_cuda import _check, _raise_on

# the C entry point's arguments: 9 pointers (labels in, betas, energies,
# Gumbels, uniforms, labels out, inverse labels, accepted, pairs), then I,
# R, num_pairs and the labels' bytes
_SIGNATURE = "p" * 9 + "i" * 4
# the shared memory a launch may take without opting in to more
_SHARED_LIMIT = 48 * 1024


def shared_bytes(R: int, num_pairs: int) -> int:
    """The kernel's dynamic shared memory: the betas, the ladder's energies
    and labels, uniforms and picks, and R - 1 flags (padded to 4 bytes);
    csrc/label_swaps.cu: ladder_bytes."""
    return 12 * R + 8 * num_pairs + (R + 2) // 4 * 4


def label_swaps(beta_to_slot, beta_list, slot_energies, gumbels, uniforms):
    """One swap round of I ladders on the card: beta_to_slot [I, R] (int32
    or int64), beta_list [R], slot_energies [I, R], gumbels
    [I, num_pairs, R - 1] and uniforms [I, num_pairs] (float32). Returns
    (beta_to_slot, slot_to_beta, accepted [I, num_pairs] bool, pairs
    [I, num_pairs] int64); raises on what it does not take."""
    I, R = beta_to_slot.shape
    num_pairs = uniforms.shape[1]
    device = beta_to_slot.device
    if beta_to_slot.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"beta_to_slot must be int32 or int64, "
                        f"got {beta_to_slot.dtype}")
    b2s = beta_to_slot.contiguous()
    beta = beta_list.contiguous()
    energies = slot_energies.contiguous()
    _check("beta_list", beta, (R,), torch.float32, device)
    _check("slot_energies", energies, (I, R), torch.float32, device)
    _check("gumbels", gumbels, (I, num_pairs, R - 1), torch.float32, device)
    _check("uniforms", uniforms, (I, num_pairs), torch.float32, device)
    if shared_bytes(R, num_pairs) > _SHARED_LIMIT:
        raise ValueError(f"label_swaps: a ladder of {R} labels and "
                         f"{num_pairs} pairs needs more than 48 KB")
    if device.type != "cuda":
        raise ValueError(f"label_swaps runs on cuda only, not {device}")
    out_b2s, out_s2b = torch.empty_like(b2s), torch.empty_like(b2s)
    accepted = torch.empty((I, num_pairs), dtype=torch.bool, device=device)
    pairs = torch.empty((I, num_pairs), dtype=torch.int64, device=device)
    lib = bind(load_library("label_swaps"), "label_swaps", _SIGNATURE)
    err = lib.label_swaps(
        b2s.data_ptr(), beta.data_ptr(), energies.data_ptr(),
        gumbels.data_ptr(), uniforms.data_ptr(), out_b2s.data_ptr(),
        out_s2b.data_ptr(), accepted.data_ptr(), pairs.data_ptr(), I, R,
        num_pairs, b2s.element_size(),
        torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err, "label_swaps")
    label_swaps.launches += 1
    return out_b2s, out_s2b, accepted, pairs


label_swaps.launches = 0
