"""Device and dtype policy of the port.

Entry points run on the first CUDA card unless the caller names another
device: `default_device()` raises when there is no card and never picks
the CPU. On CUDA everything runs in float32 (the dtype the kernels take);
on the CPU, which only a caller that names it gets, float64 is allowed
too, which the parity tests use.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

# The JAX package runs every f32 product at Precision.HIGHEST so that the
# sampled couplings are exactly the loaded J (nmc_tpu/ops/sweeps_pallas.py
# `_prec`). TF32 keeps ~10 mantissa bits and would perturb J by up to 0.1%,
# so keep both matmul and cuDNN in full f32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def default_device() -> torch.device:
    """The first CUDA card; raises when torch sees none (the CPU is used
    only when a caller names it)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: torch.cuda.is_available() is false. The port "
            "runs on a CUDA card by default; pass device='cpu' (or "
            "--device cpu on the command line) to run on the CPU")
    return torch.device("cuda")


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    return default_device() if device is None else torch.device(device)


def resolve_dtype(dtype, device: torch.device) -> torch.dtype:
    """Map "float32"/"float64"/torch dtypes to a torch dtype allowed on
    `device`: float32 anywhere, float64 on the CPU only."""
    if isinstance(dtype, str):
        if dtype not in _DTYPES:
            raise ValueError(f"unsupported dtype {dtype!r}")
        dtype = _DTYPES[dtype]
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype}")
    if device.type != "cpu" and dtype != torch.float32:
        raise ValueError(f"{device.type} runs float32 only, got {dtype}")
    return dtype
