"""The arithmetic a reference computes in: the configuration's own, or a
lower one for the control.

"float32": every value in float32 and every product in full float32 (TF32
off). "tf32": float32 with the inputs of each matrix product rounded to
TF32's 10 mantissa bits (round to nearest even), as the tensor cores take
them. "bfloat16": every floating value in bfloat16; results are handed
back in float32.
"""

from __future__ import annotations

import torch

KINDS = ("float32", "tf32", "bfloat16")


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0xFFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


class Precision:
    def __init__(self, kind: str = "float32"):
        if kind not in KINDS:
            raise ValueError(f"precision must be one of {KINDS}, got {kind!r}")
        self.kind = kind
        self.dtype = torch.bfloat16 if kind == "bfloat16" else torch.float32

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x in this arithmetic's floating type."""
        return x.to(self.dtype)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.kind == "tf32":
            a, b = _round_tf32(a.float()), _round_tf32(b.float())
        return torch.matmul(a, b)


def full_float32():
    """Turn TF32 off for every product in the process, as the program does."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
