"""Colored-block Gibbs sweeps: the CUDA kernel's wrapper and its plain twin.

`colored_sweeps` is the counterpart of
``nmc_tpu/ops/sweeps_pallas.py::pallas_colored_sweeps`` (K1): T sweeps of
block-Jacobi heat-bath Gibbs on a graph-coloured layout, with the replica
state kept on chip for the whole launch (csrc/colored_sweeps.cu). It takes
the same arrays and returns the same outputs; a `torch.Generator` stands in
for the seed, and optional injected uniforms [T, R, n_pad] replace the
kernel's Philox draws.

On a CPU tensor the wrapper runs `colored_sweeps_reference`, the same
function in plain torch, and launches nothing. On a CUDA tensor it launches
the kernel or raises. `colored_sweeps.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ._build import load_library
from .sweeps import run_sweeps

_LIB = "colored_sweeps"


class ColoredSweepResult(NamedTuple):
    m: torch.Tensor         # [R, n_pad]
    phi: torch.Tensor       # [R, n_pad]
    m_best: torch.Tensor    # [R, n_pad]
    e_best: torch.Tensor    # [R]
    energies: torch.Tensor  # [T, R]


def colored_sweeps_reference(
    J, h, m0, phi0, generator, beta_sweep, beta_spin, update_mask, *,
    num_sweeps: int, block_size: int = 128,
    uniforms: Optional[torch.Tensor] = None,
) -> ColoredSweepResult:
    """Plain-torch colored sweeps: the block-Jacobi engine on J's row blocks."""
    n_pad = J.shape[0]
    if n_pad % block_size:
        raise ValueError("n_pad must be a multiple of block_size")
    res = run_sweeps(
        J.reshape(n_pad // block_size, block_size, n_pad), None, h, m0, phi0,
        generator, beta_sweep, beta_spin, update_mask, num_sweeps=num_sweeps,
        within_block="jacobi", uniforms=uniforms)
    return ColoredSweepResult(m=res.m, phi=res.phi, m_best=res.m_best,
                              e_best=res.e_best, energies=res.energies)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    if not getattr(lib, "_nmc_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.colored_sweeps_f32.argtypes = [p] * 14 + [i] * 4 + [p]
        lib.colored_sweeps_f32.restype = i
        lib._nmc_bound = True
    return lib


def _check(name, x, shape, dtype, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _broadcast(name, x, shape, dtype, device):
    """Materialise a broadcastable argument (0-d, [R, 1], expand views)."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    else:
        x = torch.as_tensor(x, dtype=dtype, device=device)
    return x.expand(shape).contiguous()


def colored_sweeps(
    J,            # [n_pad, n_pad] float32, colored layout (zero diagonal blocks)
    h,            # [n_pad]
    m0,           # [R, n_pad] in {-1, +1}
    phi0,         # [R, n_pad]
    generator,    # torch.Generator the seed is drawn from (None with uniforms)
    beta_sweep,   # [T] or scalar
    beta_spin,    # broadcastable to [R, n_pad]
    update_mask,  # broadcastable to [R, n_pad] bool
    *,
    num_sweeps: int,
    block_size: int = 128,
    uniforms: Optional[torch.Tensor] = None,   # [T, R, n_pad] injected draws
) -> ColoredSweepResult:
    """T colored heat-bath sweeps; the CUDA kernel on CUDA tensors, the plain
    torch version on CPU tensors."""
    if m0.device.type == "cpu":
        return colored_sweeps_reference(
            J, h, m0, phi0, generator, beta_sweep, beta_spin, update_mask,
            num_sweeps=num_sweeps, block_size=block_size, uniforms=uniforms)
    if m0.device.type != "cuda":
        raise ValueError(f"colored_sweeps runs on cuda or cpu, not {m0.device}")

    device = m0.device
    f32 = torch.float32
    n_pad = J.shape[0]
    R = m0.shape[0]
    if n_pad % block_size:
        raise ValueError("n_pad must be a multiple of block_size")
    _check("J", J, (n_pad, n_pad), f32, device)
    _check("h", h, (n_pad,), f32, device)
    _check("m0", m0, (R, n_pad), f32, device)
    _check("phi0", phi0, (R, n_pad), f32, device)
    beta_sweep = _broadcast("beta_sweep", beta_sweep, (num_sweeps,), f32, device)
    beta_spin = _broadcast("beta_spin", beta_spin, (R, n_pad), f32, device)
    mask = _broadcast("update_mask", update_mask, (R, n_pad), torch.bool, device)
    if uniforms is not None:
        _check("uniforms", uniforms, (num_sweeps, R, n_pad), f32, device)
        seed = None
    elif generator is None:
        raise ValueError("pass a torch.Generator or injected uniforms")
    else:
        # drawn where the generator lives and read by the kernel from device
        # memory: no host sync before the launch
        seed = torch.randint(0, 2 ** 31 - 1, (2,), generator=generator,
                             dtype=torch.int32, device=generator.device)
        seed = seed.to(device, non_blocking=True)

    lib = _bind(load_library(_LIB))

    m = torch.empty_like(m0)
    phi = torch.empty_like(phi0)
    m_best = torch.empty_like(m0)
    e_best = torch.empty((R,), dtype=f32, device=device)
    energies = torch.empty((num_sweeps, R), dtype=f32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.colored_sweeps_f32(
        J.data_ptr(), h.data_ptr(), m0.data_ptr(), phi0.data_ptr(),
        beta_spin.data_ptr(), mask.data_ptr(), beta_sweep.data_ptr(),
        uniforms.data_ptr() if uniforms is not None else None,
        seed.data_ptr() if seed is not None else None,
        m.data_ptr(), phi.data_ptr(), m_best.data_ptr(), e_best.data_ptr(),
        energies.data_ptr(), R, n_pad, block_size, num_sweeps, stream)
    if err != 0:
        raise RuntimeError(f"colored_sweeps kernel launch failed: "
                           f"cudaError {err}")
    colored_sweeps.launches += 1
    return ColoredSweepResult(m=m, phi=phi, m_best=m_best, e_best=e_best,
                              energies=energies)


colored_sweeps.launches = 0
