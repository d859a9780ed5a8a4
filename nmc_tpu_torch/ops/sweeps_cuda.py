"""Colored-block Gibbs sweeps: the CUDA kernels' wrappers and their plain twins.

The counterparts of the three sweep kernels of
``nmc_tpu/ops/sweeps_pallas.py``, each running T sweeps of block-Jacobi
heat-bath Gibbs on a graph-coloured layout with the replica state kept on
chip for the whole launch:

  * `colored_sweeps` (K1, ``pallas_colored_sweeps``): dense J [n_pad, n_pad],
    beta = beta_t * beta_spin, mask [R, n_pad] (csrc/colored_sweeps.cu);
  * `colored_sweeps_streamed` (K2, ``pallas_colored_sweeps_streamed``): dense
    J row blocks [nB, B, n_pad], beta = (beta_t * beta_row) * beta_spin with
    beta_spin optional, mask [1 | R, n_pad] (csrc/colored_sweeps.cu);
  * `colored_sweeps_sparse` (K3, ``pallas_colored_sweeps_sparse``): K2 over
    each row block's nonzero column tiles (col_idx [nB, K], J_tiles
    [nB, K, B, B] from `block_sparse_tiles`; csrc/colored_sweeps_sparse.cu).

They take the Pallas kernels' arrays and return the same outputs; a
`torch.Generator` stands in for the seed, and optional injected uniforms
[T, R, n_pad] replace the kernels' Philox draws.

On a CPU tensor a wrapper runs its `*_reference`, the same function in plain
torch, and launches nothing. On a CUDA tensor it launches the kernel or
raises. Each wrapper counts its kernel launches in `<wrapper>.launches`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.energy import energy_from_fields
from ._build import bind, load_library
from .sweeps import _uniforms, heat_bath_update, run_sweeps

_LIB = "colored_sweeps"
_LIB_SPARSE = "colored_sweeps_sparse"
# Dynamic shared memory one CTA may use on Hopper (227 KB).
MAX_SHARED_BYTES = 232_448


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


def _row_beta_sweeps(phi_update, num_blocks, block_size, h, m0, phi0,
                     generator, beta_sweep, beta_row, mask, beta_spin,
                     num_sweeps, uniforms) -> ColoredSweepResult:
    """The streamed kernels' sweep loop in plain torch: per block,
    beta = (beta_t * beta_row) * beta_spin in that order, then
    phi = phi_update(phi, dm, b)."""
    R, n_pad = m0.shape
    B = block_size
    dtype, device = m0.dtype, m0.device
    if uniforms is not None and tuple(uniforms.shape) != (num_sweeps, R, n_pad):
        raise ValueError(f"uniforms must be [{num_sweeps}, {R}, {n_pad}], "
                         f"got {tuple(uniforms.shape)}")
    beta_sweep = torch.as_tensor(beta_sweep, dtype=dtype,
                                 device=device).expand(num_sweeps)
    beta_row = torch.as_tensor(beta_row, dtype=dtype,
                               device=device).reshape(R, 1)
    mask = torch.as_tensor(mask, device=device)
    mask = (mask if mask.dtype == torch.bool else mask > 0).expand(R, n_pad)
    if beta_spin is not None:
        beta_spin = torch.as_tensor(beta_spin, dtype=dtype,
                                    device=device).expand(R, n_pad)
    h = h.to(dtype)

    m = m0.clone()
    phi = phi0.clone()
    m_best = m0.clone()
    e_best = torch.full((R,), float("inf"), dtype=dtype, device=device)
    energies = torch.empty((num_sweeps, R), dtype=dtype, device=device)
    for t in range(num_sweeps):
        u = _uniforms(generator, uniforms, t, (R, n_pad), dtype, device)
        beta_tr = beta_sweep[t] * beta_row                       # [R, 1]
        for b in range(num_blocks):
            s = b * B
            betab = (beta_tr if beta_spin is None
                     else beta_tr * beta_spin[:, s:s + B])
            mb = m[:, s:s + B]
            mb_new = heat_bath_update(phi[:, s:s + B], betab, u[:, s:s + B],
                                      mb, mask[:, s:s + B])
            phi = phi_update(phi, mb_new - mb, b)
            m[:, s:s + B] = mb_new
        e = energy_from_fields(h, m, phi)
        better = e < e_best
        m_best = torch.where(better[:, None], m, m_best)
        e_best = torch.where(better, e, e_best)
        energies[t] = e
    return ColoredSweepResult(m=m, phi=phi, m_best=m_best, e_best=e_best,
                              energies=energies)


def colored_sweeps_streamed_reference(
    J_blocks, h, m0, phi0, generator, beta_sweep, beta_row, mask,
    beta_spin=None, *, num_sweeps: int,
    uniforms: Optional[torch.Tensor] = None,
) -> ColoredSweepResult:
    """Plain-torch K2: phi += dm @ J_blocks[b] after each block."""
    nB, B, _ = J_blocks.shape

    def dense(phi, dm, b):
        return phi + torch.matmul(dm, J_blocks[b])

    return _row_beta_sweeps(dense, nB, B, h, m0, phi0, generator, beta_sweep,
                            beta_row, mask, beta_spin, num_sweeps, uniforms)


def colored_sweeps_sparse_reference(
    col_idx, J_tiles, h, m0, phi0, generator, beta_sweep, beta_row, mask,
    beta_spin=None, *, num_sweeps: int,
    uniforms: Optional[torch.Tensor] = None,
) -> ColoredSweepResult:
    """Plain-torch K3: after each block, out = dm @ [tile_0 | ... | tile_K-1]
    and phi[:, col block col_idx[b, k]] += out[:, k-th B columns], in tile
    order, as the Pallas kernel adds them."""
    nB, K, B, _ = J_tiles.shape
    J_cat = J_tiles.permute(0, 2, 1, 3).reshape(nB, B, K * B)
    cols = torch.as_tensor(col_idx).reshape(nB, K).tolist()

    def sparse(phi, dm, b):
        out = torch.matmul(dm, J_cat[b])
        for k, c in enumerate(cols[b]):
            phi[:, c * B:(c + 1) * B] += out[:, k * B:(k + 1) * B]
        return phi

    return _row_beta_sweeps(sparse, nB, B, h, m0, phi0, generator, beta_sweep,
                            beta_row, mask, beta_spin, num_sweeps, uniforms)


# argument kinds of each C entry point, in order ('p' pointer, 'i' int); the
# CUDA stream follows as one more pointer
_SIGNATURES = {"colored_sweeps_f32": "p" * 14 + "i" * 4,
               "colored_sweeps_streamed_f32": "p" * 15 + "i" * 5,
               "colored_sweeps_sparse_f32": "p" * 16 + "i" * 6}


def _bind(lib, fn: str = "colored_sweeps_f32"):
    return bind(lib, fn, _SIGNATURES[fn])


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


def _mask_rows(mask, R, n_pad, device):
    """A [1 | R, n_pad] bool mask, materialised; returns (mask, rows)."""
    rows = mask.shape[0] if getattr(mask, "ndim", 0) == 2 else 1
    if rows not in (1, R):
        raise ValueError(f"mask must have 1 or {R} rows, got {rows}")
    return _broadcast("mask", mask, (rows, n_pad), torch.bool, device), rows


def _check_shared(name, nbytes):
    if nbytes > MAX_SHARED_BYTES:
        raise ValueError(f"{name} needs {nbytes} bytes of shared memory per "
                         f"replica, above the {MAX_SHARED_BYTES} a CTA has")


def _seed(generator, uniforms, shape, device):
    """None with injected uniforms (checked), else two seed words drawn where
    the generator lives and read by the kernel from device memory: no host
    sync before the launch."""
    if uniforms is not None:
        _check("uniforms", uniforms, shape, torch.float32, device)
        return None
    if generator is None:
        raise ValueError("pass a torch.Generator or injected uniforms")
    seed = torch.randint(0, 2 ** 31 - 1, (2,), generator=generator,
                         dtype=torch.int32, device=generator.device)
    return seed.to(device, non_blocking=True)


def _outputs(m0, num_sweeps):
    R = m0.shape[0]
    f32 = dict(dtype=torch.float32, device=m0.device)
    return ColoredSweepResult(
        m=torch.empty_like(m0), phi=torch.empty_like(m0),
        m_best=torch.empty_like(m0), e_best=torch.empty((R,), **f32),
        energies=torch.empty((num_sweeps, R), **f32))


def _ptr(x):
    return x.data_ptr() if x is not None else None


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _require_cuda(x, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")


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
    """T colored heat-bath sweeps (K1); the CUDA kernel on CUDA tensors, the
    plain torch version on CPU tensors."""
    if m0.device.type == "cpu":
        return colored_sweeps_reference(
            J, h, m0, phi0, generator, beta_sweep, beta_spin, update_mask,
            num_sweeps=num_sweeps, block_size=block_size, uniforms=uniforms)
    _require_cuda(m0, "colored_sweeps")

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
    seed = _seed(generator, uniforms, (num_sweeps, R, n_pad), device)

    lib = _bind(load_library(_LIB))
    out = _outputs(m0, num_sweeps)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.colored_sweeps_f32(
        J.data_ptr(), h.data_ptr(), m0.data_ptr(), phi0.data_ptr(),
        beta_spin.data_ptr(), mask.data_ptr(), beta_sweep.data_ptr(),
        _ptr(uniforms), _ptr(seed), out.m.data_ptr(), out.phi.data_ptr(),
        out.m_best.data_ptr(), out.e_best.data_ptr(), out.energies.data_ptr(),
        R, n_pad, block_size, num_sweeps, stream)
    _raise_on(err, "colored_sweeps")
    colored_sweeps.launches += 1
    return out


def _row_beta_args(h, m0, phi0, beta_sweep, beta_row, mask, beta_spin,
                   num_sweeps, n_pad, device):
    """Checked and materialised inputs shared by K2 and K3."""
    f32 = torch.float32
    R = m0.shape[0]
    _check("h", h, (n_pad,), f32, device)
    _check("m0", m0, (R, n_pad), f32, device)
    _check("phi0", phi0, (R, n_pad), f32, device)
    beta_sweep = _broadcast("beta_sweep", beta_sweep, (num_sweeps,), f32, device)
    if isinstance(beta_row, torch.Tensor):
        beta_row = beta_row.reshape(-1)
    beta_row = _broadcast("beta_row", beta_row, (R,), f32, device)
    mask, rows = _mask_rows(mask, R, n_pad, device)
    if beta_spin is not None:
        beta_spin = _broadcast("beta_spin", beta_spin, (R, n_pad), f32, device)
    return beta_sweep, beta_row, mask, rows, beta_spin


def colored_sweeps_streamed(
    J_blocks,     # [nB, B, n_pad] float32 row blocks of the colored layout
    h,            # [n_pad]
    m0,           # [R, n_pad] in {-1, +1}
    phi0,         # [R, n_pad]
    generator,    # torch.Generator the seed is drawn from (None with uniforms)
    beta_sweep,   # [T] or scalar
    beta_row,     # [R] per-replica beta multiplier
    mask,         # [1, n_pad] activity, or [R, n_pad] per-chain mask (bool)
    beta_spin=None,  # [R, n_pad] per-spin beta multiplier, or None
    *,
    num_sweeps: int,
    uniforms: Optional[torch.Tensor] = None,   # [T, R, n_pad] injected draws
) -> ColoredSweepResult:
    """T colored heat-bath sweeps with per-replica beta over dense J row
    blocks (K2); the CUDA kernel on CUDA tensors, the plain torch version
    on CPU tensors."""
    if m0.device.type == "cpu":
        return colored_sweeps_streamed_reference(
            J_blocks, h, m0, phi0, generator, beta_sweep, beta_row, mask,
            beta_spin, num_sweeps=num_sweeps, uniforms=uniforms)
    _require_cuda(m0, "colored_sweeps_streamed")

    device = m0.device
    nB, B, n_pad = J_blocks.shape
    R = m0.shape[0]
    if nB * B != n_pad:
        raise ValueError(f"J_blocks {tuple(J_blocks.shape)} is not square")
    _check("J_blocks", J_blocks, (nB, B, n_pad), torch.float32, device)
    beta_sweep, beta_row, mask, rows, beta_spin = _row_beta_args(
        h, m0, phi0, beta_sweep, beta_row, mask, beta_spin, num_sweeps, n_pad,
        device)
    _check_shared("colored_sweeps_streamed", 5 * n_pad + 8 * B)
    seed = _seed(generator, uniforms, (num_sweeps, R, n_pad), device)

    lib = _bind(load_library(_LIB), "colored_sweeps_streamed_f32")
    out = _outputs(m0, num_sweeps)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.colored_sweeps_streamed_f32(
        J_blocks.data_ptr(), h.data_ptr(), m0.data_ptr(), phi0.data_ptr(),
        _ptr(beta_spin), mask.data_ptr(), beta_sweep.data_ptr(),
        beta_row.data_ptr(), _ptr(uniforms), _ptr(seed), out.m.data_ptr(),
        out.phi.data_ptr(), out.m_best.data_ptr(), out.e_best.data_ptr(),
        out.energies.data_ptr(), R, n_pad, B, num_sweeps, rows, stream)
    _raise_on(err, "colored_sweeps_streamed")
    colored_sweeps_streamed.launches += 1
    return out


def colored_sweeps_sparse(
    col_idx,      # [nB, K] int32 nonzero column-tile indices per row block
    J_tiles,      # [nB, K, B, B] float32 (padding tiles are zero, col 0)
    h,            # [n_pad]
    m0,           # [R, n_pad] in {-1, +1}
    phi0,         # [R, n_pad]
    generator,    # torch.Generator the seed is drawn from (None with uniforms)
    beta_sweep,   # [T] or scalar
    beta_row,     # [R] per-replica beta multiplier
    mask,         # [1, n_pad] activity, or [R, n_pad] per-chain mask (bool)
    beta_spin=None,  # [R, n_pad] per-spin beta multiplier, or None
    *,
    num_sweeps: int,
    uniforms: Optional[torch.Tensor] = None,   # [T, R, n_pad] injected draws
) -> ColoredSweepResult:
    """T colored heat-bath sweeps with per-replica beta over the block-sparse
    tiles of J (K3); the CUDA kernel on CUDA tensors, the plain torch
    version on CPU tensors."""
    if m0.device.type == "cpu":
        return colored_sweeps_sparse_reference(
            col_idx, J_tiles, h, m0, phi0, generator, beta_sweep, beta_row,
            mask, beta_spin, num_sweeps=num_sweeps, uniforms=uniforms)
    _require_cuda(m0, "colored_sweeps_sparse")

    device = m0.device
    nB, K, B, _ = J_tiles.shape
    n_pad = nB * B
    R = m0.shape[0]
    _check("col_idx", col_idx, (nB, K), torch.int32, device)
    _check("J_tiles", J_tiles, (nB, K, B, B), torch.float32, device)
    beta_sweep, beta_row, mask, rows, beta_spin = _row_beta_args(
        h, m0, phi0, beta_sweep, beta_row, mask, beta_spin, num_sweeps, n_pad,
        device)
    _check_shared("colored_sweeps_sparse", 5 * n_pad + 4 * K * B + 8 * B + 4 * K)
    seed = _seed(generator, uniforms, (num_sweeps, R, n_pad), device)

    lib = _bind(load_library(_LIB_SPARSE), "colored_sweeps_sparse_f32")
    out = _outputs(m0, num_sweeps)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.colored_sweeps_sparse_f32(
        col_idx.data_ptr(), J_tiles.data_ptr(), h.data_ptr(), m0.data_ptr(),
        phi0.data_ptr(), _ptr(beta_spin), mask.data_ptr(),
        beta_sweep.data_ptr(), beta_row.data_ptr(), _ptr(uniforms),
        _ptr(seed), out.m.data_ptr(), out.phi.data_ptr(),
        out.m_best.data_ptr(), out.e_best.data_ptr(),
        out.energies.data_ptr(), R, n_pad, B, K, num_sweeps, rows, stream)
    _raise_on(err, "colored_sweeps_sparse")
    colored_sweeps_sparse.launches += 1
    return out


colored_sweeps.launches = 0
colored_sweeps_streamed.launches = 0
colored_sweeps_sparse.launches = 0
