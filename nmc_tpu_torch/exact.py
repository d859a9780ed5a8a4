"""Exact ground states by meet-in-the-middle enumeration.

Split the spins into halves A|B. With SA = all +-1 assignments of A
(2^a rows) and SB of B (2^b rows),

    E(sA, sB) = EA(sA) + EB(sB) + sA . J_AB . sB

so the full 2^n energy table is a rank-(a) product `SA @ J_AB @ SB^T` plus
broadcast row and column energies. The minimum over the table is the EXACT
ground state; no sampling, no tolerance.

Global spin-flip symmetry (E(-s) = E(s) for h = 0) pins the first A spin to
+1, halving the table.

Exactness in f32: every energy is an integer-weighted +-1 sum bounded by
`sum|J| + sum|h|`; if that bound is < 2^24, f32 arithmetic is exact (the
port keeps TF32 off, `device.py`).

Tiers (copies of ``nmc_tpu/exact.py``; the host helpers are copied as they
are):
- `solve_exact_host`   -- numpy, n <= ~34 (wall grows 2x per spin).
- `solve_exact_device` -- torch tiles over (A-block x B-tile), each one f32
  matmul with a flat argmin; the running best stays on the device.
- `solve_exact_fused`  -- the fused table kernels (`ops/exact_cuda.py`:
  K6 in f32, K7 on int8 digit planes): the table never reaches device
  memory, min/argmin are reduced per A row in the kernel. The counterpart
  of the JAX package's `solve_exact_pallas`.
- `solve_exact_enum`   -- branch-and-bound over the +-1 cube with proof
  (the g++-built `native/enum.cpp`), seeded by the host spectral search;
  host code, its cost set by the instance's spectral gap.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .device import resolve_device

__all__ = ["solve_exact_host", "solve_exact_device", "solve_exact_fused",
           "solve_exact_enum", "exact_energy_bound", "signs_table",
           "fused_inputs"]


def exact_energy_bound(J, h=None) -> float:
    """Upper bound on |any partial energy sum| — f32 is exact below 2^24."""
    b = 0.5 * float(np.abs(J).sum())
    if h is not None:
        b += float(np.abs(h).sum())
    return b


def signs_table(k: int, offset: int = 0, count: Optional[int] = None,
                dtype=np.float32) -> np.ndarray:
    """[count, k] +-1 rows: row r encodes integer (offset + r), bit j ->
    spin j (LSB first; bit set -> -1)."""
    if count is None:
        count = 1 << k
    r = np.arange(offset, offset + count, dtype=np.int64)
    bits = (r[:, None] >> np.arange(k)[None, :]) & 1
    return (1.0 - 2.0 * bits).astype(dtype)


def _split(J, h):
    n = J.shape[0]
    a = n // 2            # A: first a spins (streamed), B: resident
    return a, n - a


def _half_energies(Jhh, hh, S):
    """E_half(s) = -1/2 s.Jhh.s - hh.s for every row of S."""
    return (-0.5 * np.einsum("ri,ij,rj->r", S, Jhh, S) - S @ hh)


def solve_exact_host(prob, *, symmetry: Optional[bool] = None,
                     block: int = 4096) -> Tuple[float, np.ndarray]:
    """Exact ground state by blocked meet-in-the-middle on the host.

    Returns (energy, state) in raw units; energy is the true global
    minimum of E(s) = -1/2 s.J.s - h.s over {+-1}^n.
    """
    J = np.asarray(prob.J, np.float64)
    h = np.asarray(prob.h, np.float64)
    n = J.shape[0]
    if n > 34:
        raise ValueError(f"solve_exact_host is O(2^n): n={n} > 34 "
                         "(use solve_exact_device or solve_exact_fused)")
    a, b = _split(J, h)
    if symmetry is None:
        symmetry = not np.any(h)
    JA, JB, JX = J[:a, :a], J[a:, a:], J[a:, :a]   # JX: [b, a]
    hA, hB = h[:a], h[a:]

    SB = signs_table(b, dtype=np.float64)
    EB = _half_energies(JB, hB, SB)
    CB = SB @ JX                                    # [2^b, a]

    total_a = 1 << (a - 1 if symmetry else a)       # s_0 pinned to +1
    best = (np.inf, 0, 0)
    for off in range(0, total_a, block):
        cnt = min(block, total_a - off)
        # pinned bit: enumerate the remaining a-1 bits, prepend +1
        if symmetry:
            SA = np.concatenate(
                [np.ones((cnt, 1)), signs_table(a - 1, off, cnt,
                                                np.float64)], axis=1)
        else:
            SA = signs_table(a, off, cnt, np.float64)
        EA = _half_energies(JA, hA, SA)
        # E table tile: [cnt, 2^b]; cross term = -SA . JX^T . SB^T
        T = EA[:, None] + EB[None, :] - SA @ CB.T
        i = np.unravel_index(np.argmin(T), T.shape)
        if T[i] < best[0]:
            best = (float(T[i]), off + int(i[0]), int(i[1]))
    e, ra, rb = best
    s = _state(a, b, symmetry, ra, rb)
    assert abs(float(prob.energy(s)) - e) < 1e-6 * max(1.0, abs(e))
    return e, s


def _state(a, b, symmetry, ra, rb) -> np.ndarray:
    """The +-1 state of A row `ra` (first spin pinned under symmetry) and
    B row `rb`."""
    if symmetry:
        sA = np.concatenate([[1.0], signs_table(a - 1, ra, 1,
                                                np.float64)[0]])
    else:
        sA = signs_table(a, ra, 1, np.float64)[0]
    sB = signs_table(b, rb, 1, np.float64)[0]
    return np.concatenate([sA, sB])


def _b_tables(J, h, a, b, block=1 << 18, dtype=np.float32):
    """EB [2^b] and CBT [a, 2^b], built in blocks so the f64 sign tables
    never exceed `block` rows. Default f32 storage is exact for integer
    values < 2^24; the int8-plane path passes dtype=f64 so values up to
    its 2^29 window survive the stopover (f32 would drop low bits)."""
    JB, JX, hB = J[a:, a:], J[a:, :a], h[a:]
    EB = np.empty(1 << b, dtype)
    CBT = np.empty((a, 1 << b), dtype)
    for off in range(0, 1 << b, block):
        cnt = min(block, (1 << b) - off)
        SB = signs_table(b, off, cnt, np.float64)
        EB[off:off + cnt] = _half_energies(JB, hB, SB)
        CBT[:, off:off + cnt] = (SB @ JX).T
    return EB, CBT


def solve_exact_device(prob, *, symmetry: Optional[bool] = None,
                       block_a: int = 1024, block_b: int = 1 << 15,
                       verify: bool = True,
                       device=None) -> Tuple[float, np.ndarray]:
    """Exact ground state on the device with torch tiles: the B-side tables
    (EB, CBT = SB.JX^T) live in device memory; a Python loop over
    (A-block x B-tile) computes each energy tile with one full-f32 matmul
    and reduces it with a flat argmin (the first minimum in row-major
    order), keeping the running best on the device (no host sync per
    tile).

    Each tile makes a round trip through device memory; the fused tier
    (`solve_exact_fused`) keeps it on chip. f32 exactness is guarded via
    `exact_energy_bound` < 2^24. `device` defaults to the CUDA card.
    """
    dev = resolve_device(device)
    f32 = torch.float32
    J = np.asarray(prob.J, np.float64)
    h = np.asarray(prob.h, np.float64)
    if exact_energy_bound(J, h) >= float(1 << 24):
        raise ValueError("coupling magnitudes too large for exact f32 "
                         "meet-in-the-middle (bound >= 2^24); rescale or "
                         "use the host path")
    a, b = _split(J, h)
    if symmetry is None:
        symmetry = not np.any(h)
    abits = a - 1 if symmetry else a
    total_a = 1 << abits
    block_a = min(block_a, total_a)
    block_b = min(block_b, 1 << b)
    num_a = (total_a + block_a - 1) // block_a
    num_b = (1 << b) // block_b

    EB_h, CBT_h = _b_tables(J, h, a, b)
    EB = torch.as_tensor(EB_h, device=dev)
    CBT = torch.as_tensor(CBT_h, device=dev)
    JA32 = torch.as_tensor(J[:a, :a], dtype=f32, device=dev)
    hA32 = torch.as_tensor(h[:a], dtype=f32, device=dev)
    rows = torch.arange(block_a, dtype=torch.int64, device=dev)
    shifts = torch.arange(abits, dtype=torch.int64, device=dev)

    best_e = torch.tensor(float("inf"), dtype=f32, device=dev)
    best_ra = torch.zeros((), dtype=torch.int64, device=dev)
    best_rb = torch.zeros((), dtype=torch.int64, device=dev)
    for off in range(0, num_a * block_a, block_a):
        r = off + rows
        SA = 1.0 - 2.0 * ((r[:, None] >> shifts) & 1).to(f32)
        if symmetry:
            SA = torch.cat([torch.ones((block_a, 1), dtype=f32, device=dev),
                            SA], dim=1)
        EA = -0.5 * torch.einsum("ri,ij,rj->r", SA, JA32, SA) - SA @ hA32
        EA = torch.where(r < total_a, EA, float("inf"))
        for jb in range(num_b):
            boff = jb * block_b
            T = (EA[:, None] + EB[None, boff:boff + block_b]
                 - SA @ CBT[:, boff:boff + block_b])
            flat = torch.argmin(T)
            e = T.reshape(-1)[flat]
            better = e < best_e
            best_e = torch.where(better, e, best_e)
            best_ra = torch.where(better, off + flat // block_b, best_ra)
            best_rb = torch.where(better, boff + flat % block_b, best_rb)

    e, ra, rb = float(best_e), int(best_ra), int(best_rb)
    s = _state(a, b, symmetry, ra, rb)
    e64 = float(prob.energy(s))            # f64 re-verification on host
    if verify:
        assert abs(e64 - e) <= 1e-3 * max(1.0, abs(e64)), \
            f"device/host energy mismatch: {e} vs {e64}"
    return e64, s


def _integer_problem(J, h) -> bool:
    """True when every table entry is guaranteed integer: integer J/h
    AND zero diagonal (IsingProblem documents but does not enforce it;
    a nonzero diagonal makes the half-energies half-integer, which the
    int32 path would silently round)."""
    return bool(np.all(J == np.round(J)) and np.all(h == np.round(h))
                and not np.any(np.diag(J)))


def fused_inputs(prob, *, symmetry: Optional[bool] = None,
                 block_a: int = 512, block_b: int = 4096,
                 planes: str = "auto"):
    """The fused tier's kernel inputs on the host, as `solve_exact_fused`
    builds them: (use_i8, arrays, layout). arrays is (SA, C, EA, EB) for K7
    (int8 SA, int8 digit planes, int32 energies with I32_PAD rows) when
    use_i8, else for K6 (f32, +inf pad rows); layout is (a, b, symmetry,
    block_a, block_b) with the blocks clamped to the tables."""
    from .ops.exact_cuda import I32_PAD, int8_planes

    if planes not in ("auto", "on", "off"):
        raise ValueError(f"planes must be auto|on|off, got {planes!r}")
    J = np.asarray(prob.J, np.float64)
    h = np.asarray(prob.h, np.float64)
    bound = exact_energy_bound(J, h)
    int_ok = _integer_problem(J, h) and bound < float(1 << 29)
    if planes == "on" and not int_ok:
        raise ValueError("planes='on' requires an integer-coupled "
                         "instance with energy bound < 2^29")
    use_i8 = int_ok and planes != "off"
    if not use_i8 and bound >= float(1 << 24):
        raise ValueError("coupling magnitudes too large for exact f32 "
                         "meet-in-the-middle (bound >= 2^24)")
    a, b = _split(J, h)
    if symmetry is None:
        symmetry = not np.any(h)
    abits = a - 1 if symmetry else a
    total_a = 1 << abits
    block_a = min(block_a, total_a)
    block_b = min(block_b, 1 << b)
    TA = ((total_a + block_a - 1) // block_a) * block_a
    JA, hA = J[:a, :a], h[:a]

    # A-side tables, built in bounded f64 blocks (+inf pads); f64
    # storage on the int path (integers < 2^29 do not fit f32)
    tab_dt = np.float64 if use_i8 else np.float32
    SA = np.ones((TA, a), np.float32)
    EA = np.full(TA, np.inf, tab_dt)
    step = 1 << 18
    for off in range(0, total_a, step):
        cnt = min(step, total_a - off)
        Sblk = signs_table(abits, off, cnt, np.float64)
        if symmetry:
            Sblk = np.concatenate([np.ones((cnt, 1)), Sblk], axis=1)
        SA[off:off + cnt] = Sblk
        EA[off:off + cnt] = _half_energies(JA, hA, Sblk)

    EB, CBT = _b_tables(J, h, a, b, dtype=tab_dt)
    if use_i8:
        # integer path: +-1 tables as int8, energies as int32 (pad rows
        # get the I32_PAD sentinel), cross term as base-256 digit planes
        EA_i = np.where(np.isfinite(EA), np.round(EA), I32_PAD)
        arrays = (SA.astype(np.int8), int8_planes(CBT),
                  EA_i.astype(np.int32), np.round(EB).astype(np.int32))
    else:
        arrays = (SA, CBT, EA, EB)
    return use_i8, arrays, (a, b, symmetry, block_a, block_b)


def solve_exact_fused(prob, *, symmetry: Optional[bool] = None,
                      block_a: int = 512, block_b: int = 4096,
                      planes: str = "auto", verify: bool = True,
                      device=None, timings: Optional[dict] = None
                      ) -> Tuple[float, np.ndarray]:
    """Exact ground state via the fused table kernels (ops/exact_cuda.py):
    every energy tile stays on chip, reduced to a per-A-row running (min,
    argmin-b); device memory sees only the +-1 tables. The counterpart of
    the JAX package's `solve_exact_pallas`.

    `planes` selects the cross-term path: "auto" uses the int8 digit-plane
    kernel K7 (`mitm_min_i8`) whenever the instance is integer-coupled with
    |energy| bound < 2^29 (exact to 2^29 instead of 2^24); "on" requires it
    (raises when the instance doesn't qualify); "off" forces the f32 kernel
    K6 (`mitm_min`). On the CUDA card (the default `device`) the kernels
    run; with device="cpu" their plain twins.

    A `timings` dict receives the wall seconds of each step: "tables"
    (`fused_inputs` on the host), "upload" (to the device, with the
    kernels' operand packing on the card), "kernel" (the launch until
    (min_e, arg_b) are back on the host) and "verify" (the state and its
    f64 energy).
    """
    import time

    from .ops.exact_cuda import (_launch_f32, _launch_i8, _pack_f32,
                                 _pack_i8, mitm_min, mitm_min_i8)

    dev = resolve_device(device)
    t0 = time.perf_counter()
    use_i8, arrays, (a, b, symmetry, block_a, block_b) = fused_inputs(
        prob, symmetry=symmetry, block_a=block_a, block_b=block_b,
        planes=planes)
    t1 = time.perf_counter()
    inputs = [torch.as_tensor(x, device=dev) for x in arrays]
    blocks = dict(block_a=block_a, block_b=block_b)
    if dev.type == "cuda":
        packed = (_pack_i8 if use_i8 else _pack_f32)(*inputs, **blocks)
        if timings is not None:
            torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    if dev.type == "cuda":
        min_e, arg_b = (_launch_i8 if use_i8 else _launch_f32)(*packed)
    else:
        min_e, arg_b = (mitm_min_i8 if use_i8 else mitm_min)(*inputs,
                                                             **blocks)
    min_e = min_e.cpu().numpy()
    arg_b = arg_b.cpu().numpy()
    t3 = time.perf_counter()
    ra = int(np.argmin(min_e))
    rb = int(arg_b[ra])
    s = _state(a, b, symmetry, ra, rb)
    e64 = float(prob.energy(s))
    if verify:
        assert abs(e64 - float(min_e[ra])) <= 1e-3 * max(1.0, abs(e64)), \
            f"kernel/host energy mismatch: {min_e[ra]} vs {e64}"
    if timings is not None:
        timings.update(tables=t1 - t0, upload=t2 - t1, kernel=t3 - t2,
                       verify=time.perf_counter() - t3)
    return e64, s


def solve_exact_enum(prob, *, incumbent: Optional[np.ndarray] = None,
                     max_nodes: int = 0,
                     dm_starts: int = 512, dm_iters: int = 800,
                     seed: int = 0):
    """Exact ground state (with PROOF) by native branch-and-bound
    enumeration: host code (numpy, scipy and the port's g++-built
    `native/enum.cpp`), no card needed.

    E(s) = c0 + 1/2 ||M s||^2 exactly, with M = diag(sqrt(lmax - w)) V^T
    from the eigendecomposition of J (h != 0 is not supported: fold the
    fields into an ancilla spin first). A QR of M (heavy pivot columns
    enumerated first) turns accumulated row norms into exact bounds; the
    native DFS beats or proves the incumbent (default: the host
    `spectral_search`'s best). Returns (energy, state, proved): `proved`
    means the tree was exhausted, so `energy` is the true global minimum.
    `max_nodes` caps the search (0 = unbounded), returning proved=False
    when hit.
    """
    import scipy.linalg as sla

    from .native import exact_enumerate
    from .ops.spectral import spectral_search

    J = np.asarray(prob.J, np.float64)
    h = np.asarray(prob.h, np.float64)
    if np.any(h):
        raise ValueError("solve_exact_enum requires h = 0 (spin-flip "
                         "symmetric form); fold fields into an ancilla "
                         "spin first")
    n = J.shape[0]
    w, v = np.linalg.eigh(J)
    lmax = float(w[-1])
    c0 = -0.5 * lmax * n
    M = np.sqrt(np.maximum(lmax - w, 0.0))[:, None] * v.T

    if incumbent is None:
        r = spectral_search(prob, dm_starts=dm_starts, dm_iters=dm_iters,
                            polish=8, seed=seed)
        incumbent = r.best_state
    incumbent = np.where(np.asarray(incumbent, np.float64) >= 0, 1., -1.)
    e_inc = float(prob.energy(incumbent))

    # heavy pivots first in enumeration order (R diagonal increasing)
    _, _, piv = sla.qr(M, pivoting=True)
    order = piv[::-1].copy()
    _, R = sla.qr(M[:, order], mode="economic")
    A = np.abs(R)
    W = np.zeros_like(R)
    for k in range(n):
        W[k, k + 1:] = np.cumsum(A[k, k:-1])

    r2 = 2.0 * (e_inc - c0)
    found, z, best_r2, nodes, complete = exact_enumerate(
        R, W, r2, max_nodes=max_nodes)
    if found:
        s = np.empty(n)
        s[order] = z
        e = float(prob.energy(s))
        # enumeration improved the incumbent; exhausted tree = proof
        return e, s, complete
    return e_inc, incumbent, complete
