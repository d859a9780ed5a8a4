"""Native (C++) host code of the port: the exact-enumeration library.

`enum.cpp` is a byte-for-byte copy of ``nmc_tpu/native/enum.cpp``
(branch-and-bound over the +-1 cube with proof of optimality). It builds
with g++ at first use, never at import, into ``native/_build/``, keyed by
a hash of the source, the flags and the host's CPU (``-march=native``
builds for the machine it runs on, so a library built on another host is
never loaded); plain C ABI through ctypes. Unlike the JAX package's
loader, which returns None for its caller to fall back on, a failed build
or load raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_ENUM_SRC = os.path.join(_HERE, "enum.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_ENUM_LIB: Optional[ctypes.CDLL] = None


def _host_key() -> str:
    """The CPU this process runs on: machine, and the model and feature
    flags /proc/cpuinfo reports (where it exists)."""
    parts = [platform.machine(), platform.processor()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    parts.append(line.strip())
                if len(parts) >= 4:
                    break
    except OSError:
        parts.append(platform.node())
    return "\n".join(parts)


def library_path() -> str:
    h = hashlib.sha256()
    with open(_ENUM_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join([CXX, *CXX_FLAGS]).encode())
    h.update(_host_key().encode())
    return os.path.join(BUILD_DIR, f"libnmcenum-{h.hexdigest()[:16]}.so")


def _build(so_path: str) -> None:
    """Compile enum.cpp to `so_path` (atomically: concurrent builders never
    see half a file); raises RuntimeError with the compiler's output."""
    os.makedirs(os.path.dirname(so_path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so_path))
    os.close(fd)
    try:
        try:
            proc = subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, _ENUM_SRC],
                                  capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"building enum.cpp with {CXX} failed: "
                               f"{e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"building enum.cpp with {CXX} failed "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_enum_library() -> ctypes.CDLL:
    """Build (first use) and load the exact-enumeration library; cached
    per process. Raises RuntimeError when the build or the load fails."""
    global _ENUM_LIB
    with _LOCK:
        if _ENUM_LIB is not None:
            return _ENUM_LIB
        so_path = library_path()
        if not os.path.exists(so_path):
            _build(so_path)
        try:
            lib = ctypes.CDLL(so_path)
        except OSError as e:
            raise RuntimeError(f"loading {so_path} failed: {e}") from e
        common_tail = [
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_longlong,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ]
        lib.nmc_exact_enumerate.restype = ctypes.c_longlong
        lib.nmc_exact_enumerate.argtypes = [
            ctypes.c_int32,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ] + common_tail
        lib.nmc_exact_enumerate_f32.restype = ctypes.c_longlong
        lib.nmc_exact_enumerate_f32.argtypes = [
            ctypes.c_int32,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ] + common_tail
        _ENUM_LIB = lib
        return lib


def exact_enumerate(R: np.ndarray, W: np.ndarray, r2: float,
                    max_nodes: int = 0, use_f32: bool = False,
                    progress: Optional[np.ndarray] = None):
    """DFS the +-1 cube against upper-triangular R (see enum.cpp).

    Returns (found, z, best_r2, nodes, complete): `complete` means the
    tree was exhausted, a PROOF that nothing beats r2 (or that the
    returned z is the exact optimum if found). `use_f32`: 2x SIMD width,
    SEARCH MODE ONLY (the f32 box bound can wrongly prune near-radius
    subtrees, so exhaustion is not a proof in f32; use f64 for proofs).
    `progress`: optional int64[1] array the kernel updates every ~16M
    nodes.
    """
    lib = load_enum_library()
    n = R.shape[0]
    if R.shape != (n, n) or W.shape != (n, n):
        raise ValueError(f"R and W must be [n, n], got {R.shape}, {W.shape}")
    best_r2 = np.array([r2], np.float64)
    best_z = np.zeros(n, np.float64)
    found = np.zeros(1, np.int32)
    status = np.zeros(1, np.int32)
    if progress is None:
        progress = np.zeros(1, np.int64)
    dt = np.float32 if use_f32 else np.float64
    fn = lib.nmc_exact_enumerate_f32 if use_f32 else lib.nmc_exact_enumerate
    nodes = fn(
        np.int32(n), np.ascontiguousarray(R, dt),
        np.ascontiguousarray(W, dt), best_r2, best_z, found,
        status, np.longlong(max_nodes), progress)
    return (bool(found[0]), best_z, float(best_r2[0]), int(nodes),
            status[0] == 0)
