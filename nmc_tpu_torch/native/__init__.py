"""Native (C++) host code of the port: two libraries.

  * `enum.cpp`, a byte-for-byte copy of ``nmc_tpu/native/enum.cpp``
    (branch-and-bound over the +-1 cube with proof of optimality);
  * `cluster.cpp`, the code of ``nmc_tpu/native/cluster.cpp`` (only its
    comments differ): the union-find components of an active-node
    subgraph, which the host Houdayer moves call, and the backbone-cluster
    pass, with `CSRAdjacency`, `connected_components_masked` and
    `backbone_clusters`.

Each builds with g++ at first use, never at import, into
``native/_build/``, keyed by a hash of its source, the flags and the
host's CPU (``-march=native`` builds for the machine it runs on, so a
library built on another host is never loaded); plain C ABI through
ctypes. Unlike the JAX package's loader, which returns None for its
caller to fall back on, a failed build or load raises with the compiler's
output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from typing import List, Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_ENUM_SRC = os.path.join(_HERE, "enum.cpp")
_CLUSTER_SRC = os.path.join(_HERE, "cluster.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_ENUM_LIB: Optional[ctypes.CDLL] = None
_CLUSTER_LIB: Optional[ctypes.CDLL] = None


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


def library_path(src: str = _ENUM_SRC) -> str:
    """Where the library of `src` (default enum.cpp) is built."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join([CXX, *CXX_FLAGS]).encode())
    h.update(_host_key().encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"libnmc{stem}-{h.hexdigest()[:16]}.so")


def _build(so_path: str, src: str = _ENUM_SRC) -> None:
    """Compile `src` to `so_path` (atomically: a concurrent build never
    sees half a file); raises RuntimeError with the compiler's output."""
    os.makedirs(os.path.dirname(so_path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so_path))
    os.close(fd)
    try:
        try:
            proc = subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"building {os.path.basename(src)} with {CXX} "
                               f"failed: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"building {os.path.basename(src)} with {CXX} "
                               f"failed (exit {proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load(src: str) -> ctypes.CDLL:
    """Build `src` unless its library exists, and load it (under _LOCK)."""
    so_path = library_path(src)
    if not os.path.exists(so_path):
        _build(so_path, src)
    try:
        return ctypes.CDLL(so_path)
    except OSError as e:
        raise RuntimeError(f"loading {so_path} failed: {e}") from e


def load_enum_library() -> ctypes.CDLL:
    """Build (first use) and load the exact-enumeration library; cached
    per process. Raises RuntimeError when the build or the load fails."""
    global _ENUM_LIB
    with _LOCK:
        if _ENUM_LIB is not None:
            return _ENUM_LIB
        lib = _load(_ENUM_SRC)
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


def load_cluster_library() -> ctypes.CDLL:
    """Build (first use) and load the cluster library; cached per process.
    Raises RuntimeError when the build or the load fails."""
    global _CLUSTER_LIB
    with _LOCK:
        if _CLUSTER_LIB is not None:
            return _CLUSTER_LIB
        lib = _load(_CLUSTER_SRC)
        lib.nmc_connected_components.restype = ctypes.c_int32
        lib.nmc_connected_components.argtypes = [
            ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
        lib.nmc_backbone_clusters.restype = ctypes.c_int32
        lib.nmc_backbone_clusters.argtypes = [
            ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
        _CLUSTER_LIB = lib
        return lib


class CSRAdjacency:
    """Reusable CSR adjacency of a (symmetric) J, built once per problem:
    the sorted column indices of its nonzeros, row by row."""

    def __init__(self, J):
        from scipy.sparse import csr_matrix

        Jc = csr_matrix(np.asarray(
            J.toarray() if hasattr(J, "toarray") else J) != 0)
        Jc.sort_indices()
        self.indptr = Jc.indptr.astype(np.int64)
        self.indices = Jc.indices.astype(np.int32)
        self.n = Jc.shape[0]


def _groups(labels: np.ndarray, count: int) -> List[np.ndarray]:
    """The members of each label 0 .. count - 1, ascending, in label
    order (a stable sort: O(n log n), not O(n count))."""
    order = np.argsort(labels, kind="stable")
    bounds = np.searchsorted(labels[order], np.arange(count + 1))
    return [order[bounds[c]:bounds[c + 1]] for c in range(count)]


def connected_components_masked(
    adj: CSRAdjacency, active: np.ndarray
) -> List[np.ndarray]:
    """Components of the subgraph induced by `active` nodes (union-find).
    Returns a list of index arrays ordered by smallest member: the
    partition and order of ops/clusters.disagreement_clusters."""
    lib = load_cluster_library()
    labels = np.empty(adj.n, dtype=np.int32)
    ncomp = lib.nmc_connected_components(
        np.int32(adj.n), adj.indptr, adj.indices,
        np.ascontiguousarray(active, dtype=np.int8), labels)
    return _groups(labels, ncomp)


def backbone_clusters(
    adj: CSRAdjacency, magnetizations: np.ndarray,
    threshold_initial: float, threshold_cutoff: float,
    threshold_step: float,
) -> List[np.ndarray]:
    """The backbone-cluster pass (semantics of the reference's
    NMC/nmc.py:257-318): the membership of ops/clusters.find_clusters, each
    cluster's members ascending."""
    lib = load_cluster_library()
    cid = np.empty(adj.n, dtype=np.int32)
    ncl = lib.nmc_backbone_clusters(
        np.int32(adj.n), adj.indptr, adj.indices,
        np.ascontiguousarray(magnetizations, dtype=np.float64),
        float(threshold_initial), float(threshold_cutoff),
        float(threshold_step), cid)
    return _groups(cid, ncl)
