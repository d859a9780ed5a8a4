"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into
``csrc/_build/lib<name>-<hash>.so``, keyed by a hash of the source, the
shared headers ``csrc/*.cuh`` and the flags, so an edited source rebuilds
and an unchanged one loads at once. The
library exposes a plain C interface (no PyTorch headers), which keeps the
build to seconds. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
# ctypes type of each argument kind of the C entry points: 'p' pointer
# (c_void_p: a c_int would cut a 64-bit pointer), 'i' int, 'f' float
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, else from PATH, else /usr/local/cuda."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else [])
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources() -> List[str]:
    """Names of the CUDA sources (csrc/<name>.cu), one library each."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str, csrc: Path = None, build_dir: Path = None) -> Path:
    csrc = CSRC if csrc is None else csrc
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return ((BUILD_DIR if build_dir is None else build_dir)
            / f"lib{name}-{h.hexdigest()[:16]}.so")


def build(name: str, csrc: Path = None, build_dir: Path = None) -> Path:
    """Compile <csrc>/<name>.cu (default the package's csrc/ into its
    _build/) unless the hashed library already exists. nvcc's output
    (ptxas register and shared-memory report) is kept beside the library
    as <lib>.log."""
    csrc = CSRC if csrc is None else csrc
    build_dir = BUILD_DIR if build_dir is None else build_dir
    out = library_path(name, csrc, build_dir)
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(csrc / f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)   # atomic: concurrent builders never see half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all() -> Dict[str, Path]:
    """Build every csrc/*.cu at once, one nvcc process per source."""
    names = sources()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load_library(name: str) -> ctypes.CDLL:
    """Build (first use) and load csrc/<name>.cu; cached per process."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name)))
    return _LIBS[name]


def bind(lib, fn: str, kinds: str):
    """Give `lib.<fn>` its ctypes signature, one argument per letter of
    `kinds` and the CUDA stream as one more pointer, unless it has one;
    returns `lib`. Every entry point returns its cudaError_t as an int."""
    f = getattr(lib, fn)
    if getattr(f, "argtypes", None) is None:
        f.argtypes = [_CTYPES[k] for k in kinds] + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    return lib
