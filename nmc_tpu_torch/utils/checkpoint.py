"""Checkpoint / resume for long runs (host side, numpy).

A copy of ``nmc_tpu/utils/checkpoint.py``: any run state (spin states,
random-number state, beta schedule, best-so-far) snapshots to a single .npz
atomically and restores exactly, so every driver loop can resume after
preemption. Nested dicts, lists, tuples and NamedTuples of numpy arrays and
scalars are supported. The port's drivers store a `torch.Generator`'s state
(`get_state()`, a uint8 array) where the JAX package stores its PRNG key.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np


def _flatten(prefix: str, obj, out: Dict[str, np.ndarray], meta: Dict[str, Any]):
    if obj is None:
        meta[prefix] = {"type": "none"}
    elif isinstance(obj, (bool, int, float, str)):
        meta[prefix] = {"type": "scalar", "value": obj,
                        "pytype": type(obj).__name__}
    elif isinstance(obj, dict):
        meta[prefix] = {"type": "dict", "keys": list(obj.keys())}
        for k, v in obj.items():
            _flatten(f"{prefix}.{k}", v, out, meta)
    elif hasattr(obj, "_fields"):  # NamedTuple
        meta[prefix] = {"type": "namedtuple",
                        "cls": type(obj).__name__,
                        "fields": list(obj._fields)}
        for k in obj._fields:
            _flatten(f"{prefix}.{k}", getattr(obj, k), out, meta)
    elif isinstance(obj, (list, tuple)):
        meta[prefix] = {"type": "list" if isinstance(obj, list) else "tuple",
                        "len": len(obj)}
        for i, v in enumerate(obj):
            _flatten(f"{prefix}.{i}", v, out, meta)
    else:
        arr = np.asarray(obj)
        meta[prefix] = {"type": "array"}
        out[prefix] = arr


def _unflatten(prefix: str, arrays, meta, namedtuple_registry):
    info = meta[prefix]
    t = info["type"]
    if t == "none":
        return None
    if t == "scalar":
        v = info["value"]
        return {"bool": bool, "int": int, "float": float,
                "str": str}[info["pytype"]](v)
    if t == "array":
        return arrays[prefix]
    if t == "dict":
        return {k: _unflatten(f"{prefix}.{k}", arrays, meta,
                              namedtuple_registry) for k in info["keys"]}
    if t in ("list", "tuple"):
        items = [_unflatten(f"{prefix}.{i}", arrays, meta,
                            namedtuple_registry) for i in range(info["len"])]
        return items if t == "list" else tuple(items)
    if t == "namedtuple":
        vals = {k: _unflatten(f"{prefix}.{k}", arrays, meta,
                              namedtuple_registry) for k in info["fields"]}
        cls = (namedtuple_registry or {}).get(info["cls"])
        if cls is not None:
            return cls(**vals)
        return vals  # degrade to dict when the class isn't registered
    raise ValueError(f"unknown node type {t}")


def save_checkpoint(path: str, state: Any, step: Optional[int] = None,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """Atomically snapshot a pytree-ish `state` to `path` (.npz)."""
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {}
    _flatten("state", state, arrays, meta)
    if extra:
        _flatten("extra", extra, arrays, meta)
    meta["__step__"] = step
    payload = dict(arrays)
    payload["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)

    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str, namedtuple_registry: Optional[dict] = None
                    ) -> Tuple[Any, Optional[int], Dict[str, Any]]:
    """Restore (state, step, extra) from a snapshot.

    `namedtuple_registry`: {'ClassName': Class} to reconstruct NamedTuples
    (e.g. {'ShardedPTState': ShardedPTState}); unknown classes come back as
    dicts.
    """
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    state = _unflatten("state", arrays, meta, namedtuple_registry)
    extra = (_unflatten("extra", arrays, meta, namedtuple_registry)
             if "extra" in meta else {})
    return state, meta.get("__step__"), extra
