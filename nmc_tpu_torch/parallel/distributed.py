"""Multi-process execution on torch.distributed.

The counterpart of ``nmc_tpu/parallel/distributed.py``. Every process calls
:func:`initialize`, which joins one process group; the sharded engines
(`parallel/sharded_pt.py`, `parallel/spin_sharded.py`, the instance-sharded
ensembles) then take a `group=` and split their replicas, spins or
instances over its ranks. They talk only through the helpers below, which
use two collectives, `all_reduce(SUM)` and `broadcast`:

  * `gather_rows`: an all-gather of rows is an `all_reduce` over a
    zero-filled global buffer into which each rank writes its own rows,
    exact since x + 0 = x;
  * `sum_`, `broadcast_`: in place over a group.

NCCL takes CUDA tensors for every collective and gloo takes them for these
two, so the same code runs over NCCL on one card per rank and over gloo
with several ranks sharing one card (NCCL refuses two ranks on one
device). A backend that refuses a tensor raises; nothing falls back.

Launch, one process per card (or per rank):

    torchrun --nproc-per-node W -m nmc_tpu_torch sharded ...

    NMC_TPU_COORDINATOR=host0:8476 NMC_TPU_NUM_PROCESSES=2 \\
    NMC_TPU_PROCESS_ID=0 python -m nmc_tpu_torch sharded ...   # on host 0
    NMC_TPU_COORDINATOR=host0:8476 NMC_TPU_NUM_PROCESSES=2 \\
    NMC_TPU_PROCESS_ID=1 python -m nmc_tpu_torch sharded ...   # on host 1

With neither set, :func:`initialize` is a no-op and everything runs at
world size 1.

Every `group` argument here and in the engines means one thing: a process
group to work over, or None for none, this process alone (world size 1,
rank 0, every collective a no-op). An engine is sharded exactly when it is
given a group; `global_group()` is the default group (every rank), None
outside one. `rank()` and `world_size()` are this process's place in the
default group, JAX's `process_index` / `process_count`.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import default_device


def default_backend() -> str:
    """NCCL for CUDA tensors and gloo for CPU tensors where torch sees a
    card; gloo alone where it sees none."""
    return "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Join the default process group; returns True when distributed.

    Arguments fall back to NMC_TPU_COORDINATOR (host:port) /
    NMC_TPU_NUM_PROCESSES / NMC_TPU_PROCESS_ID, then to torchrun's
    MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE; with none of them set
    this is a no-op and returns False. A second call is ignored. On a
    machine with cards each process first takes `rank_device()` as its
    current card."""
    if dist.is_available() and dist.is_initialized():
        return True
    env = os.environ
    coordinator_address = coordinator_address or env.get(
        "NMC_TPU_COORDINATOR")
    if num_processes is None and "NMC_TPU_NUM_PROCESSES" in env:
        num_processes = int(env["NMC_TPU_NUM_PROCESSES"])
    if process_id is None and "NMC_TPU_PROCESS_ID" in env:
        process_id = int(env["NMC_TPU_PROCESS_ID"])
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and "
                             "process_id (NMC_TPU_NUM_PROCESSES, "
                             "NMC_TPU_PROCESS_ID)")
        init = dict(init_method=f"tcp://{coordinator_address}",
                    world_size=num_processes, rank=process_id)
    elif all(k in env for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                                "WORLD_SIZE")):
        init = dict(init_method="env://", world_size=int(env["WORLD_SIZE"]),
                    rank=int(env["RANK"]))
    else:
        return False
    if torch.cuda.is_available():
        torch.cuda.set_device(_local_index(init["rank"]))
    dist.init_process_group(backend or default_backend(), **init)
    return True


def initialize_from_env() -> bool:
    """CLI hook: join the process group iff the launch variables are set."""
    return initialize()


def is_multiprocess() -> bool:
    return world_size() > 1


def rank() -> int:
    """This process's rank in the default group; 0 outside one."""
    return group_shape(global_group())[1]


def world_size() -> int:
    """The ranks of the default group; 1 outside one."""
    return group_shape(global_group())[0]


def group_shape(group=None) -> tuple:
    """(ranks, this process's rank) of `group`; (1, 0) for None."""
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _local_index(global_rank: int) -> int:
    local = int(os.environ.get("LOCAL_RANK", global_rank))
    return local % torch.cuda.device_count()


def rank_device(device=None) -> torch.device:
    """The card of this rank, cuda:{LOCAL_RANK % device_count} (the global
    rank where LOCAL_RANK is unset); raises without a card unless the caller
    names the CPU (`device="cpu"`), which is returned as is."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    default_device()
    return torch.device("cuda", _local_index(rank()))


def global_group():
    """The default process group (every rank), or None outside one: the
    counterpart of `global_mesh`."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def instance_shard(total: int, group=None):
    """(offset, count) of this rank's instances of `total` over `group`:
    the largest rank count that divides `total` (JAX's rule for a mesh)
    takes total / shards each in rank order; the ranks past it hold none.
    With no group, (0, total)."""
    W, k = group_shape(group)
    shards = W
    while total % shards:
        shards -= 1
    per = total // shards
    return (k * per, per) if k < shards else (total, 0)


def grid_groups(rows: int, group=None):
    """A rows x (W / rows) grid of the ranks of `group`, rank k at row
    k // cols, column k % cols as JAX reshapes a mesh: (row group, column
    group, row, column), the row group holding the ranks of this rank's row
    and the column group those of its column. Every rank builds every
    group (`torch.distributed.new_group` is collective); at world 1 both
    groups are None."""
    W, k = group_shape(group)
    if W % rows:
        raise ValueError(f"{W} ranks do not split into {rows} rows")
    cols = W // rows
    if W == 1:
        return None, None, 0, 0
    glob = [dist.get_global_rank(group, r) for r in range(W)]
    row_g = col_g = None
    for r in range(rows):
        sub = dist.new_group([glob[r * cols + c] for c in range(cols)])
        if r == k // cols:
            row_g = sub
    for c in range(cols):
        sub = dist.new_group([glob[r * cols + c] for r in range(rows)])
        if c == k % cols:
            col_g = sub
    return row_g, col_g, k // cols, k % cols


def _reduce_view(x: torch.Tensor):
    """(tensor to reduce, dtype to cast back to): bool rides as uint8."""
    if x.dtype == torch.bool:
        return x.to(torch.uint8), torch.bool
    return x, None


def sum_(x: torch.Tensor, group=None) -> torch.Tensor:
    """all_reduce(SUM) of `x` in place over `group`; a no-op at world 1."""
    if group_shape(group)[0] > 1:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def broadcast_(x: torch.Tensor, src: int = 0,
               group=None) -> torch.Tensor:
    """`x` of group rank `src` in place on every rank of `group`."""
    if group_shape(group)[0] > 1:
        dist.broadcast(x, src=dist.get_global_rank(group, src), group=group)
    return x


def gather_rows(x: torch.Tensor, offset: int, total: int,
                group=None) -> torch.Tensor:
    """Rows [offset, offset + len(x)) of a [total, ...] tensor held across
    `group`, gathered on every rank: each rank writes its rows into a
    zero-filled buffer and the buffers are summed (x + 0 = x)."""
    y, back = _reduce_view(x)
    buf = torch.zeros((total,) + tuple(y.shape[1:]), dtype=y.dtype,
                      device=y.device)
    buf[offset:offset + y.shape[0]] = y
    sum_(buf, group)
    return buf if back is None else buf.to(back)


def host_gather(x: torch.Tensor, group=None) -> np.ndarray:
    """A row-sharded tensor gathered on every rank of `group` as numpy, the
    ranks' rows in rank order (any row counts, a rank may hold none); with
    no group, the rows as they are."""
    W, k = group_shape(group)
    if W == 1:
        return x.detach().cpu().numpy()
    counts = torch.zeros(W, dtype=torch.int64, device=x.device)
    counts[k] = x.shape[0]
    counts = sum_(counts, group).tolist()
    offset = sum(counts[:k])
    return gather_rows(x, offset, sum(counts), group).cpu().numpy()
