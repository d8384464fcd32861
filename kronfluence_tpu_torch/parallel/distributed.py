"""Multi-process runtime on `torch.distributed`.

Port of `kronfluence_tpu/parallel/distributed.py` in its PyTorch form: one
process per rank, as `torchrun` starts them, each holding the whole model and
its own rows of every global batch (the reference kronfluence under DDP).

  * `initialize()` joins the process group from `torchrun`'s `RANK`,
    `WORLD_SIZE`, `LOCAL_RANK` and `MASTER_ADDR`/`MASTER_PORT`, or from
    explicit arguments (tests pass a `file://` rendezvous). The caller names
    the backend: "nccl" for CUDA, "gloo" for the CPU; nothing picks one on
    its own, and a failed init raises.
  * `num_processes`, `process_index`, `is_main_process`: the group's size
    and this rank (1 and 0 when there is no group).
  * `sync_global_devices(tag)`: a barrier (stage boundaries, artifact writes).
  * `local_batch_slice`: this rank's contiguous rows of a global batch.

The JAX package's `make_global_batch` has no counterpart: a rank's rows stay
on that rank. The stage drivers reduce their sums once at the stage end and
assemble scores in global order (`parallel/mesh.py`). Nothing is initialised
when this module is imported.
"""

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")

# The LOCAL_RANK that `initialize` was given or read; `make_mesh` places the
# rank on `cuda:<local rank>` unless its caller names a device.
_LOCAL_RANK: Optional[int] = None


def initialize(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    local_rank: Optional[int] = None,
    timeout: Optional[datetime.timedelta] = None,
) -> bool:
    """Joins the default process group; returns whether one exists.

    Idempotent: a second call returns at once. A no-op when the process is
    alone: neither `world_size` nor torchrun's `WORLD_SIZE` is set. Otherwise
    `backend` must be named. For "nccl" the rank's card,
    `cuda:<local_rank>`, is made current before the group is created (NCCL
    binds the group to it). `init_method` defaults to "env://"
    (`MASTER_ADDR`/`MASTER_PORT`)."""
    global _LOCAL_RANK
    if dist.is_initialized():
        return True
    env_world = os.environ.get("WORLD_SIZE")
    if world_size is None and env_world is None:
        return False
    if backend not in BACKENDS:
        raise ValueError(
            f"Name the process group's backend: one of {BACKENDS} ('nccl' for CUDA "
            f"tensors, 'gloo' for the CPU); got {backend!r}."
        )
    world_size = int(env_world) if world_size is None else int(world_size)
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size, rank=rank,
        **kwargs,
    )
    _LOCAL_RANK = local_rank
    return True


def shutdown() -> None:
    """Leaves the default process group (a no-op without one)."""
    global _LOCAL_RANK
    if dist.is_initialized():
        dist.destroy_process_group()
    _LOCAL_RANK = None


def local_rank() -> int:
    """The rank's index on its host: what `initialize` was given or read,
    else torchrun's `LOCAL_RANK`, else 0."""
    if _LOCAL_RANK is not None:
        return _LOCAL_RANK
    return int(os.environ.get("LOCAL_RANK", 0))


def num_processes() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


def sync_global_devices(tag: str) -> None:
    """Barrier across all processes (a no-op without a group). `tag` names
    the point for a reader of the code; the barrier does not use it."""
    del tag
    if dist.is_initialized():
        dist.barrier()


def local_batch_slice(global_start: int, global_size: int) -> slice:
    """This process's contiguous slice of a global batch of `global_size`
    rows, which must split evenly over the processes."""
    procs = num_processes()
    if global_size % procs:
        raise ValueError(
            f"A global batch of {global_size} does not split evenly over {procs} processes."
        )
    per = global_size // procs
    start = global_start + process_index() * per
    return slice(start, start + per)
