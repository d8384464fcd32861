"""The data mesh and the collectives the stage drivers use.

Port of `kronfluence_tpu/parallel/mesh.py` for processes joined by
`torch.distributed`. A `Mesh` is the data axis (every rank of the default
group, each holding the whole model and its own rows of every global batch),
the group and this rank's device. Where the JAX package writes stage math in
global view and lets XLA insert the reductions, the port's drivers sum their
rank's rows and then call, once a stage:

  * `all_reduce_tree`: every tensor of a nested dict summed over the ranks, in
    place (factor sums and counts, summed gradients);
  * `gather_rows`: per-rank rows assembled in global row order on every rank
    (preconditioned query gradients, score columns);
  * `agree_min`, `agree_flag`: one integer, or rank 0's decision, that all
    ranks take (a batch size; a skip).

They are built on `all_reduce` and `broadcast` alone (the barrier is
`distributed.sync_global_devices`), so the same code runs on NCCL and on
gloo with CUDA tensors. Tensors travel as their raw bytes where no
reduction is needed, so any dtype (float8 among them) does.

The model axis (FSDP-style parameter and factor sharding: the JAX package's
`shard_params_fsdp` and `factor_sharding`) is not ported: `make_mesh` refuses
`model > 1` (ROADMAP Queue 1 item 5b).
"""

import dataclasses
from typing import Any, Optional, Union

import torch
import torch.distributed as dist

from kronfluence_tpu_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis: `data` ranks, this process's `rank` among them, their
    process `group` (the default group, whose ranks are the mesh's; None
    when the process is alone) and this rank's `device`, where the model and
    every tensor a stage makes live."""

    data: int
    rank: int
    group: Any
    device: torch.device

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)


def make_mesh(
    data: Optional[int] = None,
    model: int = 1,
    device: Optional[Union[str, torch.device]] = None,
) -> Mesh:
    """A data mesh over every process of the default group (one rank when
    there is none). `data` defaults to, and must equal, the world size. The
    device is `cuda:<local rank>` unless the caller names one."""
    if model < 1:
        raise ValueError(f"The model axis must be at least 1; got {model}.")
    if model > 1:
        raise NotImplementedError(
            "The model axis (FSDP-style parameter and factor sharding) is not ported yet "
            "(ROADMAP Queue 1 item 5b); use make_mesh(data=world_size, model=1)."
        )
    world = distributed.num_processes()
    data = world if data is None else int(data)
    if data * model != world:
        raise ValueError(f"Mesh {data}x{model} does not match {world} processes.")
    if device is None:
        device = torch.device("cuda", distributed.local_rank())
    group = dist.group.WORLD if dist.is_initialized() else None
    return Mesh(data=data, rank=distributed.process_index(), group=group,
                device=torch.device(device))


def data_axis_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.data


def check_loader(mesh: Optional[Mesh], loader: Any) -> None:
    """A stage on a mesh reads each rank's rows from a loader on the same
    mesh, and a stage without one from a loader without one: either mix-up
    would count rows twice or reduce nothing."""
    if getattr(loader, "mesh", None) != mesh:
        raise ValueError(
            "The loader's mesh differs from the stage's: build the loader with "
            "`BatchLoader(..., mesh=mesh)` for the mesh the stage is given."
        )


def _collective(mesh: Optional[Mesh]) -> bool:
    """Whether the mesh has a group to talk over (a one-rank group does: its
    collectives run, so a world of one exercises the same calls)."""
    return mesh is not None and mesh.group is not None


def all_reduce_tree(mesh: Optional[Mesh], tree: Any) -> Any:
    """Sums every tensor of a nested dict over the mesh's ranks, in place,
    and returns the tree. Floating tensors narrower than fp32 are summed in
    fp32 and rounded back once; the stage drivers hand over their
    accumulation dtypes, so this is the rare case."""
    if not _collective(mesh):
        return tree
    for tensor in _leaves(tree):
        if tensor.is_floating_point() and tensor.element_size() < 4:
            wide = tensor.to(torch.float32)
            dist.all_reduce(wide, group=mesh.group)
            tensor.copy_(wide)
        else:
            dist.all_reduce(tensor, group=mesh.group)
    return tree


def _leaves(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    else:
        raise TypeError(f"Cannot reduce a {type(tree).__name__}.")


def broadcast_bytes(mesh: Mesh, tensor: torch.Tensor, src: int) -> torch.Tensor:
    """Rank `src`'s `tensor` on every rank: sent as its raw bytes, so any
    dtype travels. Every rank passes a tensor of the same shape and dtype
    (only `src`'s contents matter); the result is on that tensor's device."""
    flat = tensor.detach().contiguous().reshape(-1)
    if mesh.rank == src:
        payload = flat.view(torch.uint8)
    else:
        payload = torch.empty(flat.numel() * flat.element_size(), dtype=torch.uint8,
                              device=flat.device)
    dist.broadcast(payload, src=src, group=mesh.group)
    return payload.view(tensor.dtype).reshape(tensor.shape)


def gather_rows(
    mesh: Optional[Mesh], tensor: torch.Tensor, dim: int = 0, batches: int = 1
) -> torch.Tensor:
    """Assembles per-rank rows in global order on every rank.

    Along `dim`, each rank's `tensor` holds its slice of `batches` global
    batches, batch after batch (`batches x per` rows, the same count on every
    rank); the result holds `batches x ranks x per` rows, batch after batch,
    each batch's rows in rank order: the order of a single-process loader."""
    if not _collective(mesh):
        return tensor
    pieces = [broadcast_bytes(mesh, tensor, src) for src in range(mesh.data)]
    dim = dim % tensor.dim()
    shape = tuple(tensor.shape)
    rows = shape[dim]
    if rows % batches:
        raise ValueError(f"{rows} rows do not split into {batches} batches.")
    per = rows // batches
    stacked = torch.stack(pieces, dim=dim)  # (..., ranks, batches * per, ...)
    stacked = stacked.reshape(shape[:dim] + (mesh.data, batches, per) + shape[dim + 1:])
    ordered = stacked.transpose(dim, dim + 1)  # (..., batches, ranks, per, ...)
    return ordered.reshape(shape[:dim] + (batches * mesh.data * per,) + shape[dim + 1:])


def agree_min(mesh: Optional[Mesh], value: int) -> int:
    """The least of every rank's `value`, on every rank."""
    if not _collective(mesh):
        return value
    held = torch.tensor([int(value)], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(held, op=dist.ReduceOp.MIN, group=mesh.group)
    return int(held.item())


def agree_flag(mesh: Optional[Mesh], flag: bool) -> bool:
    """Rank 0's `flag` on every rank, so that a decision (skip a stage whose
    artifact exists) is taken the same way everywhere."""
    if not _collective(mesh):
        return flag
    held = torch.tensor([int(bool(flag))], dtype=torch.int64, device=mesh.device)
    dist.broadcast(held, src=0, group=mesh.group)
    return bool(held.item())

