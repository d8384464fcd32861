"""Data-parallel runtime on torch.distributed (public surface)."""

from kronfluence_tpu_torch.parallel.distributed import (
    initialize,
    is_main_process,
    num_processes,
    process_index,
    shutdown,
    sync_global_devices,
)
from kronfluence_tpu_torch.parallel.mesh import Mesh, data_axis_size, make_mesh

__all__ = [
    "Mesh",
    "data_axis_size",
    "initialize",
    "is_main_process",
    "make_mesh",
    "num_processes",
    "process_index",
    "shutdown",
    "sync_global_devices",
]
