"""Batching with a valid mask, and index partitions.

Port of the batching core of `kronfluence_tpu/utils/dataset.py`. Every batch
has exactly `batch_size` rows: the last one is padded by repeating the first
row of its range with `valid = 0`, and every statistic downstream masks the
padded rows exactly (ops/flatten.py). Datasets are column stores: a dict of
equal-length numpy arrays or torch tensors. Batches are dicts of tensors on
the loader's `device` (the card unless the caller names another); a store whose columns already live on that device is
sliced there.
"""

import math
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch


def make_indices_partition(
    total_data_examples: int,
    partition_size: int,
    target_data_partitions: Optional[Sequence[int]] = None,
) -> List[Tuple[int, int]]:
    """Splits [0, total) into `partition_size` contiguous (start, end) ranges."""
    if partition_size > total_data_examples:
        raise ValueError("Partition size cannot exceed the number of examples.")
    bins = np.array_split(np.arange(total_data_examples), partition_size)
    ranges = [(int(b[0]), int(b[-1]) + 1) for b in bins]
    if target_data_partitions is not None:
        ranges = [ranges[i] for i in target_data_partitions]
    return ranges


def _as_column(value: Any) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    return torch.from_numpy(np.ascontiguousarray(np.asarray(value)))


class BatchLoader:
    """Yields fixed-shape (batch, valid) pairs over an index range."""

    def __init__(
        self,
        dataset: Dict[str, Any],
        batch_size: int,
        indices: Optional[Sequence[int]] = None,
        device=None,
    ) -> None:
        if not isinstance(dataset, dict) or not dataset:
            raise TypeError("BatchLoader takes a column store: a dict of equal-length arrays.")
        self.columns = {name: _as_column(col) for name, col in dataset.items()}
        lengths = {len(col) for col in self.columns.values()}
        if len(lengths) != 1:
            raise ValueError(f"Columns differ in length: {sorted(lengths)}.")
        self.batch_size = int(batch_size)
        if self.batch_size <= 0:
            raise ValueError("batch_size must be positive.")
        if indices is None:
            indices = np.arange(lengths.pop())
        self.indices = np.asarray(indices, dtype=np.int64)
        self.device = torch.device("cuda" if device is None else device)

    def __len__(self) -> int:
        return math.ceil(len(self.indices) / self.batch_size)

    @property
    def num_examples(self) -> int:
        return len(self.indices)

    def __iter__(self) -> Iterator[Tuple[Dict[str, torch.Tensor], torch.Tensor]]:
        n = self.num_examples
        for start in range(0, n, self.batch_size):
            chunk = self.indices[start : start + self.batch_size]
            valid = torch.ones(self.batch_size, dtype=torch.float32)
            if len(chunk) < self.batch_size:
                valid[len(chunk) :] = 0.0
                pad = np.full(self.batch_size - len(chunk), chunk[0], dtype=np.int64)
                chunk = np.concatenate([chunk, pad])
            index = torch.from_numpy(chunk)
            batch = {
                name: col[index.to(col.device)].to(self.device, non_blocking=True)
                for name, col in self.columns.items()
            }
            yield batch, valid.to(self.device)

    def probe(self) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """First (batch, valid) pair, for shape and module discovery."""
        return next(iter(self))


def probe_first(loader: Any) -> Tuple[Any, Any]:
    """First (batch, valid) of any loader, through its `probe()` when it has one."""
    if hasattr(loader, "probe"):
        return loader.probe()
    return next(iter(loader))
