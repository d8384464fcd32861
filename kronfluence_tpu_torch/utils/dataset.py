"""Batching with a valid mask, index partitions, loader knobs, progress and
dataset metadata.

Port of `kronfluence_tpu/utils/dataset.py`. Every batch
has exactly `batch_size` rows: the last one is padded by repeating the first
row of its range with `valid = 0`, and every statistic downstream masks the
padded rows exactly (ops/flatten.py). Datasets are column stores: a dict of
equal-length numpy arrays or torch tensors. Batches are dicts of tensors on
the loader's `device` (the card unless the caller names another); a store whose columns already live on that device is
sliced there.
"""

import dataclasses
import logging
import math
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class DataLoaderKwargs:
    """Loader knobs, the JAX package's fields. The column-store loader
    honours none of them: `pin_memory`, `persistent_workers` and
    `prefetch_factor` are accepted and have no effect; `collate_fn`,
    `num_workers > 0` and `drop_last` raise NotImplementedError (ROADMAP
    Queue 1, remaining stage options)."""

    num_workers: int = 0
    collate_fn: Optional[Any] = None
    pin_memory: bool = False
    drop_last: bool = False
    prefetch_factor: Optional[int] = None
    persistent_workers: bool = False

    def check_ported(self) -> None:
        unported = {
            "collate_fn": self.collate_fn is not None,
            "num_workers": self.num_workers > 0,
            "drop_last": self.drop_last,
        }
        for name, is_set in unported.items():
            if is_set:
                raise NotImplementedError(
                    f"DataLoaderKwargs.{name} is not ported yet: the column-store BatchLoader "
                    "has no such knob (ROADMAP Queue 1, remaining stage options)."
                )


def dataset_length(dataset: Dict[str, Any]) -> int:
    """Examples in a column store (the length of its first column)."""
    return len(next(iter(dataset.values())))


def dataset_metadata(dataset: Any, indices: Optional[Sequence[int]] = None) -> Dict[str, Any]:
    """Dataset fingerprint persisted next to artifacts, as the JAX package writes it."""
    return {
        "type": type(dataset).__name__,
        "dataset_size": dataset_length(dataset),
        "indices": list(map(int, indices)) if indices is not None else None,
    }


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
        dataloader_kwargs: Optional[DataLoaderKwargs] = None,
    ) -> None:
        (dataloader_kwargs or DataLoaderKwargs()).check_ported()
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


class ProgressLoader:
    """Loader wrapper that reports each pass's progress through a logger at
    INFO level (about every tenth of the batches, and at the end); every
    other attribute is the wrapped loader's."""

    def __init__(
        self, loader: Any, logger: logging.Logger, desc: str = "Batches", disable: bool = False
    ) -> None:
        self._loader = loader
        self._logger = logger
        self._desc = desc
        self._disable = disable

    def __getattr__(self, name: str) -> Any:
        return getattr(self._loader, name)

    def __len__(self) -> int:
        return len(self._loader)

    def probe(self):
        return probe_first(self._loader)

    def __iter__(self):
        if self._disable:
            yield from self._loader
            return
        total = len(self._loader)
        every = max(1, total // 10)
        start = time.perf_counter()
        for done, item in enumerate(self._loader, start=1):
            yield item
            if done % every == 0 or done == total:
                elapsed = time.perf_counter() - start
                left = elapsed / done * (total - done)
                self._logger.info(
                    f"{self._desc}: {done}/{total} [time left: {left:.1f} s, "
                    f"time spent: {elapsed:.1f} s]"
                )


def probe_first(loader: Any) -> Tuple[Any, Any]:
    """First (batch, valid) of any loader, through its `probe()` when it has one."""
    if hasattr(loader, "probe"):
        return loader.probe()
    return next(iter(loader))
