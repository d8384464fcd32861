"""Batching with a valid mask, index partitions, loader knobs, progress and
dataset metadata.

Port of `kronfluence_tpu/utils/dataset.py`. Every batch has exactly
`batch_size` rows: the last one is padded by repeating the first row of its
range with `valid = 0` (or dropped with `drop_last`), and every statistic
downstream masks the padded rows exactly (ops/flatten.py). Datasets are
column stores (a dict of equal-length numpy arrays or torch tensors) or any
indexable of example rows (dicts, tuples or arrays of numpy arrays, tensors
or numbers), stacked leaf by leaf or handed to `collate_fn`. Batches are
trees of tensors on the loader's `device` (the card unless the caller names
another); a column store whose columns already live on that device is
sliced there. Given a data mesh (`parallel/mesh.py`), each rank gets its
contiguous slice of every global batch, with the matching slice of `valid`
(the slice of a final batch may be all padding); `batch_size` is the global
batch and must split evenly over the ranks.
"""

import dataclasses
import logging
import math
import queue
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class DataLoaderKwargs:
    """Loader knobs, the JAX package's fields and meanings:

    * `collate_fn`: applied to the list of example rows to build a batch
      (the default stacks each leaf);
    * `num_workers` / `prefetch_factor`: with `num_workers > 0` a daemon
      thread keeps `prefetch_factor or 2` batches ready ahead of the stage
      loop, and re-raises its exception in the consumer;
    * `drop_last`: drops the final partial batch instead of padding it;
    * `pin_memory` / `persistent_workers`: accepted and ignored.
    """

    num_workers: int = 0
    collate_fn: Optional[Any] = None
    pin_memory: bool = False
    drop_last: bool = False
    prefetch_factor: Optional[int] = None
    persistent_workers: bool = False


def _is_column_store(dataset: Any) -> bool:
    return isinstance(dataset, dict) and all(hasattr(v, "__len__") for v in dataset.values())


def dataset_length(dataset: Any) -> int:
    """Examples in a dataset: the length of a column store's first column,
    else `len(dataset)`."""
    if _is_column_store(dataset):
        return len(next(iter(dataset.values())))
    return len(dataset)


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


def _as_tensor(value: Any) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    return torch.from_numpy(np.ascontiguousarray(np.asarray(value)))


def _collate(rows: List[Any]) -> Any:
    """Stacks example rows leaf by leaf (dicts and tuples of leaves)."""
    first = rows[0]
    if isinstance(first, dict):
        return {k: _collate([r[k] for r in rows]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_collate([r[i] for r in rows]) for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        return torch.stack(rows)
    return _as_tensor(np.stack([np.asarray(r) for r in rows]))


def _to_device(tree: Any, device: torch.device) -> Any:
    """A batch tree with every array leaf as a tensor on `device`."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_device(v, device) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic, int, float, bool)):
        return _as_tensor(tree).to(device, non_blocking=True)
    return tree


class BatchLoader:
    """Yields fixed-shape (batch, valid) pairs over an index range."""

    def __init__(
        self,
        dataset: Any,
        batch_size: int,
        indices: Optional[Sequence[int]] = None,
        device=None,
        dataloader_kwargs: Optional[DataLoaderKwargs] = None,
        mesh=None,
    ) -> None:
        self.dataset = dataset
        self.dataloader_kwargs = dataloader_kwargs or DataLoaderKwargs()
        self.columns = None
        if _is_column_store(dataset):
            if not dataset:
                raise TypeError("A column store needs at least one column.")
            self.columns = {name: _as_tensor(col) for name, col in dataset.items()}
            lengths = {len(col) for col in self.columns.values()}
            if len(lengths) != 1:
                raise ValueError(f"Columns differ in length: {sorted(lengths)}.")
        self.batch_size = int(batch_size)
        if self.batch_size <= 0:
            raise ValueError("batch_size must be positive.")
        self.mesh = mesh
        ranks = 1 if mesh is None else mesh.data
        if self.batch_size % ranks:
            # The JAX package drops the remainder rows of every batch here
            # (`per = batch_size // procs`); the port refuses instead.
            raise ValueError(
                f"The global batch size {self.batch_size} does not split evenly over the "
                f"mesh's {ranks} ranks."
            )
        # This rank's rows of every batch.
        self.local_batch_size = self.batch_size // ranks
        if indices is None:
            indices = np.arange(dataset_length(dataset))
        self.indices = np.asarray(indices, dtype=np.int64)
        self.device = torch.device("cuda" if device is None else device)

    def __len__(self) -> int:
        n = len(self.indices)
        if self.dataloader_kwargs.drop_last:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)

    @property
    def num_examples(self) -> int:
        if self.dataloader_kwargs.drop_last:
            return (len(self.indices) // self.batch_size) * self.batch_size
        return len(self.indices)

    def _materialize(self, chunk: np.ndarray) -> Any:
        collate = self.dataloader_kwargs.collate_fn
        if collate is not None:
            return _to_device(collate([self.dataset[int(i)] for i in chunk]), self.device)
        if self.columns is not None:
            index = torch.from_numpy(chunk)
            return {
                name: col[index.to(col.device)].to(self.device, non_blocking=True)
                for name, col in self.columns.items()
            }
        return _to_device(_collate([self.dataset[int(i)] for i in chunk]), self.device)

    def _batches(self) -> Iterator[Tuple[Any, torch.Tensor]]:
        for start in range(0, self.num_examples, self.batch_size):
            chunk = self.indices[start : start + self.batch_size]
            valid = torch.ones(self.batch_size, dtype=torch.float32)
            if len(chunk) < self.batch_size:
                valid[len(chunk) :] = 0.0
                pad = np.full(self.batch_size - len(chunk), chunk[0], dtype=np.int64)
                chunk = np.concatenate([chunk, pad])
            if self.mesh is not None:
                rows = slice(self.mesh.rank * self.local_batch_size,
                             (self.mesh.rank + 1) * self.local_batch_size)
                chunk, valid = chunk[rows], valid[rows]
            yield self._materialize(chunk), valid.to(self.device)

    def __iter__(self) -> Iterator[Tuple[Any, torch.Tensor]]:
        kwargs = self.dataloader_kwargs
        if kwargs.num_workers and kwargs.num_workers > 0:
            return _prefetched(self._batches(), kwargs.prefetch_factor or 2)
        return self._batches()

    def probe(self) -> Tuple[Any, torch.Tensor]:
        """First (batch, valid) pair, without a prefetch thread, for shape
        and module discovery."""
        return next(self._batches())


def _prefetched(source: Iterator, depth: int) -> Iterator:
    """Runs `source` in a daemon thread, keeping `depth` items buffered; an
    exception in the thread is raised in the consumer."""
    buffer: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    done = object()

    def worker() -> None:
        try:
            for item in source:
                buffer.put(item)
            buffer.put(done)
        except BaseException as exc:  # re-raised by the consumer below
            buffer.put(exc)

    threading.Thread(target=worker, daemon=True, name="kf-prefetch").start()
    while True:
        item = buffer.get()
        if item is done:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


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
