"""The port's BatchLoader against kronfluence_tpu's: the same batches, valid
masks, `len` and `num_examples` for column stores, datasets of rows,
`collate_fn`, the prefetch thread, `drop_last` and index subsets; a worker's
exception reaches the consumer."""

import numpy as np
import pytest
import torch

from kronfluence_tpu.utils.dataset import (
    BatchLoader as JaxBatchLoader,
    DataLoaderKwargs as JaxDataLoaderKwargs,
    dataset_length as jax_dataset_length,
    dataset_metadata as jax_dataset_metadata,
)
from kronfluence_tpu_torch.utils.dataset import (
    BatchLoader,
    DataLoaderKwargs,
    dataset_length,
    dataset_metadata,
)


def _columns(n):
    rng = np.random.default_rng(0)
    return {
        "x": np.arange(n, dtype=np.float64)[:, None] * np.ones((1, 3)),
        "ids": rng.integers(0, 50, size=(n, 4)).astype(np.int32),
    }


def _dict_rows(n):
    cols = _columns(n)
    return [{k: v[i] for k, v in cols.items()} for i in range(n)]


def _tuple_rows(n):
    cols = _columns(n)
    return [(cols["x"][i], cols["ids"][i]) for i in range(n)]


def _array_rows(n):
    return [np.full((2,), float(i)) for i in range(n)]


def _stack_collate(rows):
    return {"doubled": np.stack([r["x"] for r in rows]) * 2.0, "ids": np.stack([r["ids"] for r in rows])}


DATASETS = {"columns": _columns, "dict_rows": _dict_rows, "tuple_rows": _tuple_rows,
            "array_rows": _array_rows}
KNOBS = {
    "none": {},
    "drop_last": {"drop_last": True},
    "prefetch": {"num_workers": 2, "prefetch_factor": 3},
    "prefetch_default_depth": {"num_workers": 1},
    "all": {"num_workers": 2, "drop_last": True, "pin_memory": True, "persistent_workers": True},
}


def _flatten(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _flatten(item)]
    return [tree]


def _assert_same_batches(got_loader, want_loader):
    got, want = list(got_loader), list(want_loader)
    assert len(got) == len(want) == len(got_loader) == len(want_loader)
    assert got_loader.num_examples == want_loader.num_examples
    for (gb, gv), (wb, wv) in zip(got, want):
        assert isinstance(gv, torch.Tensor) and gv.device.type == "cpu"
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        if isinstance(wb, (dict, tuple, list)):
            assert type(gb) is type(wb)
        g_leaves, w_leaves = _flatten(gb), _flatten(wb)
        assert len(g_leaves) == len(w_leaves)
        for g, w in zip(g_leaves, w_leaves):
            assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
            assert g.numpy().dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("knobs", list(KNOBS))
@pytest.mark.parametrize("dataset", list(DATASETS))
@pytest.mark.parametrize("n,batch", [(7, 3), (8, 4)])
def test_batches_match_jax(dataset, knobs, n, batch):
    data = DATASETS[dataset](n)
    got = BatchLoader(data, batch, device="cpu", dataloader_kwargs=DataLoaderKwargs(**KNOBS[knobs]))
    want = JaxBatchLoader(data, batch, dataloader_kwargs=JaxDataLoaderKwargs(**KNOBS[knobs]))
    _assert_same_batches(got, want)


@pytest.mark.parametrize("knobs", ["none", "prefetch", "drop_last"])
def test_collate_fn_matches_jax(knobs):
    rows = _dict_rows(10)
    kw = dict(KNOBS[knobs], collate_fn=_stack_collate)
    got = BatchLoader(rows, 4, device="cpu", dataloader_kwargs=DataLoaderKwargs(**kw))
    want = JaxBatchLoader(rows, 4, dataloader_kwargs=JaxDataLoaderKwargs(**kw))
    _assert_same_batches(got, want)
    batch, _ = next(iter(got))
    np.testing.assert_array_equal(batch["doubled"][:, 0].numpy(), [0.0, 2.0, 4.0, 6.0])


@pytest.mark.parametrize("dataset", ["columns", "dict_rows"])
@pytest.mark.parametrize("drop_last", [False, True])
def test_index_subsets_match_jax(dataset, drop_last):
    data = DATASETS[dataset](10)
    indices = [9, 3, 5, 0, 7]
    kw = {"drop_last": drop_last}
    got = BatchLoader(data, 2, indices=indices, device="cpu",
                      dataloader_kwargs=DataLoaderKwargs(**kw))
    want = JaxBatchLoader(data, 2, indices=indices, dataloader_kwargs=JaxDataLoaderKwargs(**kw))
    _assert_same_batches(got, want)
    kept = [row for b, v in got for row in b["x"][v.bool(), 0].tolist()]
    assert kept == ([9.0, 3.0, 5.0, 0.0] if drop_last else [9.0, 3.0, 5.0, 0.0, 7.0])


def test_drop_last_counts():
    loader = BatchLoader(_columns(7), 3, device="cpu",
                         dataloader_kwargs=DataLoaderKwargs(drop_last=True))
    assert len(loader) == 2 and loader.num_examples == 6
    assert all(bool(v.all()) for _, v in loader)


def test_padding_repeats_the_first_row_of_the_last_range():
    batches = list(BatchLoader(_dict_rows(7), 3, device="cpu"))
    last, valid = batches[-1]
    np.testing.assert_array_equal(valid.numpy(), [1.0, 0.0, 0.0])
    assert torch.equal(last["x"][1], last["x"][0]) and torch.equal(last["x"][2], last["x"][0])


class _Failing:
    """Rows 0..n-1, except that row `bad` raises."""

    def __init__(self, n, bad):
        self.n, self.bad = n, bad

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.bad:
            raise KeyError(f"row {i} is missing")
        return {"x": np.full((2,), float(i))}


@pytest.mark.parametrize("workers", [0, 2])
def test_a_worker_exception_reaches_the_consumer(workers):
    loader = BatchLoader(_Failing(12, 9), 4, device="cpu",
                         dataloader_kwargs=DataLoaderKwargs(num_workers=workers))
    seen = []
    with pytest.raises(KeyError, match="row 9 is missing"):
        for batch, _ in loader:
            seen.append(batch["x"][:, 0].tolist())
    assert seen == [[0.0, 1.0, 2.0, 3.0], [4.0, 5.0, 6.0, 7.0]]


def test_probe_is_the_first_batch_without_a_thread():
    loader = BatchLoader(_dict_rows(9), 4, device="cpu",
                         dataloader_kwargs=DataLoaderKwargs(num_workers=2))
    batch, valid = loader.probe()
    first, first_valid = next(iter(loader))
    assert torch.equal(batch["ids"], first["ids"]) and torch.equal(valid, first_valid)


def test_torch_rows_stack_as_tensors():
    rows = [{"x": torch.full((2,), float(i)), "y": i} for i in range(5)]
    batch, _ = next(iter(BatchLoader(rows, 5, device="cpu")))
    assert torch.equal(batch["x"][:, 0], torch.arange(5, dtype=torch.float32))
    assert batch["y"].tolist() == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("dataset", list(DATASETS))
def test_length_and_metadata_match_jax(dataset):
    data = DATASETS[dataset](6)
    assert dataset_length(data) == jax_dataset_length(data) == 6
    for indices in (None, [4, 1]):
        assert dataset_metadata(data, indices) == jax_dataset_metadata(data, indices)
