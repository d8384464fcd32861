"""Counterfactual evaluation: the linear datamodeling score (LDS).

Port of `kronfluence_tpu/evaluate.py`. Sample M random train subsets,
retrain on each, and rank-correlate the predicted effect of each subset (the
sum of its influence scores) with the measured one (the query measurement of
the retrained model). The retraining harness takes user callables
(`train_fn`, `measure_fn`), so any model and optimizer works.

Host math in float64 with numpy: score tensors are accepted wherever they
live (an explicit `.cpu()` copy), and the masks come from numpy's
`default_rng(seed)`, so both packages draw the same masks for a seed.
"""

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch


def _host(x: Any) -> np.ndarray:
    """float64 numpy copy of an array or a tensor on any device."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().to(torch.float64).numpy()
    return np.asarray(x, np.float64)


def sample_subset_masks(
    train_size: int,
    num_subsets: int,
    subset_fraction: float = 0.5,
    seed: int = 0,
) -> np.ndarray:
    """(num_subsets, train_size) boolean masks, each keeping ~fraction rows."""
    rng = np.random.default_rng(seed)
    keep = int(round(subset_fraction * train_size))
    masks = np.zeros((num_subsets, train_size), dtype=bool)
    for j in range(num_subsets):
        masks[j, rng.choice(train_size, size=keep, replace=False)] = True
    return masks


def _rankdata(x: np.ndarray) -> np.ndarray:
    """Ranks along the last axis of a 2-D array, ties given their average."""
    order = np.argsort(x, axis=-1, kind="stable")
    sorted_x = np.take_along_axis(x, order, axis=-1)
    ranks = np.empty_like(x, dtype=np.float64)
    n = x.shape[-1]
    for row in range(x.shape[0]):
        i = 0
        while i < n:
            j = i
            while j + 1 < n and sorted_x[row, j + 1] == sorted_x[row, i]:
                j += 1
            ranks[row, order[row, i : j + 1]] = 0.5 * (i + j)
            i = j + 1
    return ranks


def spearman_correlation(pred: Any, actual: Any) -> np.ndarray:
    """Row-wise Spearman rank correlation of (Q, M) against (Q, M)."""
    rp = _rankdata(np.atleast_2d(_host(pred)))
    ra = _rankdata(np.atleast_2d(_host(actual)))
    rp = rp - rp.mean(axis=-1, keepdims=True)
    ra = ra - ra.mean(axis=-1, keepdims=True)
    denom = np.sqrt((rp**2).sum(-1) * (ra**2).sum(-1))
    denom = np.where(denom == 0, 1.0, denom)
    return (rp * ra).sum(-1) / denom


def linear_datamodeling_score(
    scores: Any,
    subset_measurements: Any,
    subset_masks: Any,
) -> Tuple[float, np.ndarray]:
    """LDS from pairwise scores and retrain measurements.

    Args:
        scores: (Q, N) pairwise influence scores (query x train), a tensor on
            any device or an array.
        subset_measurements: (M, Q) measured query outcomes of the model
            retrained on each subset.
        subset_masks: (M, N) boolean subset membership.

    Returns:
        (mean LDS, per-query LDS (Q,)): the Spearman correlation between the
        subset-summed scores and the retrained measurements, per query.

    Raises:
        ValueError: when the measurements and the masks count other subsets.
    """
    scores = _host(scores)
    masks = _host(subset_masks)
    measurements = _host(subset_measurements)
    if measurements.shape[0] != masks.shape[0]:
        raise ValueError(
            f"subset_measurements has {measurements.shape[0]} rows but subset_masks "
            f"{masks.shape[0]}: one measurement row per subset mask is required."
        )
    predicted = scores @ masks.T  # (Q, M)
    per_query = spearman_correlation(predicted, measurements.T)
    return float(per_query.mean()), per_query


def collect_subset_measurements(
    train_fn: Callable[[np.ndarray, int], Any],
    measure_fn: Callable[[Any], Any],
    masks: np.ndarray,
    seed: int = 0,
) -> np.ndarray:
    """Retrains on every subset mask and measures each model: an (M, Q)
    float64 matrix. Independent of any score matrix: compute it once and
    evaluate any number of strategies against it through
    `evaluate_lds(..., measurements=...)`."""
    measurements = []
    for j in range(masks.shape[0]):
        idx = np.nonzero(masks[j])[0]
        state = train_fn(idx, seed + j)
        measurements.append(_host(measure_fn(state)))
    return np.stack(measurements)


def evaluate_lds(
    scores: Any,
    train_fn: Callable[[np.ndarray, int], Any],
    measure_fn: Callable[[Any], Any],
    train_size: int,
    num_subsets: int = 64,
    subset_fraction: float = 0.5,
    seed: int = 0,
    masks: Optional[np.ndarray] = None,
    measurements: Optional[Any] = None,
) -> Tuple[float, np.ndarray]:
    """The whole harness: masks, retrains, LDS.

    Args:
        scores: (Q, N) pairwise influence scores.
        train_fn: `(subset_indices, seed) -> model_state` retrains on a subset.
        measure_fn: `model_state -> (Q,)` per-query measurements.
        train_size: N.
        num_subsets / subset_fraction / seed: the subset sampling.
        masks: optional precomputed (M, N) masks.
        measurements: optional precomputed (M, Q) matrix from
            `collect_subset_measurements`, one row per mask; skips the
            retrains.

    Returns:
        (mean LDS, per-query LDS).
    """
    if masks is None:
        masks = sample_subset_masks(train_size, num_subsets, subset_fraction, seed)
    if measurements is None:
        measurements = collect_subset_measurements(train_fn, measure_fn, masks, seed)
    return linear_datamodeling_score(scores, measurements, masks)
