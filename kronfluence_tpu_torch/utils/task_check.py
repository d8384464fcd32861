"""Task-configuration checks on a probe batch. Port of
`kronfluence_tpu/utils/task_check.py`.

`verify_task_configuration` raises `IllegalTaskConfigurationError` or
`TrackedModuleNotFoundError` before any expensive stage runs:

  * the train loss and the measurement must be scalars;
  * the train loss must be summed over the batch, not averaged: a batch
    duplicated along its first axis exactly doubles a summed loss and leaves
    an averaged one where it was;
  * an attention mask must match the token rows of some tracked linear
    module, since a mis-sized mask would be silently ignored;
  * a dict attention mask may only name tracked modules;
  * the names `get_influence_tracked_modules` returns must exist.
"""

from typing import Any

import torch

from kronfluence_tpu_torch.capture.engine import discover
from kronfluence_tpu_torch.utils.exceptions import (
    IllegalTaskConfigurationError,
    TrackedModuleNotFoundError,
)


def _duplicate_batch(batch: Any) -> Any:
    if isinstance(batch, dict):
        return {k: _duplicate_batch(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_duplicate_batch(v) for v in batch)
    if isinstance(batch, torch.Tensor) and batch.ndim >= 1:
        return torch.cat([batch, batch], dim=0)
    return batch


def _check_scalar(value: Any, what: str) -> None:
    if not isinstance(value, torch.Tensor) or value.ndim != 0:
        shape = tuple(value.shape) if isinstance(value, torch.Tensor) else type(value).__name__
        raise IllegalTaskConfigurationError(
            f"{what} must return a scalar tensor (summed over the batch); got {shape}. "
            "Sum per-sample values, e.g. `torch.sum(losses)`."
        )


@torch.no_grad()
def verify_task_configuration(model: Any, task: Any, batch: Any, rtol: float = 1e-3) -> None:
    """Validates a (PreparedModel, task) pair on one probe batch; raises on
    misuse. Three forward passes, no backward."""
    module = model.module
    loss_1 = task.compute_train_loss(batch, module)
    _check_scalar(loss_1, "compute_train_loss")
    _check_scalar(task.compute_measurement(batch, module), "compute_measurement")

    loss_1 = float(loss_1)
    loss_2 = float(task.compute_train_loss(_duplicate_batch(batch), module))
    if abs(loss_2 - 2.0 * loss_1) > rtol * max(abs(2.0 * loss_1), 1e-8):
        hint = (
            "it stays constant under batch duplication, which indicates a mean-reduced loss"
            if abs(loss_2 - loss_1) <= rtol * max(abs(loss_1), 1e-8)
            else "it does not double under batch duplication"
        )
        raise IllegalTaskConfigurationError(
            f"compute_train_loss must be SUMMED over the batch: {hint} "
            f"(loss={loss_1:.6g}, duplicated-batch loss={loss_2:.6g}). Use "
            "`reduction='sum'`-style losses; influence accumulation assumes "
            "per-sample additivity."
        )

    ctx = discover(model, lambda: task.compute_train_loss(batch, module))
    specs, out_shapes = ctx.specs, ctx.output_shapes
    if model.tracked_names is not None:
        missing = sorted(set(model.tracked_names) - set(specs))
        if missing:
            raise TrackedModuleNotFoundError(
                f"get_influence_tracked_modules() names {missing} were never applied in the "
                f"forward pass; found modules: {sorted(specs)}."
            )

    mask = task.get_attention_mask(batch)
    if mask is None:
        return
    linear_rows = {
        name: {int(s[:-1].numel()) for s in shapes}
        for name, shapes in out_shapes.items()
        if specs[name].kind == "linear"
    }
    if isinstance(mask, dict):
        unknown = sorted(set(mask) - set(specs))
        if unknown:
            raise IllegalTaskConfigurationError(
                f"get_attention_mask returned masks for unknown modules {unknown}; "
                f"tracked modules are {sorted(specs)}."
            )
        items = mask.items()
    else:
        items = [(None, mask)]
    for name, m in items:
        size = int(m.numel())
        candidates = (
            linear_rows.get(name, set())
            if name is not None
            else {r for rows in linear_rows.values() for r in rows}
        )
        if candidates and size not in candidates:
            where = f"module {name!r}" if name is not None else "any tracked linear module"
            raise IllegalTaskConfigurationError(
                f"Attention mask with {size} elements does not match the flattened token "
                f"rows of {where} (candidates: {sorted(candidates)}); it would be silently "
                "ignored. Masks must be binary with shape (batch, tokens) matching the "
                "module's activation rows."
            )
