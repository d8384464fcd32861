"""Flatten rules for linear layers: raw (activation, output-gradient) pairs to
Kronecker form.

Port of the linear half of `kronfluence_tpu/ops/flatten.py` (the conv rules
wait for the conv path): leading dims (batch, tokens, ...) collapse into rows,
attention masks zero padded-token activations, a bias is a ones column, and a
per-sample `valid` mask zeroes the padding samples of a short last batch out
of every statistic, with counts taken over valid rows only.
"""

import math
from typing import Optional, Tuple

import torch

from kronfluence_tpu_torch.capture.specs import LayerSpec


def _expand_valid(valid: Optional[torch.Tensor], batch: int) -> Optional[torch.Tensor]:
    """Repeats a per-example valid mask onto a batch that folds several rows
    per example (e.g. multiple-choice inputs), in example-major order."""
    if valid is None or valid.shape[0] == batch:
        return valid
    if batch % valid.shape[0] != 0:
        raise ValueError(
            f"valid mask of {valid.shape[0]} samples cannot map onto a module "
            f"batch of {batch} rows."
        )
    return valid.repeat_interleave(batch // valid.shape[0], dim=0)


def _row_mask(
    a_shape: Tuple[int, ...],
    attention_mask: Optional[torch.Tensor],
    valid: Optional[torch.Tensor],
    dtype: torch.dtype,
    use_attention: bool,
) -> Optional[torch.Tensor]:
    """Builds a combined (rows, 1) mask over the flattened leading dims."""
    rows = math.prod(a_shape[:-1])
    mask = None
    if use_attention and attention_mask is not None and attention_mask.numel() == rows:
        mask = attention_mask.reshape(rows, 1).to(dtype)
    if valid is not None:
        batch = a_shape[0]
        valid = _expand_valid(valid, batch)
        v = valid.to(dtype).reshape((batch,) + (1,) * (len(a_shape) - 1))
        v = v.expand(tuple(a_shape[:-1]) + (1,)).reshape(rows, 1)
        mask = v if mask is None else mask * v
    return mask


def _count_from(mask: Optional[torch.Tensor], rows: int, device) -> torch.Tensor:
    if mask is None:
        return torch.tensor(rows, dtype=torch.int64, device=device)
    return mask.to(torch.int64).sum()


def _to_tokens(spec: LayerSpec, a: torch.Tensor) -> torch.Tensor:
    """Canonicalizes an activation to (batch, tokens, features)."""
    if spec.kind != "linear":
        raise NotImplementedError(
            f"{spec.name}: only linear layers are ported; the conv path is ROADMAP "
            "Queue 1, conv path."
        )
    return a.reshape(a.shape[0], -1, a.shape[-1])


def _grad_to_tokens(spec: LayerSpec, dy: torch.Tensor) -> torch.Tensor:
    return dy.reshape(dy.shape[0], -1, dy.shape[-1])


def flatten_activation_parts(
    spec: LayerSpec,
    a: torch.Tensor,
    attention_mask: Optional[torch.Tensor],
    valid: Optional[torch.Tensor],
    dtype: torch.dtype,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Masked (rows, in_dim) activation WITHOUT the bias ones-column, plus the
    (rows, 1) mask (None if unmasked) and the valid-row count. The covariance
    stage adds the bias border analytically (ops/covariance.py
    `bordered_gram`), so the gram operand keeps its aligned width."""
    tokens = _to_tokens(spec, a.to(dtype))
    rows = tokens.shape[0] * tokens.shape[1]
    a2 = tokens.reshape(rows, tokens.shape[-1])
    mask = _row_mask(tuple(tokens.shape), attention_mask, valid, dtype, spec.kind == "linear")
    if mask is not None:
        a2 = a2 * mask
    return a2, mask, _count_from(mask, rows, a.device)


def flatten_gradient(
    spec: LayerSpec,
    dy: torch.Tensor,
    attention_mask: Optional[torch.Tensor],
    valid: Optional[torch.Tensor],
    dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flattens an output gradient: (rows, out_dim), count.

    Gradients are not masked by the attention mask (padded-token gradients
    are zero when the loss ignores them), but rows of padding samples are
    zeroed; the count follows the attention and valid masks.
    """
    tokens = _grad_to_tokens(spec, dy.to(dtype))
    rows = tokens.shape[0] * tokens.shape[1]
    g2 = tokens.reshape(rows, tokens.shape[-1])
    valid_mask = _row_mask(tuple(tokens.shape), None, valid, dtype, use_attention=False)
    if valid_mask is not None:
        g2 = g2 * valid_mask
    count_mask = _row_mask(
        tuple(tokens.shape), attention_mask, valid, dtype, use_attention=spec.kind == "linear"
    )
    return g2, _count_from(count_mask, rows, dy.device)


def activation_tokens_with_bias(spec: LayerSpec, a: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(batch, tokens, in_dim[+1]) activation for per-sample-gradient math (no
    attention masking: padded-token gradients are zero)."""
    tokens = _to_tokens(spec, a.to(dtype))
    if spec.has_bias:
        ones = torch.ones(tokens.shape[:-1] + (1,), dtype=tokens.dtype, device=tokens.device)
        tokens = torch.cat([tokens, ones], dim=-1)
    return tokens


def gradient_tokens(
    spec: LayerSpec, dy: torch.Tensor, valid: Optional[torch.Tensor], dtype: torch.dtype
) -> torch.Tensor:
    """(batch, tokens, out_dim) output gradient, padding samples zeroed."""
    tokens = _grad_to_tokens(spec, dy.to(dtype))
    if valid is not None:
        valid = _expand_valid(valid, tokens.shape[0])
        tokens = tokens * valid.to(dtype)[:, None, None]
    return tokens
