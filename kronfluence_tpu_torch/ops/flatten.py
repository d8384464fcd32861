"""Flatten rules: raw (activation, output-gradient) pairs to Kronecker form.

Port of `kronfluence_tpu/ops/flatten.py`:

  * linear: leading dims (batch, tokens, ...) collapse into rows; attention
    masks zero padded-token activations; a bias is a ones column.
  * conv2d: im2col by Kh*Kw strided slices; the output positions (b, oh, ow)
    become the rows and the features are channel-major (c, kh, kw), the order
    of `F.unfold`; channel groups are mean-reduced first (the reference's
    rule). torch's conv input and output are NCHW and the JAX package's rules
    NHWC: both are moved to channels-last here, before any reshape. Conv
    layers ignore the attention mask, and their count is rows.

Every rule takes a per-sample `valid` mask that zeroes the padding samples of
a short last batch out of every statistic, with counts taken over valid rows
only.
"""

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

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


def same_pads(
    size: Sequence[int], window: Sequence[int], strides: Sequence[int]
) -> List[Tuple[int, int]]:
    """XLA's "SAME" padding (`jax.lax.padtype_to_pads`) per spatial dim: the
    output is ceil(size / stride), and the total padding it needs is split
    (total // 2, total - total // 2). At stride 2 on an even input that is
    (0, 1) for a 3x3 window, where torch's `padding=1` gives (1, 1)."""
    pads = []
    for n, k, s in zip(size, window, strides):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def conv_pads(
    padding, size: Sequence[int], window: Sequence[int], strides: Sequence[int],
    dilation: Sequence[int],
) -> List[Tuple[int, int]]:
    """Explicit (lo, hi) pads per spatial dim of a "SAME" / "VALID" padding
    or of explicit pairs, for an input of spatial `size`."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0)] * len(size)
        if padding.upper() == "SAME":
            eff = [(k - 1) * d + 1 for k, d in zip(window, dilation)]
            return same_pads(size, eff, strides)
        raise ValueError(f"Unknown padding {padding!r}.")
    return [tuple(p) for p in padding]


def _resolve_conv_pads(spec: LayerSpec, h: int, w: int) -> List[Tuple[int, int]]:
    """Resolves spec.padding to explicit ((lo, hi), (lo, hi)) pairs."""
    return conv_pads(spec.padding, (h, w), spec.kernel_size, spec.strides, spec.kernel_dilation)


def conv2d_shift_windows(x: torch.Tensor, spec: LayerSpec):
    """Kh*Kw strided-slice views of a conv layer's padded input, one per
    kernel offset, each of shape (batch, out_h, out_w, C_in/groups).

    `x` is the layer's NCHW input; the windows are channels-last. Channel
    groups are mean-reduced first. Window `dy * kw + dx` holds, at output
    position p, the input value the kernel tap (dy, dx) reads when producing
    p: column (c, dy, dx) of the im2col matrix."""
    x = x.permute(0, 2, 3, 1)
    b, h, w, c = x.shape
    groups = spec.feature_group_count
    if groups > 1:
        x = x.reshape(b, h, w, groups, c // groups).mean(dim=3)
        c = c // groups
    kh, kw = spec.kernel_size
    sh, sw = spec.strides
    dh, dw = spec.kernel_dilation
    (ph_lo, ph_hi), (pw_lo, pw_hi) = _resolve_conv_pads(spec, h, w)
    xp = F.pad(x, (0, 0, pw_lo, pw_hi, ph_lo, ph_hi))
    hp, wp = xp.shape[1], xp.shape[2]
    out_h = (hp - ((kh - 1) * dh + 1)) // sh + 1
    out_w = (wp - ((kw - 1) * dw + 1)) // sw + 1
    windows = []
    for dy in range(kh):
        for dx in range(kw):
            y0, x0 = dy * dh, dx * dw
            windows.append(
                xp[:, y0 : y0 + (out_h - 1) * sh + 1 : sh, x0 : x0 + (out_w - 1) * sw + 1 : sw]
            )
    return windows, (out_h, out_w, c)


def extract_conv2d_patches(x: torch.Tensor, spec: LayerSpec) -> torch.Tensor:
    """im2col of a conv layer's NCHW input -> (batch, out_h * out_w,
    C_in/groups * Kh * Kw): rows in (b, oh, ow) order, features channel-major
    (c, kh, kw), as `F.unfold` orders them."""
    b = x.shape[0]
    windows, (out_h, out_w, c) = conv2d_shift_windows(x, spec)
    # Stacking on the minor axis builds (b, oh, ow, c, kh*kw): channel-major.
    return torch.stack(windows, dim=-1).reshape(b, out_h * out_w, c * len(windows))


def _to_tokens(spec: LayerSpec, a: torch.Tensor) -> torch.Tensor:
    """Canonicalizes an activation to (batch, tokens, features)."""
    if spec.kind == "conv2d":
        return extract_conv2d_patches(a, spec)
    return a.reshape(a.shape[0], -1, a.shape[-1])


def _grad_to_tokens(spec: LayerSpec, dy: torch.Tensor) -> torch.Tensor:
    """Canonicalizes an output gradient to (batch, tokens, out_dim); a conv
    layer's NCHW gradient goes channels-last first, so that its rows are the
    (b, oh, ow) positions of its patches."""
    if spec.kind == "conv2d":
        dy = dy.permute(0, 2, 3, 1)
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
