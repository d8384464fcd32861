"""Tagged functional layers for models written as plain functions.

Port of `kronfluence_tpu/capture/functional.py`. A model that is a function
of a nested dict of tensors (bound into a module by
`prepare.FunctionalModel`) routes its dense and conv layers through these
ops, which tap the active capture context by name (capture/context.py:tap)
exactly as a hooked `nn.Linear` or `nn.Conv2d` of that name would: the same
LayerSpec, the same recorded input, the same zero probe on the output. The
layouts are PyTorch's: a linear weight is (out, in) as in `F.linear`, a conv
input NCHW and its weight (out, in/groups, kh, kw).

Outside a capture context these are plain ops.
"""

import functools
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from kronfluence_tpu_torch.capture import context
from kronfluence_tpu_torch.capture.engine import recompute_contexts
from kronfluence_tpu_torch.capture.specs import LayerSpec, PaddingSpec, normalize_padding
from kronfluence_tpu_torch.ops.flatten import conv_pads

IntPair = Union[int, Tuple[int, int]]


def _pair(value: IntPair) -> Tuple[int, int]:
    return (value, value) if isinstance(value, int) else tuple(value)


def linear(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    name: str,
) -> torch.Tensor:
    """Tracked dense layer: `F.linear(x, weight, bias)`, weight (out, in)."""
    spec = LayerSpec(
        name=name,
        kind="linear",
        has_bias=bias is not None,
        in_dim=weight.shape[1],
        out_dim=weight.shape[0],
    )
    return context.tap(spec, x, F.linear(x, weight, bias))


def padded_conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    stride: Tuple[int, int],
    padding: PaddingSpec,
    dilation: Tuple[int, int],
    groups: int,
) -> torch.Tensor:
    """`F.conv2d` with flax's padding rules at any stride ("SAME", "VALID"
    or explicit (lo, hi) pairs, which may differ): symmetric pads go to the
    conv call, others to an `F.pad` before it (see `ops/flatten.py:same_pads`:
    "SAME" at stride 2 on an even input pads (0, 1))."""
    (top, bottom), (left, right) = conv_pads(
        padding, x.shape[-2:], weight.shape[-2:], stride, dilation
    )
    if top == bottom and left == right:
        return F.conv2d(x, weight, bias, stride, (top, left), dilation, groups)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, weight, bias, stride, 0, dilation, groups)


def conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    name: str,
    strides: IntPair = 1,
    padding: Union[str, int, Sequence] = "SAME",
    kernel_dilation: IntPair = 1,
    feature_group_count: int = 1,
) -> torch.Tensor:
    """Tracked 2D convolution: NCHW input, weight (out, in/groups, kh, kw);
    the JAX op's argument names and padding forms."""
    strides, kernel_dilation = _pair(strides), _pair(kernel_dilation)
    padding = normalize_padding(padding)
    out_ch, in_per_group, kh, kw = weight.shape
    y = padded_conv2d(x, weight, bias, strides, padding, kernel_dilation, feature_group_count)
    spec = LayerSpec(
        name=name,
        kind="conv2d",
        has_bias=bias is not None,
        in_dim=in_per_group * kh * kw,
        out_dim=out_ch,
        kernel_size=(kh, kw),
        strides=strides,
        padding=padding,
        kernel_dilation=kernel_dilation,
        feature_group_count=feature_group_count,
    )
    return context.tap(spec, x, y)


def _map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _first_leaf(tree: Any) -> torch.Tensor:
    if isinstance(tree, dict):
        return _first_leaf(next(iter(tree.values())))
    if isinstance(tree, (list, tuple)):
        return _first_leaf(tree[0])
    return tree


def _stack(ys: Sequence[Any]) -> Any:
    first = ys[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack([y[k] for y in ys]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([y[i] for y in ys]) for i in range(len(first)))
    return torch.stack(ys)


def scan_layers(
    body_fn: Callable[[Any, Any], Tuple[Any, Any]],
    init: Any,
    xs: Any,
    name_format: str = "layer_{i}",
    remat: bool = False,
) -> Tuple[Any, Any]:
    """`lax.scan` over stacked layer parameters, as a Python loop.

    `body_fn(carry, x) -> (carry, y)` runs once per slice `i` of the leading
    axis of `xs` (a tensor or a nested dict/list of tensors of one length).
    Tagged ops inside it are named `f"{name_format.format(i=i)}/{inner}"`,
    the names an unrolled model gives them (`h_3/mlp/c_fc`), so factors match
    layer for layer. `remat=True` runs each iteration as a
    `checkpoint_block`. Returns `(final carry, stacked ys)` (None where the
    body returns None)."""
    length = _first_leaf(xs).shape[0]
    carry, ys = init, []
    for i in range(length):
        x = _map(lambda a: a[i], xs)
        with context.name_scope(name_format.format(i=i)):
            if remat:
                carry, y = checkpoint_block(body_fn, carry, x)
            else:
                carry, y = body_fn(carry, x)
        ys.append(y)
    return carry, (_stack(ys) if ys else None)


def checkpoint_block(fn: Callable[..., Any], *args: Any) -> Any:
    """Capture-aware gradient checkpointing: `fn(*args)` under torch's
    non-reentrant checkpoint, its intermediates recomputed in the backward
    pass. Inside a capture context the recompute runs under the context's
    recompute (`capture/engine.py:recompute_contexts`): the taps add their
    zero probes and record nothing, in the block's name scope, with the
    explicit generator replayed. The tapped activations are recorded in the
    forward and kept (influence analysis needs them anyway), so the factors
    equal the plain block's bit for bit.

    Outside a capture context this is `torch.utils.checkpoint.checkpoint`;
    where no gradient is taken (discovery), the block runs as it is."""
    state = context.active()
    if not torch.is_grad_enabled():
        return fn(*args)
    if state is None:
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=functools.partial(recompute_contexts, state.ctx))
