"""Capture context: records tracked layer calls, by forward hook or by name.

Port of `kronfluence_tpu/capture/context.py`, with the layer specs of
`kronfluence_tpu/capture/flax_integration.py`. Where the JAX package taps
layer calls while tracing, the port records them during one forward pass,
through one code path (`CaptureContext.tap`) reached two ways: a forward hook
on each tracked module (`nn.Linear`, `nn.Conv2d`, HF GPT-2's `Conv1D`) for
the duration of `activate`, and a tagged functional op
(`capture/functional.py`) that finds the active context through `active()`
and taps it by name.

  * discover mode records each layer's LayerSpec, in order of first use, and
    the shape of its output at every use;
  * capture mode also records the input activation (detached) and adds a
    zero probe tensor that requires grad to the layer output. Differentiating
    the loss with respect to the probes yields dL/d(output) for every use,
    without touching parameter gradients (the analogue of the JAX package's
    probe perturbations and the reference's zero-parameter hack).

A layer called several times in one forward (shared parameters) gets one
record per use. A rematerialisation's recompute re-enters the hooks and taps
with `record=False`: the same operations, no new records. Tagged ops inside
`scan_layers` are named under its `name_scope`, e.g. `h_3/attn/c_attn`.
"""

import contextlib
import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from kronfluence_tpu_torch.capture.specs import LayerSpec, normalize_padding
from kronfluence_tpu_torch.utils.exceptions import UnsupportableModuleError

DISCOVER = "discover"
CAPTURE = "capture"


def linear_spec(name: str, module: nn.Linear) -> LayerSpec:
    return LayerSpec(
        name=name,
        kind="linear",
        has_bias=module.bias is not None,
        in_dim=module.in_features,
        out_dim=module.out_features,
    )


def is_hf_conv1d(module: nn.Module) -> bool:
    """HuggingFace GPT-2's `Conv1D` (transformers.pytorch_utils): a dense
    layer whose weight is stored (in, out). Recognised by its class name and
    shape, as the JAX package recognises `FlaxConv1D`, so that
    `transformers` need not be importable."""
    weight = getattr(module, "weight", None)
    return (
        type(module).__name__ == "Conv1D"
        and isinstance(getattr(module, "nf", None), int)
        and isinstance(weight, torch.Tensor)
        and weight.dim() == 2
        and weight.shape[1] == module.nf
    )


def hf_conv1d_spec(name: str, module: nn.Module) -> LayerSpec:
    """A `Conv1D` computes x @ weight + bias with weight (nx, nf): a linear
    layer of in_dim nx and out_dim nf. Only the (input, output-gradient)
    streams enter the factors, not the weight's layout."""
    nx, nf = module.weight.shape
    return LayerSpec(
        name=name,
        kind="linear",
        has_bias=getattr(module, "bias", None) is not None,
        in_dim=int(nx),
        out_dim=int(nf),
    )


def conv_spec(name: str, module: nn.Conv2d) -> LayerSpec:
    """The LayerSpec of a Conv2d: in_dim is C_in/groups * Kh * Kw; padding,
    strides, dilation and groups come from the module."""
    if module.padding_mode != "zeros":
        raise UnsupportableModuleError(
            f"{name}: padding_mode {module.padding_mode!r} cannot be tracked; only zero "
            "padding has a Kronecker-factored form here."
        )
    kh, kw = module.kernel_size
    return LayerSpec(
        name=name,
        kind="conv2d",
        has_bias=module.bias is not None,
        in_dim=module.in_channels // module.groups * kh * kw,
        out_dim=module.out_channels,
        kernel_size=(kh, kw),
        strides=tuple(module.stride),
        padding=normalize_padding(module.padding),
        kernel_dilation=tuple(module.dilation),
        feature_group_count=module.groups,
    )


def is_trackable(module: nn.Module) -> bool:
    return isinstance(module, (nn.Linear, nn.Conv2d)) or is_hf_conv1d(module)


def layer_spec(name: str, module: nn.Module) -> LayerSpec:
    if isinstance(module, nn.Conv2d):
        return conv_spec(name, module)
    if isinstance(module, nn.Linear):
        return linear_spec(name, module)
    return hf_conv1d_spec(name, module)


@dataclasses.dataclass(frozen=True)
class Active:
    """What a tagged op sees of the context around it: the context, whether
    it records (False in a recompute), and the name scope of `scan_layers`."""

    ctx: "CaptureContext"
    record: bool
    scope: Tuple[str, ...] = ()


_tls = threading.local()


def active() -> Optional[Active]:
    """The capture context this thread's forward runs under, if any."""
    return getattr(_tls, "active", None)


@contextlib.contextmanager
def _entered(state: Optional[Active]):
    prev = active()
    _tls.active = state
    try:
        yield
    finally:
        _tls.active = prev


@contextlib.contextmanager
def name_scope(prefix: str):
    """Tagged ops in the block are named `prefix/<name>` (nested scopes join
    with '/'); no-op outside a capture context."""
    state = active()
    if state is None:
        yield
        return
    with _entered(dataclasses.replace(state, scope=state.scope + (prefix,))):
        yield


def current_scope() -> Tuple[str, ...]:
    state = active()
    return () if state is None else state.scope


def tap(spec: LayerSpec, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """A tagged op's tap: `y` as it is outside a capture context or for an
    untracked name; else the active context's `tap` under the scoped name."""
    state = active()
    if state is None:
        return y
    return state.ctx.tap_named(spec, x, y, state.record, state.scope)


class CaptureContext:
    """Hook registry and tap target for one instrumented forward pass.

    `modules` are the tracked modules, hooked while `activate` runs;
    `tracked_names` (None: every name) filters the tagged ops' taps as
    `get_influence_tracked_modules` filters the modules."""

    def __init__(
        self,
        mode: str,
        modules: Dict[str, nn.Module],
        tracked_names: Optional[Sequence[str]] = None,
    ) -> None:
        if mode not in (DISCOVER, CAPTURE):
            raise ValueError(f"Unknown capture mode {mode!r}.")
        self.mode = mode
        self.modules = modules
        self.tracked_names = set(tracked_names) if tracked_names is not None else None
        # The explicit generator the forward draws from, which a recompute
        # replays (capture/engine.py).
        self.generator: Optional[torch.Generator] = None
        self.specs: Dict[str, LayerSpec] = {}
        self.activations: Dict[str, List[torch.Tensor]] = {}
        self.probes: Dict[str, List[torch.Tensor]] = {}
        self.output_shapes: Dict[str, List[torch.Size]] = {}

    def is_tracked(self, name: str) -> bool:
        return self.tracked_names is None or name in self.tracked_names

    def tap(self, spec: LayerSpec, x: torch.Tensor, y: torch.Tensor, record: bool = True):
        """Records one use of a tracked layer; returns its output, with the
        zero probe added in capture mode. `record=False` (a recompute) adds a
        fresh zero probe that requires grad, so the recompute runs the
        captured forward's operations, and records nothing."""
        if not record:
            return y + torch.zeros_like(y, requires_grad=True)
        name = spec.name
        prev = self.specs.setdefault(name, spec)
        if prev != spec:
            raise ValueError(
                f"Tracked module {name!r} used with inconsistent specs: {prev} vs {spec}."
            )
        if self.mode == DISCOVER:
            self.output_shapes.setdefault(name, []).append(y.shape)
            return y
        self.activations.setdefault(name, []).append(x.detach())
        probe = torch.zeros_like(y, requires_grad=True)
        self.probes.setdefault(name, []).append(probe)
        return y + probe

    def tap_named(
        self, spec: LayerSpec, x: torch.Tensor, y: torch.Tensor, record: bool,
        scope: Tuple[str, ...] = (),
    ) -> torch.Tensor:
        """A tagged op's call: named under `scope`, skipped if untracked; a
        name that a hooked module also carries is an error, not a second
        record of one layer."""
        name = "/".join(scope + (spec.name,))
        if not self.is_tracked(name):
            return y
        if name in self.modules:
            raise ValueError(
                f"{name!r} names both a tracked module and a tagged functional op; give the "
                "op another name (each tracked name is one layer)."
            )
        return self.tap(dataclasses.replace(spec, name=name), x, y, record)

    def _hook(self, name: str, spec: LayerSpec, record: bool):
        def hook(module, args, output):
            del module
            return self.tap(spec, args[0], output, record)

        return hook

    @contextlib.contextmanager
    def activate(self, record: bool = True, scope: Tuple[str, ...] = ()):
        """Hooks on every tracked module, and this context as the tagged ops'
        target, for the duration of the block; `record=False` adds the
        probes and records nothing."""
        handles = [
            module.register_forward_hook(self._hook(name, layer_spec(name, module), record))
            for name, module in self.modules.items()
        ]
        try:
            with _entered(Active(self, record, scope)):
                yield self
        finally:
            for handle in handles:
                handle.remove()
