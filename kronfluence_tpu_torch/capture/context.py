"""Forward-hook capture context: records tracked `nn.Linear` and `nn.Conv2d`
calls.

Port of `kronfluence_tpu/capture/context.py`, with the layer specs of
`kronfluence_tpu/capture/flax_integration.py`. Where the JAX package taps
layer calls while tracing, the port installs a forward hook on each tracked
layer for the duration of one forward pass:

  * discover mode records each layer's LayerSpec, in order of first use, and
    the shape of its output at every use;
  * capture mode also records the input activation (detached) and adds a
    zero probe tensor that requires grad to the layer output. Differentiating
    the loss with respect to the probes yields dL/d(output) for every use,
    without touching parameter gradients (the analogue of the JAX package's
    probe perturbations and the reference's zero-parameter hack).

A layer called several times in one forward (shared parameters) gets one
record per use. A rematerialisation's recompute re-enters the hooks with
`record=False`: the same operations, no new records.
"""

import contextlib
from typing import Dict, List, Union

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


def layer_spec(name: str, module: Union[nn.Linear, nn.Conv2d]) -> LayerSpec:
    if isinstance(module, nn.Conv2d):
        return conv_spec(name, module)
    return linear_spec(name, module)


class CaptureContext:
    """Hook registry for one instrumented forward pass."""

    def __init__(self, mode: str, modules: Dict[str, Union[nn.Linear, nn.Conv2d]]) -> None:
        if mode not in (DISCOVER, CAPTURE):
            raise ValueError(f"Unknown capture mode {mode!r}.")
        self.mode = mode
        self.modules = modules
        self.specs: Dict[str, LayerSpec] = {}
        self.activations: Dict[str, List[torch.Tensor]] = {}
        self.probes: Dict[str, List[torch.Tensor]] = {}
        self.output_shapes: Dict[str, List[torch.Size]] = {}

    def _hook(self, name: str, spec: LayerSpec, record: bool):
        def tap(module, args, output):
            del module
            if not record:
                # A recompute (capture/engine.py, remat): the same add of a
                # zero probe that requires grad, so the recompute runs the
                # captured forward's operations, and nothing is recorded.
                return output + torch.zeros_like(output, requires_grad=True)
            self.specs.setdefault(name, spec)
            if self.mode == DISCOVER:
                self.output_shapes.setdefault(name, []).append(output.shape)
                return None
            self.activations.setdefault(name, []).append(args[0].detach())
            probe = torch.zeros_like(output, requires_grad=True)
            self.probes.setdefault(name, []).append(probe)
            return output + probe

        return tap

    @contextlib.contextmanager
    def activate(self, record: bool = True):
        """Hooks on every tracked layer for the duration of the block;
        `record=False` adds the probes and records nothing."""
        handles = [
            module.register_forward_hook(self._hook(name, layer_spec(name, module), record))
            for name, module in self.modules.items()
        ]
        try:
            yield self
        finally:
            for handle in handles:
                handle.remove()
