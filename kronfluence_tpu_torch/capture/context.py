"""Forward-hook capture context: records tracked `nn.Linear` calls.

Port of `kronfluence_tpu/capture/context.py`. Where the JAX package taps layer
calls while tracing, the port installs a forward hook on each tracked Linear
for the duration of one forward pass:

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
from typing import Dict, List

import torch
from torch import nn

from kronfluence_tpu_torch.capture.specs import LayerSpec

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


class CaptureContext:
    """Hook registry for one instrumented forward pass."""

    def __init__(self, mode: str, linears: Dict[str, nn.Linear]) -> None:
        if mode not in (DISCOVER, CAPTURE):
            raise ValueError(f"Unknown capture mode {mode!r}.")
        self.mode = mode
        self.linears = linears
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
        """Hooks on every tracked Linear for the duration of the block;
        `record=False` adds the probes and records nothing."""
        handles = [
            module.register_forward_hook(self._hook(name, linear_spec(name, module), record))
            for name, module in self.linears.items()
        ]
        try:
            yield self
        finally:
            for handle in handles:
                handle.remove()
