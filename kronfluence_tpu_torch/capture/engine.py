"""The capture transform: one backward pass yields every tracked layer's
(activation, output-gradient) pairs.

Port of `kronfluence_tpu/capture/engine.py`. A forward hook on each tracked
Linear records its input and adds a zero probe to its output
(capture/context.py); `torch.autograd.grad(loss, probes)` then returns
dL/d(output) for every use of every tracked layer.
"""

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from kronfluence_tpu_torch.capture.context import CAPTURE, DISCOVER, CaptureContext
from kronfluence_tpu_torch.capture.specs import LayerSpec
from kronfluence_tpu_torch.utils.exceptions import TrackedModuleNotFoundError


@dataclass
class LayerCapture:
    """All captured uses of one tracked layer within a single forward/backward."""

    spec: LayerSpec
    activations: List[torch.Tensor]  # raw layer inputs, one per use
    output_gradients: List[torch.Tensor]  # dL/d(layer output), one per use


CaptureResult = Dict[str, LayerCapture]


def discover(model, fn: Callable[[], torch.Tensor]) -> CaptureContext:
    """Runs `fn` once without autograd to find the tracked layers it uses.

    `model` is a `PreparedModel` (prepare.py). Returns the discovery context:
    `.specs` {name: LayerSpec} in order of first use, and `.output_shapes`
    {name: [output shape of each use]} (the JAX package's discovery avals).
    """
    ctx = CaptureContext(DISCOVER, model.tracked_linears())
    with ctx.activate(), torch.no_grad():
        fn()
    return ctx


def discover_specs(model, fn: Callable[[], torch.Tensor]) -> Dict[str, LayerSpec]:
    """{name: LayerSpec} of the tracked layers `fn` uses, in order of first use."""
    return discover(model, fn).specs


def capture(
    model,
    fn: Callable[[], torch.Tensor],
    require_tracked: bool = True,
    loss_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, CaptureResult]:
    """Runs `fn` (a closure returning a scalar summed loss) with capture.

    Returns (detached loss, {module_name: LayerCapture}). `loss_scale` seeds
    the backward pass with that scale (GradScaler analogue for float16) and
    unscales the captured output gradients.
    """
    ctx = CaptureContext(CAPTURE, model.tracked_linears())
    with ctx.activate(), torch.enable_grad():
        loss = fn()
    if require_tracked and not ctx.specs:
        raise TrackedModuleNotFoundError(
            "No tracked modules were encountered in the forward pass. Prepare the "
            "model with `prepare_model` and check the task's tracked module names."
        )
    if loss.ndim != 0:
        raise ValueError(f"Loss/measurement must be a scalar; got shape {tuple(loss.shape)}.")
    scaled = loss_scale is not None and loss_scale != 1.0
    seed = torch.full((), loss_scale if scaled else 1.0, dtype=loss.dtype, device=loss.device)
    names = list(ctx.specs)
    probes = [p for name in names for p in ctx.probes[name]]
    grads = torch.autograd.grad(loss, probes, grad_outputs=seed, allow_unused=True)
    result: CaptureResult = {}
    pos = 0
    for name in names:
        uses = len(ctx.probes[name])
        outs = []
        for probe, g in zip(ctx.probes[name], grads[pos : pos + uses]):
            g = torch.zeros_like(probe) if g is None else g
            outs.append(g * (1.0 / loss_scale) if scaled else g)
        pos += uses
        result[name] = LayerCapture(
            spec=ctx.specs[name],
            activations=ctx.activations[name],
            output_gradients=outs,
        )
    return loss.detach(), result
