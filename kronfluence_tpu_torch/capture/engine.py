"""The capture transform: one backward pass yields every tracked layer's
(activation, output-gradient) pairs.

Port of `kronfluence_tpu/capture/engine.py`. A forward hook on each tracked
module (Linear, Conv2d or HF Conv1D), or a tagged functional op's tap by name,
records the layer's input and adds a zero probe to its output
(capture/context.py); `torch.autograd.grad(loss, probes)` then returns
dL/d(output) for every use of every tracked layer.

`remat=True` is the JAX package's rematerialisation (its meaning of
`offload_activations_to_cpu`): the forward keeps the captured activations
and recomputes the other intermediates in the backward pass. JAX wraps the
whole forward in one `jax.checkpoint`. torch's non-reentrant checkpoint
recomputes a region all at once, at the first saved tensor the backward
unpacks, so one region over the whole forward would bring every residual
back at the start of the backward and lower no peak. The port therefore
checkpoints each module that directly holds a tracked layer (a GPT-2
block's attention and MLP, a ResNet block) as its own region, recomputed when the backward
reaches it; what lies between regions (layer norms, the residual stream,
the loss head) is kept. A functional model rematerialises only where it
calls `checkpoint_block` (capture/functional.py), as in the JAX package; it
holds no tracked module, so it has no region here.
"""

import contextlib
import functools
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from kronfluence_tpu_torch.capture.context import CAPTURE, DISCOVER, CaptureContext, current_scope
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
    ctx = CaptureContext(DISCOVER, model.tracked_modules(), model.tracked_names)
    with ctx.activate(), torch.no_grad():
        fn()
    return ctx


def discover_specs(model, fn: Callable[[], torch.Tensor]) -> Dict[str, LayerSpec]:
    """{name: LayerSpec} of the tracked layers `fn` uses, in order of first use."""
    return discover(model, fn).specs


def remat_regions(model) -> List[torch.nn.Module]:
    """The modules that directly hold a tracked Linear or Conv2d (the root
    module when it holds one itself), each one rematerialisation region."""
    parents: Dict[str, None] = {}
    for name in model.tracked_modules():
        parents.setdefault(name.rpartition("/")[0].replace("/", "."), None)
    return [model.module.get_submodule(parent) for parent in parents]


class _GeneratorSnapshot:
    """Forward context of one region: the explicit generator's state and the
    tagged ops' name scope as the region's forward starts."""

    def __init__(self, generator: Optional[torch.Generator]) -> None:
        self.generator = generator
        self.state = None
        self.scope = ()

    def __enter__(self):
        self.scope = current_scope()
        if self.generator is not None:
            self.state = self.generator.get_state()

    def __exit__(self, *exc) -> None:
        return None


@contextlib.contextmanager
def _recompute(ctx: CaptureContext, snapshot: _GeneratorSnapshot):
    """Recompute context of one region: the hooks and taps without
    recording, under the region's name scope, and the explicit generator at
    its state of the region's forward (checkpoint's `preserve_rng_state`
    restores only the global generators), put back to where it was
    afterwards."""
    generator = snapshot.generator
    after = generator.get_state() if generator is not None else None
    if generator is not None:
        generator.set_state(snapshot.state)
    try:
        with ctx.activate(record=False, scope=snapshot.scope):
            yield
    finally:
        if generator is not None:
            generator.set_state(after)


def recompute_contexts(ctx: CaptureContext):
    """`context_fn` of a checkpoint inside a capture: (forward, recompute),
    replaying `ctx.generator`."""
    snapshot = _GeneratorSnapshot(ctx.generator)
    return snapshot, _recompute(ctx, snapshot)


@contextlib.contextmanager
def _rematerialised(model, ctx: CaptureContext):
    """Runs each of `remat_regions(model)` under a non-reentrant checkpoint
    for the duration of the block."""

    def checkpointed(forward):
        def run(*args, **kwargs):
            return checkpoint(
                forward, *args, use_reentrant=False,
                context_fn=functools.partial(recompute_contexts, ctx), **kwargs,
            )

        return run

    patched = []
    try:
        for module in remat_regions(model):
            patched.append((module, module.__dict__.get("forward")))
            module.forward = checkpointed(module.forward)
        yield
    finally:
        for module, own in patched:
            if own is None:
                del module.forward
            else:
                module.forward = own


@contextlib.contextmanager
def captured_forward(
    model,
    fn: Callable[[], torch.Tensor],
    remat: bool = False,
    generator: Optional[torch.Generator] = None,
):
    """The forward half of `capture`: yields (loss, CaptureContext). The
    remat regions stay checkpointed until the block ends, so the backward
    pass belongs inside it: a region's recompute runs the regions nested in
    it as checkpoints too."""
    ctx = CaptureContext(CAPTURE, model.tracked_modules(), model.tracked_names)
    ctx.generator = generator
    with _rematerialised(model, ctx) if remat else contextlib.nullcontext():
        with ctx.activate(), torch.enable_grad():
            loss = fn()
        yield loss, ctx


def capture(
    model,
    fn: Callable[[], torch.Tensor],
    require_tracked: bool = True,
    loss_scale: Optional[float] = None,
    remat: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, CaptureResult]:
    """Runs `fn` (a closure returning a scalar summed loss) with capture.

    Returns (detached loss, {module_name: LayerCapture}). `loss_scale` seeds
    the backward pass with that scale (GradScaler analogue for float16) and
    unscales the captured output gradients. `remat=True` rematerialises
    every intermediate but the captured activations (module docstring);
    `generator` is the explicit generator `fn` draws from, if any, which
    the recompute replays.
    """
    with captured_forward(model, fn, remat, generator) as (loss, ctx):
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
