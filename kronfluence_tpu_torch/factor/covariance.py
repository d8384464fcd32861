"""Covariance-fitting stage driver.

Port of `kronfluence_tpu/factor/covariance.py` as an eager batch loop: each
batch runs one forward and one backward with capture, then folds the
`A^T A` / `G^T G` updates of every tracked layer into running sums, updated
in place. A conv layer's activation gram is that of its im2col patches.
Wide grams go through the K1 triangle kernel on the GPU
(ops/covariance.py); the stage runs the K3 launch check first. On a data
mesh each rank sums the grams of its own rows (K1 per rank) and one
all-reduce at the end of the stage sums the ranks' factors and counts, in
the accumulation dtype, before the cast to the storage dtype.
"""

import copy
from typing import Any, Dict, Optional, Sequence

import torch

from kronfluence_tpu_torch.arguments import FactorArguments
from kronfluence_tpu_torch.capture.engine import capture, discover_specs
from kronfluence_tpu_torch.ops.covariance import bordered_gram, gram
from kronfluence_tpu_torch.ops.flatten import flatten_activation_parts, flatten_gradient
from kronfluence_tpu_torch.ops.kernels.probe import probe
from kronfluence_tpu_torch.parallel.mesh import all_reduce_tree, check_loader
from kronfluence_tpu_torch.prepare import PreparedModel
from kronfluence_tpu_torch.task import Task
from kronfluence_tpu_torch.utils.constants import (
    ACTIVATION_COVARIANCE_MATRIX_NAME,
    GRADIENT_COVARIANCE_MATRIX_NAME,
    NUM_ACTIVATION_COVARIANCE_PROCESSED,
    NUM_GRADIENT_COVARIANCE_PROCESSED,
)
from kronfluence_tpu_torch.utils.dataset import probe_first
from kronfluence_tpu_torch.utils.dtypes import accumulation_dtype, resolve_dtype


def _attention_mask_for(module_name: str, masks: Any) -> Optional[torch.Tensor]:
    if masks is None:
        return None
    if isinstance(masks, dict):
        return masks.get(module_name)
    return masks


def with_tracked(model: PreparedModel, tracked_names: Optional[Sequence[str]]) -> PreparedModel:
    """The same module under an explicit tracked-name filter (None keeps the model's)."""
    if tracked_names is None:
        return model
    return PreparedModel(model.module, tracked_names)


def cast_params(model: PreparedModel, amp_dtype: Any) -> PreparedModel:
    """Autocast analogue: a model whose floating parameters are in
    `amp_dtype`, for the stage's forward and backward (the same object when
    they already are). Factor and score dtypes are set separately."""
    if amp_dtype is None:
        return model
    dtype = resolve_dtype(amp_dtype)
    floats = [p for p in model.module.parameters() if p.is_floating_point()]
    if all(p.dtype == dtype for p in floats):
        return model
    return PreparedModel(copy.deepcopy(model.module).to(dtype), model.tracked_names)


def loss_scale_for(amp_dtype, amp_scale) -> Optional[float]:
    """GradScaler analogue: active only for float16 autocast."""
    if amp_dtype is None or amp_scale in (None, 1.0):
        return None
    if resolve_dtype(amp_dtype) == torch.float16:
        return float(amp_scale)
    return None


def train_loss_forward(
    model: PreparedModel,
    task: Task,
    batch: Any,
    sample: bool,
    generator: Optional[torch.Generator],
):
    """Builds the zero-arg loss closure captured by the engine."""

    def forward():
        return task.compute_train_loss(batch, model.module, sample=sample, generator=generator)

    return forward


def discover_stage_specs(
    model: PreparedModel,
    task: Task,
    batch: Any,
    tracked_names: Optional[Sequence[str]] = None,
):
    """Tracked-layer specs from one forward (no autograd) on an example batch."""
    model = with_tracked(model, tracked_names)
    return discover_specs(model, train_loss_forward(model, task, batch, False, None))


def _make_covariance_update(
    model, task, act_dtype, grad_dtype, sample, loss_scale=None, remat=False
):
    """Per-batch update: capture, flatten, and add each layer's grams."""
    act_accum = accumulation_dtype(act_dtype)
    grad_accum = accumulation_dtype(grad_dtype)

    def update(state, batch, valid, generator):
        forward = train_loss_forward(model, task, batch, sample, generator)
        _, captures = capture(
            model, forward, loss_scale=loss_scale, remat=remat, generator=generator
        )
        masks = task.get_attention_mask(batch)
        for name, cap in captures.items():
            spec = cap.spec
            att = _attention_mask_for(name, masks)
            mod_state = state[name]
            for a, dy in zip(cap.activations, cap.output_gradients):
                a2, _, count_a = flatten_activation_parts(spec, a, att, valid, act_dtype)
                mod_state[ACTIVATION_COVARIANCE_MATRIX_NAME] += bordered_gram(
                    a2, count_a, spec.has_bias, act_accum
                )
                mod_state[NUM_ACTIVATION_COVARIANCE_PROCESSED] += count_a
                g_flat, count_g = flatten_gradient(spec, dy, att, valid, grad_dtype)
                mod_state[GRADIENT_COVARIANCE_MATRIX_NAME] += gram(g_flat, grad_accum)
                mod_state[NUM_GRADIENT_COVARIANCE_PROCESSED] += count_g
        return state

    return update


def fit_covariance_matrices_with_loader(
    model: PreparedModel,
    task: Task,
    loader,
    factor_args: Optional[FactorArguments] = None,
    tracked_names: Optional[Sequence[str]] = None,
    mesh=None,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Fits activation/gradient covariance over all batches of `loader`.

    Returns {factor_name: {module_name: tensor}} on the model's device, the
    matrices in the covariance dtypes and the counts as int64 of shape (1,).
    With a data `mesh` the loader yields this rank's rows (it must be on the
    same mesh), and every rank returns the sums over all ranks.
    """
    check_loader(mesh, loader)
    factor_args = factor_args or FactorArguments()
    model = with_tracked(model, tracked_names)
    device = model.device
    act_dtype = resolve_dtype(factor_args.activation_covariance_dtype)
    grad_dtype = resolve_dtype(factor_args.gradient_covariance_dtype)
    act_accum = accumulation_dtype(act_dtype)
    grad_accum = accumulation_dtype(grad_dtype)
    sample = not factor_args.use_empirical_fisher

    if device.type == "cuda":
        probe(device)  # K3: the kernel build launches here before K1 is used

    try:
        first_batch, _ = probe_first(loader)
    except StopIteration:
        raise ValueError("Empty loader for covariance fitting.") from None
    specs = discover_stage_specs(model, task, first_batch)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    state = {
        name: {
            ACTIVATION_COVARIANCE_MATRIX_NAME: zeros(
                (spec.activation_dim, spec.activation_dim), act_accum
            ),
            GRADIENT_COVARIANCE_MATRIX_NAME: zeros((spec.gradient_dim, spec.gradient_dim), grad_accum),
            NUM_ACTIVATION_COVARIANCE_PROCESSED: zeros((), torch.int64),
            NUM_GRADIENT_COVARIANCE_PROCESSED: zeros((), torch.int64),
        }
        for name, spec in specs.items()
    }

    model = cast_params(model, factor_args.amp_dtype)
    update = _make_covariance_update(
        model, task, act_dtype, grad_dtype, sample,
        loss_scale_for(factor_args.amp_dtype, factor_args.amp_scale),
        factor_args.offload_activations_to_cpu,
    )
    generator = torch.Generator(device).manual_seed(factor_args.seed) if sample else None
    for batch, valid in loader:
        update(state, batch, valid, generator)
    # Once a stage, not per gram: the sums are equal in exact arithmetic, and
    # the state (1.3 GB in fp32 at GPT-2 small) would otherwise cross every batch.
    all_reduce_tree(mesh, state)

    result: Dict[str, Dict[str, torch.Tensor]] = {
        ACTIVATION_COVARIANCE_MATRIX_NAME: {},
        GRADIENT_COVARIANCE_MATRIX_NAME: {},
        NUM_ACTIVATION_COVARIANCE_PROCESSED: {},
        NUM_GRADIENT_COVARIANCE_PROCESSED: {},
    }
    for name, mod_state in state.items():
        result[ACTIVATION_COVARIANCE_MATRIX_NAME][name] = mod_state[
            ACTIVATION_COVARIANCE_MATRIX_NAME
        ].to(act_dtype)
        result[GRADIENT_COVARIANCE_MATRIX_NAME][name] = mod_state[
            GRADIENT_COVARIANCE_MATRIX_NAME
        ].to(grad_dtype)
        for count_name in (NUM_ACTIVATION_COVARIANCE_PROCESSED, NUM_GRADIENT_COVARIANCE_PROCESSED):
            result[count_name][name] = mod_state[count_name].reshape((1,))
    return result
