"""Shared scoring machinery: precondition-state preparation and per-sample
gradient assembly from captures. Port of `kronfluence_tpu/score/common.py`."""

from typing import Any, Dict, Optional, Sequence

import torch

from kronfluence_tpu_torch.arguments import ScoreArguments
from kronfluence_tpu_torch.capture.engine import LayerCapture
from kronfluence_tpu_torch.factor.config import PreconditionState, get_factor_config
from kronfluence_tpu_torch.ops.covariance import per_sample_gradient as psg_op
from kronfluence_tpu_torch.ops.flatten import activation_tokens_with_bias, gradient_tokens
from kronfluence_tpu_torch.task import Task
from kronfluence_tpu_torch.utils.exceptions import FactorsNotFoundError


def prepare_precondition_states(
    factors: Dict[str, Dict[str, Any]],
    strategy: str,
    score_args: ScoreArguments,
    module_names: Sequence[str],
) -> Dict[str, PreconditionState]:
    """One-time damping/inversion per module, on the factors' device."""
    config = get_factor_config(strategy)
    states = {}
    for name in module_names:
        module_factors = {
            factor_name: tensors[name]
            for factor_name, tensors in factors.items()
            if name in tensors
        }
        missing = [
            key for key in config.required_precondition_factors if key not in module_factors
        ]
        if missing:
            raise FactorsNotFoundError(
                f"Factors {missing} for module {name!r} are required by the "
                f"{strategy!r} strategy but absent from the factors dict."
            )
        states[name] = config.prepare(
            module_factors, score_args.damping_factor, score_args.precondition_dtype
        )
    return states


def module_per_sample_gradients(
    cap: LayerCapture,
    valid: Optional[torch.Tensor],
    dtype,
    task: Optional[Task] = None,
    module_name: Optional[str] = None,
) -> torch.Tensor:
    """(batch, out_dim, in_dim[+1]) per-sample gradients, summed over uses."""
    total = None
    for a, dy in zip(cap.activations, cap.output_gradients):
        a_tok = activation_tokens_with_bias(cap.spec, a, dtype)
        g_tok = gradient_tokens(cap.spec, dy, valid, dtype)
        contrib = psg_op(a_tok, g_tok, dtype)
        total = contrib if total is None else total + contrib
    if task is not None and task.enable_post_process_per_sample_gradient:
        total = task.post_process_per_sample_gradient(module_name, total)
    return total


def measurement_forward(model, task: Task, batch: Any):
    def forward():
        return task.compute_measurement(batch, model.module)

    return forward
