"""Self-influence score stage.

Port of `kronfluence_tpu/score/self_scores.py` as an eager batch loop: per
batch each tracked module's per-sample gradients are preconditioned and
dotted with themselves (g^T H^-1 g). The measurement variant preconditions
the measurement's gradient and dots it with the train loss's. Scores are
assembled on the host, with the padding rows of a short last batch trimmed.
On a data mesh each rank scores its own rows and the scores are assembled in
global order on every rank.
"""

from typing import Any, Dict, List, Optional, Sequence

import torch

from kronfluence_tpu_torch.arguments import FactorArguments, ScoreArguments
from kronfluence_tpu_torch.capture.engine import capture
from kronfluence_tpu_torch.factor.config import get_factor_config
from kronfluence_tpu_torch.factor.covariance import (
    cast_params,
    discover_stage_specs,
    train_loss_forward,
    with_tracked,
)
from kronfluence_tpu_torch.parallel.mesh import check_loader, gather_rows
from kronfluence_tpu_torch.prepare import PreparedModel
from kronfluence_tpu_torch.score.common import (
    measurement_forward,
    module_per_sample_gradients,
    prepare_precondition_states,
)
from kronfluence_tpu_torch.task import Task
from kronfluence_tpu_torch.utils.constants import ALL_MODULE_NAME
from kronfluence_tpu_torch.utils.dataset import probe_first
from kronfluence_tpu_torch.utils.dtypes import resolve_dtype


def compute_self_scores_with_loaders(
    model: PreparedModel,
    task: Task,
    train_loader,
    factors: Dict[str, Dict[str, torch.Tensor]],
    factor_args: FactorArguments,
    score_args: Optional[ScoreArguments] = None,
    tracked_names: Optional[Sequence[str]] = None,
    mesh=None,
) -> Dict[str, torch.Tensor]:
    """Computes self-influence scores; returns {module_name or 'all_modules': (N,)}
    as CPU tensors in the score dtype, on every rank of a data `mesh` (the
    loader must be on it)."""
    check_loader(mesh, train_loader)
    score_args = score_args or ScoreArguments()
    model = with_tracked(model, tracked_names)
    strategy_config = get_factor_config(factor_args.strategy)
    psg_dtype = resolve_dtype(score_args.per_sample_gradient_dtype)
    precond_dtype = resolve_dtype(score_args.precondition_dtype)
    score_dtype = resolve_dtype(score_args.score_dtype)
    per_module = score_args.compute_per_module_scores
    use_measurement = score_args.use_measurement_for_self_influence
    remat = score_args.offload_activations_to_cpu

    probe_batch, _ = probe_first(train_loader)
    specs = discover_stage_specs(model, task, probe_batch)
    precondition_states = prepare_precondition_states(
        factors, factor_args.strategy, score_args, sorted(specs)
    )
    model = cast_params(model, score_args.amp_dtype)

    def apply(batch: Any, valid: torch.Tensor) -> Dict[str, torch.Tensor]:
        forward = train_loss_forward(model, task, batch, sample=False, generator=None)
        _, loss_caps = capture(model, forward, remat=remat)
        if use_measurement:
            _, meas_caps = capture(
                model, measurement_forward(model, task, batch), remat=remat
            )
        per_module_scores = {}
        for name, cap in loss_caps.items():
            loss_psg = module_per_sample_gradients(cap, valid, psg_dtype, task, name)
            src_psg = (
                module_per_sample_gradients(meas_caps[name], valid, psg_dtype, task, name)
                if use_measurement
                else loss_psg
            )
            preconditioned = strategy_config.precondition(
                src_psg.to(precond_dtype), precondition_states[name]
            )
            per_module_scores[name] = torch.einsum(
                "boi,boi->b", preconditioned.to(psg_dtype), loss_psg
            ).to(score_dtype)
        if per_module:
            return per_module_scores
        total = None
        for score in per_module_scores.values():
            total = score if total is None else total + score
        return {ALL_MODULE_NAME: total}

    chunks: Dict[str, List[torch.Tensor]] = {}
    for batch, valid in train_loader:
        for key, val in apply(batch, valid).items():
            chunks.setdefault(key, []).append(val)
    return {
        key: gather_rows(mesh, torch.cat(vals, dim=0), batches=len(vals))[
            : train_loader.num_examples
        ].cpu()
        for key, vals in chunks.items()
    }
