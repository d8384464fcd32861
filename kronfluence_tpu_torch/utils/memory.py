"""Analytic device-memory model for sizing the pairwise query block.

Port of the query-block half of `kronfluence_tpu/utils/memory.py`: the
per-module facts come from one discovery forward on the probe batch (token
counts from the tracked layers' output shapes, dimensions from their
LayerSpecs), and `max_queries_per_block` sizes the resident query block so
that one block plus one train pass fits the planning budget. The model's
terms and constants are the JAX package's, so both packages return the same
integers for the same model, loaders and budget.

The device limit is the card's total memory (`torch.cuda.mem_get_info`), in
the role of JAX's `bytes_limit`; on the CPU it is the JAX package's 15 GiB
default. `estimate_batch_size` and `log_hbm` are not ported yet.
"""

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from kronfluence_tpu_torch.capture.engine import discover
from kronfluence_tpu_torch.factor.covariance import train_loss_forward
from kronfluence_tpu_torch.utils.dtypes import resolve_dtype

#: Untracked intermediates (attention scores, layernorms,
#: activations between tracked layers) survive to the backward pass: a small
#: multiple of the tracked token streams.
RESIDUAL_MULTIPLIER = 2.0

#: Fraction of the device's memory the pairwise stage may plan against. The
#: sizer subtracts every major resident explicitly, so only scratch and
#: fragmentation need the headroom.
PAIRWISE_BUDGET_FRACTION = 0.9

#: The sizer's cap on one block (the JAX package's `max_queries` default).
MAX_QUERIES_PER_BLOCK = 4096

#: The JAX package's limit when the device reports none (its CPU backend).
_DEFAULT_LIMIT_BYTES = 15 * 1024**3


@dataclasses.dataclass
class ModuleProbe:
    """Per-module shape facts measured from one discovery forward."""

    spec: Any
    tokens: int  # flattened token rows per dataset example, per use
    uses: int


def probe_modules(model: Any, task: Any, batch: Any, batch_size: int) -> Dict[str, ModuleProbe]:
    """Tracked modules of `model` (a PreparedModel) and their per-example
    token counts, from one forward on `batch` of `batch_size` examples."""
    forward = train_loss_forward(model, task, batch, sample=False, generator=None)
    ctx = discover(model, forward)
    probes: Dict[str, ModuleProbe] = {}
    for name, spec in ctx.specs.items():
        shapes = ctx.output_shapes[name]
        rows = sum(int(np.prod(s[:-1])) for s in shapes)
        probes[name] = ModuleProbe(
            spec=spec, tokens=max(1, rows // max(1, batch_size)), uses=len(shapes)
        )
    return probes


def _dtype_bytes(dtype: Any, default: int = 4) -> int:
    try:
        return int(resolve_dtype(dtype).itemsize)
    except (AttributeError, TypeError, ValueError):
        return default


def per_example_bytes(
    probes: Dict[str, ModuleProbe], *, capture_bytes: int = 4, psg_bytes: int = 4
) -> float:
    """Bytes of per-example device state live during one pairwise train step:
    the captured token streams and their residuals, plus two of the largest
    module's per-sample gradients (they are formed one module at a time)."""
    stream = 0.0
    psg_peak = 0.0
    for probe in probes.values():
        spec = probe.spec
        stream += probe.uses * probe.tokens * (spec.in_dim + spec.gradient_dim) * capture_bytes
        psg_peak = max(psg_peak, spec.activation_dim * spec.gradient_dim * psg_bytes)
    return RESIDUAL_MULTIPLIER * stream + 2 * psg_peak


def static_bytes(
    probes: Dict[str, ModuleProbe], params: Optional[torch.nn.Module] = None, *, state_bytes: int = 4
) -> float:
    """Per-run device state of the pairwise stage independent of batch size:
    the parameter bytes of `params` (an nn.Module) plus each module's
    eigenvectors and lambda (the precondition state)."""
    total = 0.0
    if params is not None:
        total += sum(p.numel() * p.element_size() for p in params.parameters())
    for probe in probes.values():
        d_in = probe.spec.activation_dim
        d_out = probe.spec.gradient_dim
        total += (d_in * d_in + d_out * d_out + d_in * d_out) * state_bytes
    return total


def query_block_bytes(probes: Dict[str, ModuleProbe], score_args: Any, num_queries: int) -> float:
    """Resident bytes of one preconditioned query-gradient block: per query
    and module, the dense (o, i) gradient in the score dtype, or its
    quantized payload plus one fp32 scale."""
    storage = score_args.query_gradient_storage_dtype
    if storage is None:
        elem_b, query_b = _dtype_bytes(score_args.score_dtype), 0
    else:
        elem_b, query_b = _dtype_bytes(storage), 4
    per_query = sum(
        p.spec.activation_dim * p.spec.gradient_dim * elem_b + query_b for p in probes.values()
    )
    return num_queries * per_query


def device_memory_limit(device: Any) -> float:
    """The card's total memory in bytes; 15 GiB for a CPU device."""
    device = torch.device(device)
    if device.type == "cuda":
        return float(torch.cuda.mem_get_info(device)[1])
    return float(_DEFAULT_LIMIT_BYTES)


def max_queries_per_block(
    probes: Dict[str, ModuleProbe],
    score_args: Any,
    *,
    params: Optional[torch.nn.Module] = None,
    train_batch_size: int = 1,
    num_train: int = 0,
    budget_bytes: Optional[float] = None,
    query_batch_size: int = 8,
    device: Any = None,
) -> int:
    """Largest query count whose resident block fits beside the train pass.

    The budget (`budget_bytes`, or else `PAIRWISE_BUDGET_FRACTION` of
    `device`'s limit; one of the two is required) less the parameters and
    precondition state, one train batch's capture streams and per-sample
    gradients, and (for a quantized block) two query-batch chunks of the
    largest module dequantized; divided by a query's block bytes plus its
    score row.
    """
    if budget_bytes is None:
        if device is None:
            raise ValueError("max_queries_per_block needs budget_bytes or the device to plan for.")
        budget_bytes = device_memory_limit(device) * PAIRWISE_BUDGET_FRACTION
    budget = budget_bytes - static_bytes(probes, params)
    amp = score_args.amp_dtype
    capture_b = _dtype_bytes(amp) if amp is not None else 4
    psg_b = _dtype_bytes(score_args.per_sample_gradient_dtype)
    budget -= train_batch_size * per_example_bytes(probes, capture_bytes=capture_b, psg_bytes=psg_b)
    score_b = _dtype_bytes(score_args.score_dtype)
    tokens = max((p.tokens for p in probes.values()), default=1)
    per_query_scores = num_train * (tokens if score_args.compute_per_token_scores else 1) * score_b
    per_query = query_block_bytes(probes, score_args, 1) + per_query_scores
    if score_args.query_gradient_storage_dtype is not None:
        # One query-batch chunk of one module is dense at a time (the train
        # pass dequantizes module by module); budget two such chunks.
        max_module_oi = max(
            (p.spec.activation_dim * p.spec.gradient_dim for p in probes.values()), default=0
        )
        budget -= 2 * query_batch_size * max_module_oi * psg_b
    if per_query <= 0:
        return MAX_QUERIES_PER_BLOCK
    return max(1, min(MAX_QUERIES_PER_BLOCK, int(budget // per_query)))
