"""Analytic device-memory model: the executable batch size of each stage and
the pairwise query block.

Port of `kronfluence_tpu/utils/memory.py`. The per-module facts come from one
discovery forward on the probe batch (token counts from the tracked layers'
output shapes, dimensions from their LayerSpecs); the remat and
iterative-lambda flags change the model where they change liveness.
`estimate_batch_size` picks the largest batch whose working set fits the
planning budget, `max_queries_per_block` the largest query block that fits
beside one train pass. The terms and constants are the JAX package's, so both
packages return the same integers for the same model, probes and budget.

The device limit is the card's total memory (`torch.cuda.mem_get_info`) and
the memory in use `torch.cuda.memory_allocated` (the caching allocator's free
blocks are not in use); on the CPU the limit is the JAX package's 15 GiB
default. Two terms are the port's own, used on the card only, so that on the
CPU the integers are the JAX package's: `autograd_bytes`, what torch's eager
autograd keeps for the backward pass beyond the captured streams (the JAX
model's residual multiplier stands for what XLA keeps), which the Computer's
batch estimate and the pairwise block sizer add per example;
`lowrank_transient_bytes`, the temporary of the order the port contracts a
low-rank query block in, which `pairwise_plan_bytes` holds; and
`precondition_bytes`, the (B, o, i) arrays the eager preconditioning holds at
once, which the self stage's batch estimate adds per example and the
pairwise query step plans.
"""

import dataclasses
import os
import sys
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from kronfluence_tpu_torch.capture.engine import captured_forward, discover
from kronfluence_tpu_torch.factor.covariance import cast_params, train_loss_forward
from kronfluence_tpu_torch.ops.scores import lowrank_transient_elements
from kronfluence_tpu_torch.ops.svd import goes_lowrank
from kronfluence_tpu_torch.utils.dtypes import resolve_dtype

#: Fraction of the free device memory a stage's batch working set may fill.
#: The rest covers scratch, temporaries and fragmentation.
DEFAULT_BUDGET_FRACTION = 0.5

#: Untracked intermediates (attention scores, layernorms, activations between
#: tracked layers) survive to the backward pass: a small multiple of the
#: tracked token streams, cut to about one by remat.
RESIDUAL_MULTIPLIER = 2.0
RESIDUAL_MULTIPLIER_REMAT = 1.0

#: Fraction of the device's memory the pairwise stage may plan against. The
#: sizer subtracts every major resident explicitly, so only scratch and
#: fragmentation need the headroom.
PAIRWISE_BUDGET_FRACTION = 0.9

#: The sizer's cap on one block (the JAX package's `max_queries` default).
MAX_QUERIES_PER_BLOCK = 4096

#: (B, o, i) arrays in the precondition dtype that the eigenbasis sandwich
#: (factor/config.py:_EigenbasisSandwich.precondition, the widest strategy)
#: holds at its peak beside its argument: the rotated gradient and the two
#: products of the rotation back.
SANDWICH_COPIES = 3

#: The JAX package's limit when the device reports none (its CPU backend).
_DEFAULT_LIMIT_BYTES = 15 * 1024**3


@dataclasses.dataclass
class ModuleProbe:
    """Per-module shape facts measured from one discovery forward."""

    spec: Any
    tokens: int  # flattened token rows per dataset example, per use
    uses: int


def output_rows(spec: Any, shape: Sequence[int]) -> int:
    """Token rows of one use of a layer from its output shape: every dim but
    the features, which are last for a linear layer and dim 1 of a conv
    layer's NCHW output (B * oh * ow rows, as the JAX package counts NHWC)."""
    if spec.kind == "conv2d":
        return int(shape[0] * np.prod(shape[2:]))
    return int(np.prod(shape[:-1]))


def probe_modules(model: Any, task: Any, batch: Any, batch_size: int) -> Dict[str, ModuleProbe]:
    """Tracked modules of `model` (a PreparedModel) and their per-example
    token counts, from one forward on `batch` of `batch_size` examples."""
    forward = train_loss_forward(model, task, batch, sample=False, generator=None)
    ctx = discover(model, forward)
    probes: Dict[str, ModuleProbe] = {}
    for name, spec in ctx.specs.items():
        shapes = ctx.output_shapes[name]
        rows = sum(output_rows(spec, s) for s in shapes)
        probes[name] = ModuleProbe(
            spec=spec, tokens=max(1, rows // max(1, batch_size)), uses=len(shapes)
        )
    return probes


def autograd_bytes(
    model: Any, task: Any, batch: Any, batch_size: int, *, remat: bool = False, amp_dtype=None
) -> float:
    """Bytes per example that torch's autograd keeps for the backward pass of
    one captured train-loss forward on `batch` (of `batch_size` examples):
    every storage it saves, once, less the parameters', plus twice the
    largest (the first backward step's gradient and input gradient are
    that size: for a language model, its log-probabilities over the
    vocabulary). Under `remat` a region's saved tensors are placeholders and
    are not counted. The forward is run, the backward is not."""
    model = cast_params(model, amp_dtype)
    params = {p.untyped_storage().data_ptr() for p in model.module.parameters()}
    saved: Dict[int, int] = {}

    def pack(t: torch.Tensor) -> torch.Tensor:
        storage = t.untyped_storage()
        if storage.data_ptr() not in params:
            saved[storage.data_ptr()] = storage.nbytes()
        # Detached: the storage stays held (so no address is reused while
        # the forward runs), but an op's saved output no longer refers back
        # to its own node, a cycle through autograd's graph that no
        # collector frees.
        return t.detach()

    forward = train_loss_forward(model, task, batch, sample=False, generator=None)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        with captured_forward(model, forward, remat=remat):
            pass
    total = sum(saved.values()) + 2 * max(saved.values(), default=0)
    return total / max(1, batch_size)


def _dtype_bytes(dtype: Any, default: int = 4) -> int:
    try:
        return int(resolve_dtype(dtype).itemsize)
    except (AttributeError, TypeError, ValueError):
        return default


def per_example_bytes(
    probes: Dict[str, ModuleProbe],
    stage: str,
    *,
    capture_bytes: int = 4,
    stage_bytes: int = 4,
    psg_bytes: int = 4,
    remat: bool = False,
    iterative_lambda: bool = False,
) -> float:
    """Bytes of per-example device state live during one `stage` step.

    Per tracked module and use: the captured activation and output-gradient
    token streams (all stages) with their untracked residuals (the residual
    multiplier, cut by remat); for covariance, the flattened copies in the
    covariance dtype; for lambda, the per-sample gradient (not with iterative
    aggregation, which takes one example at a time); for pairwise and self,
    two of the largest module's per-sample gradients (they are formed one
    module at a time; self also holds the preconditioned copy).
    """
    stream = 0.0
    extra = 0.0
    psg_peak = 0.0
    for probe in probes.values():
        spec = probe.spec
        d_in = spec.activation_dim
        d_out = spec.gradient_dim
        stream += probe.uses * probe.tokens * (spec.in_dim + d_out) * capture_bytes
        if stage == "covariance":
            extra += probe.uses * probe.tokens * (d_in + d_out) * stage_bytes
        elif stage == "lambda":
            if not iterative_lambda:
                extra += d_in * d_out * psg_bytes
        elif stage in ("pairwise", "self"):
            factor = 2 if stage == "self" else 1
            psg_peak = max(psg_peak, factor * d_in * d_out * psg_bytes)
    if stage in ("pairwise", "self"):
        extra += 2 * psg_peak
    residual = RESIDUAL_MULTIPLIER_REMAT if remat else RESIDUAL_MULTIPLIER
    return residual * stream + extra


def static_bytes(
    probes: Dict[str, ModuleProbe],
    stage: str,
    params: Optional[torch.nn.Module] = None,
    *,
    state_bytes: int = 4,
) -> float:
    """Per-run device state independent of batch size: the parameter bytes of
    `params` (an nn.Module) plus the stage's factor arrays (covariance: the
    two covariances; lambda: the eigenvectors and the lambda sum; pairwise
    and self: the precondition state)."""
    total = 0.0
    if params is not None:
        total += sum(p.numel() * p.element_size() for p in params.parameters())
    for probe in probes.values():
        d_in = probe.spec.activation_dim
        d_out = probe.spec.gradient_dim
        if stage == "covariance":
            total += (d_in * d_in + d_out * d_out) * state_bytes
        elif stage in ("lambda", "pairwise", "self"):
            total += (d_in * d_in + d_out * d_out + d_in * d_out) * state_bytes
    return total


def query_block_bytes(probes: Dict[str, ModuleProbe], score_args: Any, num_queries: int) -> float:
    """Resident bytes of one preconditioned query-gradient block: per query
    and module, the low-rank pair's rank * (d_in + d_out) elements in the
    score dtype where the module goes low-rank (`ops/svd.py:goes_lowrank`,
    the pairwise stage's rule), else the quantized payload plus one fp32
    scale, else the dense (o, i) gradient in the score dtype. An aggregated
    block is one dense row a module, never low-rank or quantized."""
    rank = score_args.query_gradient_low_rank
    storage = score_args.query_gradient_storage_dtype
    if score_args.aggregate_query_gradients:
        storage = None
    score_b = _dtype_bytes(score_args.score_dtype)
    per_query = 0.0
    for p in probes.values():
        d_in, d_out = p.spec.activation_dim, p.spec.gradient_dim
        if goes_lowrank(d_in, d_out, score_args):
            per_query += rank * (d_in + d_out) * score_b
        elif storage is not None:
            per_query += d_in * d_out * _dtype_bytes(storage) + 4
        else:
            per_query += d_in * d_out * score_b
    return num_queries * per_query


def lowrank_transient_bytes(
    probes: Dict[str, ModuleProbe], score_args: Any, query_batch_size: int, train_batch_size: int
) -> float:
    """The largest temporary of a train pass over a low-rank block: one
    module's chunk of `query_batch_size` queries (low-rank chunks stay one
    query batch each) in the per-sample-gradient dtype, contracted in the
    order `ops/scores.py:lowrank_route` picks, or rebuilt dense where the
    per-sample gradients are materialized (several chunks, post-processing).
    0 without a rank."""
    rank = score_args.query_gradient_low_rank
    if rank is None:
        return 0.0
    psg_b = _dtype_bytes(score_args.per_sample_gradient_dtype)
    worst = 0
    for p in probes.values():
        d_in, d_out = p.spec.activation_dim, p.spec.gradient_dim
        if goes_lowrank(d_in, d_out, score_args):
            q, b, t = query_batch_size, train_batch_size, p.tokens
            route = lowrank_transient_elements(q, d_out, d_in, rank, b, t)
            worst = max(worst, route, q * d_out * d_in)
    return float(worst * psg_b)


def _largest_module_oi(probes: Dict[str, ModuleProbe]) -> int:
    return max((p.spec.activation_dim * p.spec.gradient_dim for p in probes.values()), default=0)


def precondition_bytes(probes: Dict[str, ModuleProbe], score_args: Any) -> float:
    """Bytes per example of the arrays in the precondition dtype that the
    port's eager preconditioning of the largest module holds at its peak
    (score/self_scores.py, score/pairwise.py's query step): the cast of its
    per-sample gradient (none where the two dtypes agree) and
    SANDWICH_COPIES more. The per-sample gradients themselves are the JAX
    model's terms."""
    psg = resolve_dtype(score_args.per_sample_gradient_dtype)
    precond = resolve_dtype(score_args.precondition_dtype)
    arrays = SANDWICH_COPIES + (precond != psg)
    return float(_largest_module_oi(probes) * arrays * precond.itemsize)


def factor_bytes_on(factors: Dict[str, Dict[str, torch.Tensor]], device: Any) -> float:
    """Bytes of the factor tensors ({factor: {module: tensor}}) on `device`."""
    device = torch.device(device)
    return float(sum(
        t.nbytes for per_module in factors.values() for t in per_module.values()
        if t.device.type == device.type
    ))


def device_memory_limit(device: Any) -> float:
    """The card's total memory in bytes; 15 GiB for a CPU device."""
    device = torch.device(device)
    if device.type == "cuda":
        return float(torch.cuda.mem_get_info(device)[1])
    return float(_DEFAULT_LIMIT_BYTES)


def device_memory_in_use(device: Any) -> float:
    """Bytes the caching allocator has handed out on the card; 0 on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return float(torch.cuda.memory_allocated(device))
    return 0.0


def device_memory_budget(device: Any, fraction: float = DEFAULT_BUDGET_FRACTION) -> float:
    """`fraction` of the device's free memory (at least a quarter of its limit)."""
    limit = device_memory_limit(device)
    return max(limit - device_memory_in_use(device), limit // 4) * fraction


def log_hbm(label: str, device: Any = None) -> None:
    """Prints the card's memory in use, its peak and its limit to stderr when
    KF_MEM_LOG=1 (an aid for out-of-memory hunts; off by default)."""
    if not os.environ.get("KF_MEM_LOG"):
        return
    device = torch.device("cuda" if device is None else device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    print(
        "HBM[%s]: in_use %.2f GB, peak %.2f GB, limit %.2f GB" % (
            label,
            device_memory_in_use(device) / 1024**3,
            peak / 1024**3,
            device_memory_limit(device) / 1024**3,
        ),
        file=sys.stderr, flush=True,
    )


def stage_per_example_bytes(
    probes: Dict[str, ModuleProbe],
    stage: str,
    *,
    factor_args: Any = None,
    score_args: Any = None,
) -> float:
    """`per_example_bytes` with the byte widths and flags the stage's
    arguments set (amp dtype, covariance and per-sample-gradient dtypes,
    remat, iterative lambda)."""
    remat = False
    iterative = False
    capture_b = stage_b = psg_b = 4
    if factor_args is not None:
        remat = bool(factor_args.offload_activations_to_cpu)
        iterative = bool(factor_args.use_iterative_lambda_aggregation)
        if factor_args.amp_dtype is not None:
            capture_b = _dtype_bytes(factor_args.amp_dtype)
        if stage == "covariance":
            stage_b = _dtype_bytes(factor_args.activation_covariance_dtype)
        psg_b = _dtype_bytes(factor_args.per_sample_gradient_dtype)
    if score_args is not None:
        remat = remat or bool(score_args.offload_activations_to_cpu)
        if score_args.amp_dtype is not None:
            capture_b = _dtype_bytes(score_args.amp_dtype)
        psg_b = _dtype_bytes(score_args.per_sample_gradient_dtype)
    return per_example_bytes(
        probes, stage, capture_bytes=capture_b, stage_bytes=stage_b, psg_bytes=psg_b,
        remat=remat, iterative_lambda=iterative,
    )


def estimate_batch_size(
    probes: Dict[str, ModuleProbe],
    stage: str,
    *,
    params: Optional[torch.nn.Module] = None,
    factor_args: Any = None,
    score_args: Any = None,
    budget_bytes: Optional[float] = None,
    max_batch_size: int = 4096,
    device: Any = None,
    untracked_bytes: float = 0.0,
) -> int:
    """Largest per-device batch size whose working set fits the budget:
    `budget_bytes`, or else `device_memory_budget(device)` (one of the two is
    required), less `static_bytes`, over `stage_per_example_bytes` plus
    `untracked_bytes` (the port's `autograd_bytes`; 0 gives the JAX
    package's integer), clamped to [1, max_batch_size]."""
    per_example = stage_per_example_bytes(
        probes, stage, factor_args=factor_args, score_args=score_args
    ) + untracked_bytes
    if budget_bytes is None:
        if device is None:
            raise ValueError("estimate_batch_size needs budget_bytes or the device to plan for.")
        budget_bytes = device_memory_budget(device)
    budget_bytes -= static_bytes(probes, stage, params)
    if per_example <= 0:
        return max_batch_size
    fit = int(budget_bytes // per_example)
    return max(1, min(max_batch_size, fit))


def pairwise_plan_bytes(
    probes: Dict[str, ModuleProbe],
    score_args: Any,
    num_queries: int,
    *,
    params: Optional[torch.nn.Module] = None,
    train_batch_size: int = 1,
    num_train: int = 0,
    query_batch_size: int = 8,
    device: Any = None,
    untracked_bytes: float = 0.0,
) -> float:
    """Device bytes the pairwise stage plans for a block of `num_queries`:
    the parameters and precondition state, one train batch's capture
    streams and per-sample gradients plus `untracked_bytes` an example (the
    port's `autograd_bytes`, 0 for the JAX package's terms), for a quantized
    block two query-batch chunks of the largest module dequantized, on the
    card the low-rank contraction's temporary (`lowrank_transient_bytes`)
    and, where it is larger than the train pass, the query step's
    per-sample gradient and preconditioning arrays (`precondition_bytes`;
    the two never run together), and per query its block bytes and its
    score row."""
    amp = score_args.amp_dtype
    capture_b = _dtype_bytes(amp) if amp is not None else 4
    psg_b = _dtype_bytes(score_args.per_sample_gradient_dtype)
    total = static_bytes(probes, "pairwise", params)
    train_pass = train_batch_size * (per_example_bytes(
        probes, "pairwise", capture_bytes=capture_b, psg_bytes=psg_b,
        remat=bool(score_args.offload_activations_to_cpu),
    ) + untracked_bytes)
    if score_args.query_gradient_storage_dtype is not None:
        # One query-batch chunk of one module is dense at a time (the train
        # pass dequantizes module by module); budget two such chunks.
        train_pass += 2 * query_batch_size * _largest_module_oi(probes) * psg_b
    if device is not None and torch.device(device).type == "cuda":
        # The port's own terms, on the card only (the CPU keeps the JAX
        # package's integers): the low-rank contraction's temporary, and
        # the query step's preconditioning where it outgrows the train pass.
        train_pass += lowrank_transient_bytes(
            probes, score_args, query_batch_size, train_batch_size)
        query_step = query_batch_size * (
            precondition_bytes(probes, score_args) + _largest_module_oi(probes) * psg_b)
        train_pass = max(train_pass, query_step)
    total += train_pass
    score_b = _dtype_bytes(score_args.score_dtype)
    tokens = max((p.tokens for p in probes.values()), default=1)
    per_query_scores = num_train * (tokens if score_args.compute_per_token_scores else 1) * score_b
    return total + num_queries * (query_block_bytes(probes, score_args, 1) + per_query_scores)


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
    untracked_bytes: float = 0.0,
    reserve_bytes: float = 0.0,
) -> int:
    """Largest query count whose `pairwise_plan_bytes` fits the budget
    (`budget_bytes`, or else `PAIRWISE_BUDGET_FRACTION` of `device`'s limit;
    one of the two is required) less `reserve_bytes`, residents the caller
    knows of and the model cannot see; at most MAX_QUERIES_PER_BLOCK."""
    if budget_bytes is None:
        if device is None:
            raise ValueError("max_queries_per_block needs budget_bytes or the device to plan for.")
        budget_bytes = device_memory_limit(device) * PAIRWISE_BUDGET_FRACTION
    plan = dict(params=params, train_batch_size=train_batch_size, num_train=num_train,
                query_batch_size=query_batch_size, device=device, untracked_bytes=untracked_bytes)
    fixed = pairwise_plan_bytes(probes, score_args, 0, **plan)
    per_query = pairwise_plan_bytes(probes, score_args, 1, **plan) - fixed
    if per_query <= 0:
        return MAX_QUERIES_PER_BLOCK
    fit = int((budget_bytes - reserve_bytes - fixed) // per_query)
    return max(1, min(MAX_QUERIES_PER_BLOCK, fit))
