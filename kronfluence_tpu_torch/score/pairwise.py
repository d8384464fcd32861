"""Pairwise influence-score stage driver.

Port of `kronfluence_tpu/score/pairwise.py`. The loop nest is the JAX
package's: the query loader is consumed in blocks of
`query_gradient_accumulation_steps` batches of preconditioned query gradients
(sized by the memory model when it is None), and the train loader is
re-iterated once per block. A module's query gradient is kept dense in the
score dtype, quantized in `query_gradient_storage_dtype` (ops/quantize.py;
the chunks of a block merged per module and dequantized one module at a time
in the train pass), or, with `query_gradient_low_rank` and both of its
dimensions above the rank, as a low-rank pair (ops/svd.py). A train batch is
scored against each block without materializing its per-sample gradients
when the block is one chunk; with several chunks the per-sample gradients
are formed once and contracted with every chunk. `aggregate_query_gradients`
replaces the block by one preconditioned row, the sum of the raw query
gradients; `aggregate_train_gradients` scores it against the sum of the raw
train gradients, one column. Scores are assembled on the host, with the
padding rows of short last batches trimmed.

On a data mesh (`parallel/mesh.py`) both loaders yield this rank's rows.
Each query step's preconditioned gradients are assembled in global query
order on every rank (float8 blocks as their raw bytes and scales), so every
rank holds the whole block; each rank scores its train rows against it, and
the score columns are assembled in global train order on every rank.
Aggregated gradients are summed per rank and all-reduced.
"""

from typing import Any, Dict, List, Optional, Sequence

import torch

from kronfluence_tpu_torch.arguments import FactorArguments, ScoreArguments
from kronfluence_tpu_torch.capture.engine import capture
from kronfluence_tpu_torch.ops.covariance import summed_gradient
from kronfluence_tpu_torch.factor.config import get_factor_config
from kronfluence_tpu_torch.factor.covariance import (
    cast_params,
    discover_stage_specs,
    train_loss_forward,
    with_tracked,
)
from kronfluence_tpu_torch.ops.flatten import activation_tokens_with_bias, gradient_tokens
from kronfluence_tpu_torch.ops.quantize import (
    QuantizedGradient,
    concat_quantized,
    dequantize_gradient,
    quantize_gradient,
)
from kronfluence_tpu_torch.ops.scores import pairwise_score, rebuild
from kronfluence_tpu_torch.ops.svd import (
    goes_lowrank,
    lowrank_factors_full,
    lowrank_factors_randomized,
)
from kronfluence_tpu_torch.parallel.mesh import (
    agree_min,
    all_reduce_tree,
    check_loader,
    data_axis_size,
    gather_rows,
)
from kronfluence_tpu_torch.prepare import PreparedModel
from kronfluence_tpu_torch.score.common import (
    measurement_forward,
    module_per_sample_gradients,
    prepare_precondition_states,
)
from kronfluence_tpu_torch.task import Task
from kronfluence_tpu_torch.utils.constants import ALL_MODULE_NAME
from kronfluence_tpu_torch.utils.dataset import probe_first
from kronfluence_tpu_torch.utils.dtypes import canonical_dtype_name, resolve_dtype
from kronfluence_tpu_torch.utils.logger import PassThroughProfiler, get_logger
from kronfluence_tpu_torch.utils.memory import (
    autograd_bytes,
    factor_bytes_on,
    log_hbm,
    max_queries_per_block,
    probe_modules,
)


def _warn_fp8_low_damping(score_args: ScoreArguments) -> None:
    """The JAX package's warning: float8 query storage with damping below
    1e-6 (ops/quantize.py's noise, amplified by the preconditioner)."""
    storage = canonical_dtype_name(score_args.query_gradient_storage_dtype)
    damping = score_args.damping_factor
    low_damping = damping is not None and damping < 1e-6
    if storage is not None and storage.startswith("float8") and low_damping:
        get_logger("kronfluence_tpu_torch").warning(
            "float8 query-gradient storage with damping_factor=%g: near-zero "
            "damping inflates preconditioned gradients and the score inner "
            "products cancel heavily, amplifying float8's ~3%% element noise. "
            "Prefer damping_factor=None (heuristic) or certify fidelity "
            "against a full-precision run.",
            damping,
        )


def _gather_chunk(mesh, chunk):
    """A query step's chunk for this rank's rows -> the global batch's chunk
    on every rank: a dense block, a quantized block (data and scales) or a
    low-rank pair, rows in global order."""
    if isinstance(chunk, QuantizedGradient):
        return QuantizedGradient(gather_rows(mesh, chunk.data), gather_rows(mesh, chunk.scale))
    if isinstance(chunk, tuple):
        return tuple(gather_rows(mesh, part) for part in chunk)
    return gather_rows(mesh, chunk)


def _build_query_step(model, task, score_args, strategy, mesh=None):
    """Query-gradient step: (batch, valid, states, index) -> per-module
    preconditioned gradients, dense in the score dtype, quantized in the
    storage dtype, or a low-rank (left, right) pair. The randomized SVD draws
    its sketch from a generator seeded with the batch's index in the query
    loader, so the pairs do not depend on the accumulation steps. On a data
    mesh the step runs on this rank's rows and returns the global batch's
    chunks, assembled on every rank; the sketch is the global batch's,
    sliced, so a rank's pairs are those of one process."""
    strategy_config = get_factor_config(strategy)
    psg_dtype = resolve_dtype(score_args.per_sample_gradient_dtype)
    precond_dtype = resolve_dtype(score_args.precondition_dtype)
    svd_dtype = resolve_dtype(score_args.query_gradient_svd_dtype)
    score_dtype = resolve_dtype(score_args.score_dtype)
    storage_dtype = resolve_dtype(score_args.query_gradient_storage_dtype)
    rank = score_args.query_gradient_low_rank
    remat = score_args.offload_activations_to_cpu

    def query_step(batch, valid, precondition_states, index):
        _, captures = capture(model, measurement_forward(model, task, batch), remat=remat)
        out = {}
        for name, cap in captures.items():
            psg = module_per_sample_gradients(cap, valid, psg_dtype, task, name)
            psg = strategy_config.precondition(psg.to(precond_dtype), precondition_states[name])
            if goes_lowrank(psg.shape[2], psg.shape[1], score_args):
                psg = psg.to(svd_dtype)
                if score_args.use_full_svd:
                    out[name] = lowrank_factors_full(psg, rank, score_dtype)
                else:
                    generator = torch.Generator(device=psg.device).manual_seed(index)
                    rows = None
                    if mesh is not None:
                        rows = (mesh.rank * psg.shape[0], mesh.data * psg.shape[0])
                    out[name] = lowrank_factors_randomized(
                        psg, rank, score_dtype, generator, rows=rows
                    )
            elif storage_dtype is not None:
                out[name] = quantize_gradient(psg, storage_dtype)
            else:
                out[name] = psg.to(score_dtype)
            out[name] = _gather_chunk(mesh, out[name])
        return out

    return query_step


def _build_summed_gradient_step(model, task, psg_dtype, use_measurement, remat=False):
    """(batch, valid) -> per-module batch sums of the RAW per-sample
    gradients (`bto,bti->oi`, one GEMM over b*t): the task's post-process is
    never applied, as in the JAX package (and the reference's
    compute_summed_gradient). The measurement's gradients for queries, the
    train loss's for train batches."""

    def sum_step(batch, valid):
        if use_measurement:
            forward = measurement_forward(model, task, batch)
        else:
            forward = train_loss_forward(model, task, batch, sample=False, generator=None)
        _, captures = capture(model, forward, remat=remat)
        out = {}
        for name, cap in captures.items():
            total = None
            for a, dy in zip(cap.activations, cap.output_gradients):
                a_tok = activation_tokens_with_bias(cap.spec, a, psg_dtype)
                g_tok = gradient_tokens(cap.spec, dy, valid, psg_dtype)
                contrib = summed_gradient(a_tok, g_tok, psg_dtype)
                total = contrib if total is None else total + contrib
            out[name] = total
        return out

    return sum_step


def _sum_over_loader(sum_step, loader) -> Dict[str, torch.Tensor]:
    total: Dict[str, torch.Tensor] = {}
    for batch, valid in loader:
        for name, val in sum_step(batch, valid).items():
            total[name] = val if name not in total else total[name] + val
    return total


def _dense_chunk(pg, dtype) -> torch.Tensor:
    """A query chunk as a dense (q, o, i) block in `dtype`: dequantized, or
    rebuilt from its low-rank pair."""
    if isinstance(pg, tuple):
        return rebuild(*pg, dtype)
    return dequantize_gradient(pg, dtype).to(dtype)


def _per_module_or_total(per_module_scores: Dict[str, torch.Tensor], per_module: bool):
    """The per-module score slabs as they are, or their sum under
    ALL_MODULE_NAME."""
    if per_module:
        return per_module_scores
    total = None
    for score in per_module_scores.values():
        total = score if total is None else total + score
    return {ALL_MODULE_NAME: total}


def _make_train_apply(model, task, score_args, per_module):
    """Per-batch train scoring: (batch, valid, query_block) -> score slabs."""
    psg_dtype = resolve_dtype(score_args.per_sample_gradient_dtype)
    score_dtype = resolve_dtype(score_args.score_dtype)
    per_token = score_args.compute_per_token_scores
    post_process = task.enable_post_process_per_sample_gradient
    remat = score_args.offload_activations_to_cpu

    def _chunk_score_psg(train_psg, pg):
        """Score slab against materialized train per-sample gradients (a
        low-rank chunk rebuilt: q*o*i*(r + b) multiply-adds, the least of the
        orders of `qor,qri,boi->qb`)."""
        return torch.einsum("qoi,boi->qb", _dense_chunk(pg, psg_dtype), train_psg).to(score_dtype)

    def _chunk_score(cap, name, valid, pg):
        """Score slab (q_chunk, b[, t]) for one preconditioned query chunk. A
        quantized chunk is dequantized here, for this module only."""
        if post_process:
            train_psg = module_per_sample_gradients(cap, valid, psg_dtype, task, name)
            return _chunk_score_psg(train_psg, pg)
        pg = dequantize_gradient(pg, psg_dtype)
        score = None
        for a, dy in zip(cap.activations, cap.output_gradients):
            a_tok = activation_tokens_with_bias(cap.spec, a, psg_dtype)
            g_tok = gradient_tokens(cap.spec, dy, valid, psg_dtype)
            contrib = pairwise_score(pg, a_tok, g_tok, per_token, score_dtype)
            score = contrib if score is None else score + contrib
        return score

    def train_apply(batch, valid, query_block):
        forward = train_loss_forward(model, task, batch, sample=False, generator=None)
        _, captures = capture(model, forward, remat=remat)
        per_module_scores = {}
        for name, cap in captures.items():
            chunks = query_block[name]  # one entry per accumulation step
            if len(chunks) == 1:
                slabs = [_chunk_score(cap, name, valid, chunks[0])]
            elif per_token:
                slabs = [_chunk_score(cap, name, valid, pg) for pg in chunks]
            else:
                # Form the q-independent per-sample gradients once per batch.
                train_psg = module_per_sample_gradients(
                    cap, valid, psg_dtype, task if post_process else None, name
                )
                slabs = [_chunk_score_psg(train_psg, pg) for pg in chunks]
            per_module_scores[name] = slabs[0] if len(slabs) == 1 else torch.cat(slabs, dim=0)
        return _per_module_or_total(per_module_scores, per_module)

    return train_apply


def resolve_query_accumulation(
    model, task, probe_batch, query_loader, train_loader, score_args, factors=None, mesh=None
) -> int:
    """`query_gradient_accumulation_steps` from the memory model, for
    `query_gradient_accumulation_steps=None`: the query block is sized so one
    block plus one train pass fills the planning budget
    (utils/memory.py:max_queries_per_block), in query-loader batches, capped
    at the number of query batches. `model` carries its tracked modules
    (`with_tracked`), so the probe sees only those. On the card the train
    pass also holds what torch's autograd keeps (`autograd_bytes`), as the
    Computer's batch estimate plans, and the `factors` the caller holds on
    the card stay resident beside the block (the JAX terms count only the
    precondition state made from them); on the CPU the integers are the JAX
    package's. On a data mesh the block holds global query batches and the
    train pass this rank's rows; the ranks take the least of their answers."""
    query_bs = getattr(query_loader, "batch_size", None)
    if not query_bs:
        return 1
    probes = probe_modules(model, task, probe_batch, query_bs)
    untracked = reserve = 0.0
    if model.device.type == "cuda":
        untracked = autograd_bytes(
            model, task, probe_batch, query_bs, remat=score_args.offload_activations_to_cpu,
            amp_dtype=score_args.amp_dtype,
        )
        reserve = factor_bytes_on(factors or {}, model.device)
    block_q = max_queries_per_block(
        probes,
        score_args,
        params=model.module,
        train_batch_size=(getattr(train_loader, "batch_size", None) or 1)
        // data_axis_size(mesh),
        num_train=getattr(train_loader, "num_examples", 0) or 0,
        query_batch_size=query_bs,
        device=model.device,
        untracked_bytes=untracked,
        reserve_bytes=reserve,
    )
    num_query_batches = -(-query_loader.num_examples // query_bs)
    return agree_min(mesh, max(1, min(block_q // query_bs, num_query_batches)))


def _collect_blocks(blocks: List[Dict[str, Any]]) -> Dict[str, List[Any]]:
    """Groups per-module query gradients across accumulation steps. Dense
    and low-rank chunks stay separate: the train step contracts each chunk
    and concatenates the small score slabs instead of the large gradients.
    Quantized chunks are merged along the query axis (one module's payload at
    a time: each step's dict drops the module as it is merged), so the train
    step makes one contraction per module."""
    out: Dict[str, List[Any]] = {}
    for name in list(blocks[0]):
        chunks = [b.pop(name) for b in blocks]
        if len(chunks) > 1 and isinstance(chunks[0], QuantizedGradient):
            chunks = [concat_quantized(chunks)]
        out[name] = chunks
    return out


def _chunk_format(chunk) -> str:
    if isinstance(chunk, QuantizedGradient):
        return f"QuantizedGradient[{chunk.data.dtype}]"
    if isinstance(chunk, tuple):
        return f"LowRank[{chunk[0].dtype}]"
    return f"Tensor[{chunk.dtype}]"


def _aggregated_train_pass(
    model, task, train_loader, score_args, per_module, query_block, mesh=None
):
    """Scores every query chunk against the sum of the raw train gradients
    (one contraction per module): a (q, 1) column."""
    psg_dtype = resolve_dtype(score_args.per_sample_gradient_dtype)
    score_dtype = resolve_dtype(score_args.score_dtype)
    sum_step = _build_summed_gradient_step(
        model, task, psg_dtype, False, score_args.offload_activations_to_cpu
    )
    total = all_reduce_tree(mesh, _sum_over_loader(sum_step, train_loader))

    def one(pg, summed):
        pg = dequantize_gradient(pg, psg_dtype)
        if isinstance(pg, tuple):
            # qor,oi->qri then the sum over (r, i): q*r*o*i multiply-adds and
            # a (q, r, i) temporary, where a rebuild would hold (q, o, i).
            left, right = pg
            projected = torch.matmul(left.to(psg_dtype).transpose(1, 2), summed)
            return (projected * right.to(psg_dtype)).sum(dim=(1, 2))[:, None]
        return torch.einsum("qoi,oi->q", pg.to(psg_dtype), summed)[:, None]

    per_module_scores = {}
    for name, chunks in query_block.items():
        summed = total[name].to(psg_dtype)
        slabs = [one(pg, summed) for pg in chunks]
        score = slabs[0] if len(slabs) == 1 else torch.cat(slabs, dim=0)
        per_module_scores[name] = score.to(score_dtype)
    return _per_module_or_total(per_module_scores, per_module)


def compute_pairwise_scores_with_loaders(
    model: PreparedModel,
    task: Task,
    query_loader,
    train_loader,
    factors: Dict[str, Dict[str, torch.Tensor]],
    factor_args: FactorArguments,
    score_args: Optional[ScoreArguments] = None,
    tracked_names: Optional[Sequence[str]] = None,
    profiler=None,
    mesh=None,
) -> Dict[str, torch.Tensor]:
    """Computes pairwise scores; returns {module_name or 'all_modules': (Q, T[, t])}
    as CPU tensors in the score dtype ((1, T) with aggregated query
    gradients, (Q, 1) with aggregated train gradients). `profiler` times the
    query-gradient step and the train pass apart, as the JAX package's
    regions "Pairwise: query gradients" and "Pairwise: train pass". With a
    data `mesh`, both loaders must be on it; every rank returns the whole
    score matrix."""
    check_loader(mesh, query_loader)
    check_loader(mesh, train_loader)
    score_args = score_args or ScoreArguments()
    profiler = profiler or PassThroughProfiler()
    _warn_fp8_low_damping(score_args)
    model = with_tracked(model, tracked_names)
    per_module = score_args.compute_per_module_scores
    accumulation = score_args.query_gradient_accumulation_steps

    probe_batch, _ = probe_first(query_loader)
    specs = discover_stage_specs(model, task, probe_batch)
    precondition_states = prepare_precondition_states(
        factors, factor_args.strategy, score_args, sorted(specs)
    )
    strategy_config = get_factor_config(factor_args.strategy)
    if accumulation is None:
        accumulation = resolve_query_accumulation(
            model, task, probe_batch, query_loader, train_loader, score_args, factors, mesh
        )

    model = cast_params(model, score_args.amp_dtype)
    psg_dtype = resolve_dtype(score_args.per_sample_gradient_dtype)
    precond_dtype = resolve_dtype(score_args.precondition_dtype)
    score_dtype = resolve_dtype(score_args.score_dtype)

    def aggregated_query_block():
        """One block of one preconditioned row per module: the sum of the raw
        query gradients (never low-rank, never quantized)."""
        sum_step = _build_summed_gradient_step(
            model, task, psg_dtype, True, score_args.offload_activations_to_cpu
        )
        total = all_reduce_tree(mesh, _sum_over_loader(sum_step, query_loader))
        yield {
            name: [
                strategy_config.precondition(
                    summed[None].to(precond_dtype), precondition_states[name]
                ).to(score_dtype)
            ]
            for name, summed in total.items()
        }

    def query_blocks_iter():
        query_step = _build_query_step(model, task, score_args, factor_args.strategy, mesh)
        pending = []
        yielded_full = False
        for index, (batch, valid) in enumerate(query_loader):
            pending.append(query_step(batch, valid, precondition_states, index))
            if len(pending) == accumulation:
                yielded_full = True
                # Collect and drop the per-step references before yielding,
                # so the merged block is not held beside its parts.
                block, pending = _collect_blocks(pending), []
                yield block
                del block  # do not hold the old block while building the next
        if pending:
            # Pad a trailing partial block to the full chunk count by
            # repeating its last chunk (the same tensors, no recompute), as
            # the JAX package does to keep one block structure; the duplicate
            # rows land past `num_examples` and are trimmed below.
            if yielded_full:
                while len(pending) < accumulation:
                    pending.append(dict(pending[-1]))
            yield _collect_blocks(pending)

    if score_args.aggregate_train_gradients:
        def train_pass(query_block):
            return _aggregated_train_pass(
                model, task, train_loader, score_args, per_module, query_block, mesh
            )
    else:
        train_apply = _make_train_apply(model, task, score_args, per_module)

        def train_pass(query_block):
            module_chunks: Dict[str, List[torch.Tensor]] = {}
            for batch, valid in train_loader:
                for key, val in train_apply(batch, valid, query_block).items():
                    module_chunks.setdefault(key, []).append(val)
            return {
                key: gather_rows(mesh, torch.cat(chunks, dim=1), dim=1, batches=len(chunks))[
                    :, : train_loader.num_examples
                ]
                for key, chunks in module_chunks.items()
            }

    chunks_per_block = []
    formats = set()
    blocks = (
        aggregated_query_block() if score_args.aggregate_query_gradients else query_blocks_iter()
    )
    while True:
        # The generator interleaves the query steps with the train passes:
        # drive it by hand to time them apart.
        with profiler.profile("Pairwise: query gradients"):
            query_block = next(blocks, None)
        if query_block is None:
            break
        formats.update(_chunk_format(c) for chunks in query_block.values() for c in chunks)
        log_hbm("pairwise: query block resident", model.device)
        with profiler.profile("Pairwise: train pass"):
            chunks_per_block.append(train_pass(query_block))
        log_hbm("pairwise: train pass done", model.device)
        del query_block
    # What the last run resolved, kept only for checks (the tests and
    # chip_smoke.py read it to see that the recipe took effect); nothing in
    # the package reads it.
    compute_pairwise_scores_with_loaders.last_run = dict(
        accumulation=accumulation, blocks=len(chunks_per_block), formats=sorted(formats)
    )

    # The aggregated row has no padding: it is not trimmed.
    keep = None if score_args.aggregate_query_gradients else query_loader.num_examples
    return {
        key: torch.cat([block[key] for block in chunks_per_block], dim=0)[:keep].cpu()
        for key in chunks_per_block[0]
    }


compute_pairwise_scores_with_loaders.last_run = None
