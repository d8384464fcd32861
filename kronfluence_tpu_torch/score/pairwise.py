"""Pairwise influence-score stage driver.

Port of `kronfluence_tpu/score/pairwise.py` for dense and quantized query
blocks. The loop nest is the JAX package's: the query loader is consumed in
blocks of `query_gradient_accumulation_steps` batches of preconditioned query
gradients (sized by the memory model when it is None), and the train loader
is re-iterated once per block. With `query_gradient_storage_dtype` each
module's query gradient is stored quantized (ops/quantize.py), the chunks of
a block are merged per module, and the train pass dequantizes one module's
block at a time, right before its contraction. A train batch is scored
against each block without materializing its per-sample gradients when the
block is one chunk; with several chunks the per-sample gradients are formed
once and contracted with every chunk. Scores are assembled on the host, with
the padding rows of short last batches trimmed.
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
from kronfluence_tpu_torch.ops.flatten import activation_tokens_with_bias, gradient_tokens
from kronfluence_tpu_torch.ops.quantize import (
    QuantizedGradient,
    concat_quantized,
    dequantize_gradient,
    quantize_gradient,
)
from kronfluence_tpu_torch.ops.scores import pairwise_score
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
from kronfluence_tpu_torch.utils.memory import log_hbm, max_queries_per_block, probe_modules


def _check_ported(score_args: ScoreArguments) -> None:
    """Raises for score options this slice of the port does not carry yet."""
    unported = {
        "query_gradient_low_rank": (
            score_args.query_gradient_low_rank is not None,
            "ROADMAP Queue 1, remaining score features (ops/svd.py)",
        ),
        "aggregate_query_gradients": (
            score_args.aggregate_query_gradients,
            "ROADMAP Queue 1, remaining score features",
        ),
        "aggregate_train_gradients": (
            score_args.aggregate_train_gradients,
            "ROADMAP Queue 1, remaining score features",
        ),
    }
    for name, (is_set, item) in unported.items():
        if is_set:
            raise NotImplementedError(f"ScoreArguments.{name} is not ported yet ({item}).")


def _build_query_step(model, task, score_args, strategy):
    """Query-gradient step: batch -> per-module preconditioned gradients,
    dense in the score dtype or quantized in the storage dtype."""
    strategy_config = get_factor_config(strategy)
    psg_dtype = resolve_dtype(score_args.per_sample_gradient_dtype)
    precond_dtype = resolve_dtype(score_args.precondition_dtype)
    score_dtype = resolve_dtype(score_args.score_dtype)
    storage_dtype = resolve_dtype(score_args.query_gradient_storage_dtype)
    remat = score_args.offload_activations_to_cpu

    def query_step(batch, valid, precondition_states):
        _, captures = capture(model, measurement_forward(model, task, batch), remat=remat)
        out = {}
        for name, cap in captures.items():
            psg = module_per_sample_gradients(cap, valid, psg_dtype, task, name)
            psg = strategy_config.precondition(psg.to(precond_dtype), precondition_states[name])
            if storage_dtype is not None:
                out[name] = quantize_gradient(psg, storage_dtype)
            else:
                out[name] = psg.to(score_dtype)
        return out

    return query_step


def _make_train_apply(model, task, score_args, per_module):
    """Per-batch train scoring: (batch, valid, query_block) -> score slabs."""
    psg_dtype = resolve_dtype(score_args.per_sample_gradient_dtype)
    score_dtype = resolve_dtype(score_args.score_dtype)
    per_token = score_args.compute_per_token_scores
    post_process = task.enable_post_process_per_sample_gradient
    remat = score_args.offload_activations_to_cpu

    def _chunk_score_psg(train_psg, pg):
        """Score slab against materialized train per-sample gradients."""
        pg = dequantize_gradient(pg, psg_dtype)
        return torch.einsum("qoi,boi->qb", pg.to(psg_dtype), train_psg).to(score_dtype)

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
        if per_module:
            return per_module_scores
        total = None
        for score in per_module_scores.values():
            total = score if total is None else total + score
        return {ALL_MODULE_NAME: total}

    return train_apply


def resolve_query_accumulation(
    model, task, probe_batch, query_loader, train_loader, score_args
) -> int:
    """`query_gradient_accumulation_steps` from the memory model, for
    `query_gradient_accumulation_steps=None`: the query block is sized so one
    block plus one train pass fills the planning budget
    (utils/memory.py:max_queries_per_block), in query-loader batches, capped
    at the number of query batches. `model` carries its tracked modules
    (`with_tracked`), so the probe sees only those."""
    query_bs = getattr(query_loader, "batch_size", None)
    if not query_bs:
        return 1
    probes = probe_modules(model, task, probe_batch, query_bs)
    block_q = max_queries_per_block(
        probes,
        score_args,
        params=model.module,
        train_batch_size=getattr(train_loader, "batch_size", None) or 1,
        num_train=getattr(train_loader, "num_examples", 0) or 0,
        query_batch_size=query_bs,
        device=model.device,
    )
    num_query_batches = -(-query_loader.num_examples // query_bs)
    return max(1, min(block_q // query_bs, num_query_batches))


def _collect_blocks(blocks: List[Dict[str, Any]]) -> Dict[str, List[Any]]:
    """Groups per-module query gradients across accumulation steps. Dense
    chunks stay separate: the train step contracts each chunk and
    concatenates the small score slabs instead of the large gradients.
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


def compute_pairwise_scores_with_loaders(
    model: PreparedModel,
    task: Task,
    query_loader,
    train_loader,
    factors: Dict[str, Dict[str, torch.Tensor]],
    factor_args: FactorArguments,
    score_args: Optional[ScoreArguments] = None,
    tracked_names: Optional[Sequence[str]] = None,
) -> Dict[str, torch.Tensor]:
    """Computes pairwise scores; returns {module_name or 'all_modules': (Q, T[, t])}
    as CPU tensors in the score dtype."""
    score_args = score_args or ScoreArguments()
    _check_ported(score_args)
    model = with_tracked(model, tracked_names)
    per_module = score_args.compute_per_module_scores
    accumulation = score_args.query_gradient_accumulation_steps

    probe_batch, _ = probe_first(query_loader)
    specs = discover_stage_specs(model, task, probe_batch)
    precondition_states = prepare_precondition_states(
        factors, factor_args.strategy, score_args, sorted(specs)
    )
    if accumulation is None:
        accumulation = resolve_query_accumulation(
            model, task, probe_batch, query_loader, train_loader, score_args
        )

    model = cast_params(model, score_args.amp_dtype)
    query_step = _build_query_step(model, task, score_args, factor_args.strategy)
    train_apply = _make_train_apply(model, task, score_args, per_module)

    def query_blocks_iter():
        pending = []
        yielded_full = False
        for batch, valid in query_loader:
            pending.append(query_step(batch, valid, precondition_states))
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

    def train_pass(query_block):
        module_chunks: Dict[str, List[torch.Tensor]] = {}
        for batch, valid in train_loader:
            for key, val in train_apply(batch, valid, query_block).items():
                module_chunks.setdefault(key, []).append(val)
        return {
            key: torch.cat(chunks, dim=1)[:, : train_loader.num_examples]
            for key, chunks in module_chunks.items()
        }

    chunks_per_block = []
    formats = set()
    for query_block in query_blocks_iter():
        formats.update(
            f"{type(c).__name__}[{c.data.dtype if isinstance(c, QuantizedGradient) else c.dtype}]"
            for chunks in query_block.values() for c in chunks
        )
        log_hbm("pairwise: query block resident", model.device)
        chunks_per_block.append(train_pass(query_block))
        log_hbm("pairwise: train pass done", model.device)
        del query_block
    # What the last run resolved, kept only for checks (the tests and
    # chip_smoke.py read it to see that the recipe took effect); nothing in
    # the package reads it.
    compute_pairwise_scores_with_loaders.last_run = dict(
        accumulation=accumulation, blocks=len(chunks_per_block), formats=sorted(formats)
    )

    return {
        key: torch.cat([block[key] for block in chunks_per_block], dim=0)[
            : query_loader.num_examples
        ].cpu()
        for key in chunks_per_block[0]
    }


compute_pairwise_scores_with_loaders.last_run = None
