"""An analysis through the port's Analyzer leaves no reference cycle that
holds the model: once the caller drops the Analyzer and the model, reference
counting alone frees the weights, with the collector off. A cycle would keep
a large model's weights on the card until the collector next runs, memory
that the next analysis's batch sizes (the memory model's plan) do not count.
Each case runs the stages once first, so that the lazy imports of a first
forward (torch's own, which leave frames in cycles once) are done."""

import gc
import weakref

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from kronfluence_tpu_torch import Analyzer, prepare_model
from kronfluence_tpu_torch.models import llama
from kronfluence_tpu_torch.utils.common.factor_arguments import (
    extreme_reduce_memory_factor_arguments,
    pytest_factor_arguments,
)
from kronfluence_tpu_torch.utils.common.score_arguments import (
    extreme_reduce_memory_score_arguments,
    pytest_score_arguments,
)

from tests.test_torch_llama import OpenWebTextTask
from tests.testable_tasks.language_modeling import make_lm, make_lm_data
from tests.testable_tasks.torch_language_modeling import make_torch_lm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, and one BLAS thread for numpy: the host
    eigendecomposition's `np.linalg.eigh` with OpenBLAS's thread team took
    138 s of one analysis beside other busy processes (8.6 s a call on 512
    dims), against under a second alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def _gpt2():
    """The tiny GPT-2 in fp64 and the test recipe."""
    _, params, _, config = make_lm()
    model, task, _ = make_torch_lm(params, config)
    train = make_lm_data(6, seq_len=config.max_seq_len, vocab=config.vocab_size, seed=0)
    query = make_lm_data(2, seq_len=config.max_seq_len, vocab=config.vocab_size, seed=1)
    return model, task, train, query, pytest_factor_arguments("ekfac"), pytest_score_arguments()


class _AttentionTask(OpenWebTextTask):
    def get_influence_tracked_modules(self):
        return [f"layers_{i}/attn/{proj}" for i in range(self.num_layers)
                for proj in ("q_proj", "k_proj", "v_proj", "o_proj")]


def _gemma_like():
    """A tiny Llama with Gemma-2B's attention layout (one KV head, head_dim
    256) in bf16 with attention="flash", its attention projections tracked,
    and the extreme-memory recipe: the Gemma path's layers on the CPU."""
    config = llama.tiny_llama_config(d_model=512, num_heads=2, num_kv_heads=1, max_seq_len=128,
                                     d_mlp=320, dtype=torch.bfloat16, attention="flash")
    module = llama.init_llama(config, seed=0, device="cpu")
    task = _AttentionTask(config.num_layers)
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, config.vocab_size, size=(6, config.max_seq_len)).astype(np.int32)
    train = {"input_ids": tokens, "attention_mask": np.ones_like(tokens)}
    query = {k: v[:2] for k, v in train.items()}
    return (prepare_model(module, task), task, train, query,
            extreme_reduce_memory_factor_arguments(strategy="ekfac"),
            extreme_reduce_memory_score_arguments(module_partitions=1))


def _analysis(tmp_path, name, build, profile, batch):
    """One analysis on a freshly built model; returns a weak reference to
    its module, with every strong reference dropped."""
    model, task, train, query, factor_args, score_args = build()
    ref = weakref.ref(model.module)
    analyzer = Analyzer(name, model, task, cpu=True, profile=profile,
                        output_dir=str(tmp_path / name))
    analyzer.fit_all_factors("f", train, per_device_batch_size=batch, factor_args=factor_args)
    analyzer.compute_pairwise_scores("s", "f", query, train, per_device_query_batch_size=2,
                                     per_device_train_batch_size=batch, score_args=score_args)
    analyzer.compute_self_scores("self", "f", train, per_device_train_batch_size=batch,
                                 score_args=score_args)
    del analyzer, model, task
    return ref


@pytest.mark.parametrize(
    "build, profile, batch",
    [(_gpt2, False, 3), (_gpt2, True, None), (_gemma_like, True, None)],
    ids=["given_batches", "estimated_batches_profiled", "flash_head_dim_256_bf16"])
def test_an_analysis_frees_its_model_without_the_collector(tmp_path, build, profile, batch):
    _analysis(tmp_path, "warm", build, profile, batch)
    gc.collect()
    gc.disable()
    try:
        ref = _analysis(tmp_path, "checked", build, profile, batch)
        held = ref() is not None
    finally:
        gc.enable()
    assert not held, "a reference cycle holds the model after the Analyzer is dropped"
