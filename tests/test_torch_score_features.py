"""The remaining score features of the port against kronfluence_tpu on the
tiny GPT-2 in fp64: low-rank query blocks (full and randomized SVD),
aggregated query and train gradients, their memory-model terms, and the
float8 low-damping warning."""

import logging

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from kronfluence_tpu.analyzer import Analyzer as JaxAnalyzer
from kronfluence_tpu.arguments import ScoreArguments as JaxScoreArguments
from kronfluence_tpu.factor.covariance import (
    fit_covariance_matrices_with_loader as jax_fit_covariance,
)
from kronfluence_tpu.factor.eigen import (
    fit_lambda_matrices_with_loader as jax_fit_lambda,
    perform_eigendecomposition as jax_eigendecomposition,
)
from kronfluence_tpu.ops.scores import pairwise_score as jax_pairwise_score
from kronfluence_tpu.score.pairwise import (
    compute_pairwise_scores_with_loaders as jax_pairwise,
)
from kronfluence_tpu.utils import memory as jax_memory
from kronfluence_tpu.utils.common.factor_arguments import (
    pytest_factor_arguments as jax_factor_args,
)
from kronfluence_tpu.utils.common.score_arguments import (
    pytest_score_arguments as jax_score_args,
)
from kronfluence_tpu.utils.dataset import BatchLoader as JaxBatchLoader
from kronfluence_tpu_torch import Analyzer
from kronfluence_tpu_torch.arguments import ScoreArguments
from kronfluence_tpu_torch.factor.covariance import fit_covariance_matrices_with_loader
from kronfluence_tpu_torch.factor.eigen import (
    fit_lambda_matrices_with_loader,
    perform_eigendecomposition,
)
from kronfluence_tpu_torch.ops.scores import lowrank_route, pairwise_score
from kronfluence_tpu_torch.ops.svd import goes_lowrank
from kronfluence_tpu_torch.score.pairwise import compute_pairwise_scores_with_loaders
from kronfluence_tpu_torch.utils import memory
from kronfluence_tpu_torch.utils.common.factor_arguments import pytest_factor_arguments
from kronfluence_tpu_torch.utils.common.score_arguments import pytest_score_arguments
from kronfluence_tpu_torch.utils.constants import ALL_MODULE_NAME
from kronfluence_tpu_torch.utils.dataset import BatchLoader

from tests.testable_tasks.language_modeling import LanguageModelingTask, make_lm, make_lm_data
from tests.testable_tasks.torch_language_modeling import (
    TorchLanguageModelingTask,
    make_torch_lm,
)

# The reference's own equivalence tolerance (tests/test_reference_parity.py:61).
RTOL, ATOL = 1.3e-6, 1e-5
# The sum identities (tests/test_scores.py: aggregated scores against the
# row and column sums of the pairwise scores).
SUM_RTOL = 1e-8
NUM_TRAIN, TRAIN_BATCH = 10, 4
NUM_QUERY, QUERY_BATCH = 5, 2
# Rank 8 compresses every tracked module of the tiny GPT-2 (min(o, i) >= 32);
# at rank 32 only c_attn (96 x 33), c_fc (128 x 33) and the head go low-rank.
RANK = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lm():
    jmodel, params, jtask, config = make_lm()
    tmodel, ttask, _ = make_torch_lm(params, config)
    train = make_lm_data(NUM_TRAIN, seq_len=config.max_seq_len, vocab=config.vocab_size, seed=0)
    query = make_lm_data(NUM_QUERY, seq_len=config.max_seq_len, vocab=config.vocab_size, seed=1)
    jargs, targs = jax_factor_args("ekfac"), pytest_factor_arguments("ekfac")
    jcov = jax_fit_covariance(jmodel, params, jtask, JaxBatchLoader(train, TRAIN_BATCH), jargs)
    jeig = jax_eigendecomposition(jcov, jargs)
    jlam = jax_fit_lambda(
        jmodel, params, jtask, JaxBatchLoader(train, TRAIN_BATCH), jargs, eigen_factors=jeig
    )
    tcov = fit_covariance_matrices_with_loader(
        tmodel, ttask, BatchLoader(train, TRAIN_BATCH, device="cpu"), targs
    )
    teig = perform_eigendecomposition(tcov, targs)
    tlam = fit_lambda_matrices_with_loader(
        tmodel, ttask, BatchLoader(train, TRAIN_BATCH, device="cpu"), targs, eigen_factors=teig
    )
    return dict(
        jmodel=jmodel, params=params, jtask=jtask, tmodel=tmodel, ttask=ttask, config=config,
        train=train, query=query, jargs=jargs, targs=targs,
        jf={**jcov, **jeig, **jlam}, tf={**tcov, **teig, **tlam},
    )


def _args(**fields):
    """(JAX, port) fp64 score arguments with `fields` set on both."""
    jscore, tscore = jax_score_args(), pytest_score_arguments()
    for name, value in fields.items():
        setattr(jscore, name, value)
        setattr(tscore, name, value)
    return jscore, tscore


def _port(s, tscore, query_batch=QUERY_BATCH, task=None):
    return compute_pairwise_scores_with_loaders(
        s["tmodel"], task or s["ttask"], BatchLoader(s["query"], query_batch, device="cpu"),
        BatchLoader(s["train"], TRAIN_BATCH, device="cpu"), s["tf"], s["targs"], tscore,
    )


def _jax(s, jscore, query_batch=QUERY_BATCH, task=None):
    return jax_pairwise(
        s["jmodel"], s["params"], task or s["jtask"], JaxBatchLoader(s["query"], query_batch),
        JaxBatchLoader(s["train"], TRAIN_BATCH), s["jf"], s["jargs"], jscore,
    )


def _match(got, want):
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == np.asarray(want[key]).shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "option,query_batch",
    [("per_sequence", QUERY_BATCH), ("per_token", QUERY_BATCH), ("per_module", QUERY_BATCH),
     ("rank_32_mixed", QUERY_BATCH), ("one_block_of_5", NUM_QUERY)],
)
def test_lowrank_full_svd_matches_jax(lm, option, query_batch):
    """The full SVD is exact, so both packages score the same rank-r blocks.
    rank_32_mixed keeps the modules whose min(o, i) is 32 dense; one_block_of_5
    scores all queries as one chunk, where c_fc takes the rebuild route."""
    fields = dict(query_gradient_low_rank=RANK, use_full_svd=True)
    if option == "per_token":
        fields["compute_per_token_scores"] = True
    elif option == "per_module":
        fields["compute_per_module_scores"] = True
    elif option == "rank_32_mixed":
        fields["query_gradient_low_rank"] = 32
    jscore, tscore = _args(**fields)
    got = _port(lm, tscore, query_batch)
    formats = compute_pairwise_scores_with_loaders.last_run["formats"]
    if option == "rank_32_mixed":
        assert formats == ["LowRank[torch.float64]", "Tensor[torch.float64]"]
    else:
        assert formats == ["LowRank[torch.float64]"]
    _match(got, _jax(lm, jscore, query_batch))


class _PostProcessed:
    """Doubles one module's per-sample gradients (queries and train)."""

    enable_post_process_per_sample_gradient = True

    def post_process_per_sample_gradient(self, module_name, gradient):
        return gradient * 2.0 if module_name == "h_0/mlp/c_fc" else gradient


class _JaxPostProcessed(_PostProcessed, LanguageModelingTask):
    pass


class _TorchPostProcessed(_PostProcessed, TorchLanguageModelingTask):
    pass


def test_lowrank_with_post_process_matches_jax(lm):
    jscore, tscore = _args(query_gradient_low_rank=RANK, use_full_svd=True)
    got = _port(lm, tscore, task=_TorchPostProcessed())
    _match(got, _jax(lm, jscore, task=_JaxPostProcessed()))


def test_lowrank_accumulation_is_one_batch(lm):
    """The randomized sketch is seeded by the query batch's index, so the
    factors do not depend on the accumulation: blocks of 2 and 3 batches
    give the same scores bit for bit (each chunk is scored alone against the
    same per-sample gradients), and one batch a block (each chunk scored
    from the tokens) the same up to fp64 summation order."""
    scores = {}
    for steps in (1, 2, 3):
        _, tscore = _args(query_gradient_low_rank=RANK, query_gradient_accumulation_steps=steps)
        scores[steps] = _port(lm, tscore)[ALL_MODULE_NAME]
        assert scores[steps].shape == (NUM_QUERY, NUM_TRAIN)
    assert torch.equal(scores[2], scores[3])
    scale = float(scores[2].abs().max())
    np.testing.assert_allclose(scores[1].numpy(), scores[2].numpy(), rtol=0, atol=1e-12 * scale)
    jscore, tscore = _args(
        query_gradient_low_rank=RANK, use_full_svd=True, query_gradient_accumulation_steps=2
    )
    _match(_port(lm, tscore), _jax(lm, jscore))


def _pearson(a, b):
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


@pytest.mark.parametrize("use_full_svd", [False, True])
def test_lowrank_correlates_with_dense(lm, use_full_svd):
    """As tests/test_scores.py holds the JAX package: Pearson r above 0.95."""
    dense = _port(lm, pytest_score_arguments())[ALL_MODULE_NAME]
    _, tscore = _args(query_gradient_low_rank=RANK, use_full_svd=use_full_svd)
    lowrank = _port(lm, tscore)[ALL_MODULE_NAME]
    assert _pearson(dense.numpy(), lowrank.numpy()) > 0.95


@pytest.mark.parametrize(
    "q,o,i,r,b,t,per_token",
    [(2, 128, 33, 8, 4, 32, False), (16, 96, 33, 4, 2, 32, False), (2, 128, 33, 8, 4, 32, True)],
    ids=["tokens", "rebuild", "per_token"],
)
def test_lowrank_contraction_matches_jax(q, o, i, r, b, t, per_token):
    """Each order of ops/scores.py against the JAX package's einsum."""
    if not per_token:
        assert lowrank_route(q, o, i, r, b, t) == ("tokens" if q == 2 else "rebuild")
    rng = np.random.default_rng(q + r)
    left, right = rng.standard_normal((q, o, r)), rng.standard_normal((q, r, i))
    a_tok, g_tok = rng.standard_normal((b, t, i)), rng.standard_normal((b, t, o))
    got = pairwise_score(
        (torch.from_numpy(left), torch.from_numpy(right)), torch.from_numpy(a_tok),
        torch.from_numpy(g_tok), per_token, torch.float64,
    )
    want = np.asarray(
        jax_pairwise_score((left, right), a_tok, g_tok, per_token, np.float64)
    )
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["query", "train", "both"])
def test_aggregated_scores_match_jax_and_the_sums(lm, mode):
    fields = {}
    if mode in ("query", "both"):
        fields["aggregate_query_gradients"] = True
    if mode in ("train", "both"):
        fields["aggregate_train_gradients"] = True
    jscore, tscore = _args(**fields)
    got = _port(lm, tscore)
    _match(got, _jax(lm, jscore))
    dense = _port(lm, pytest_score_arguments())[ALL_MODULE_NAME].numpy()
    want = {"query": dense.sum(0, keepdims=True), "train": dense.sum(1, keepdims=True),
            "both": dense.sum(keepdims=True).reshape(1, 1)}[mode]
    np.testing.assert_allclose(got[ALL_MODULE_NAME].numpy(), want, rtol=SUM_RTOL,
                               atol=SUM_RTOL * np.abs(dense).sum())


@pytest.mark.parametrize(
    "fields",
    [dict(query_gradient_low_rank=RANK, use_full_svd=True, aggregate_train_gradients=True),
     dict(aggregate_query_gradients=True, compute_per_module_scores=True),
     dict(query_gradient_storage_dtype="float8_e4m3fn", aggregate_train_gradients=True)],
    ids=["lowrank_train", "query_per_module", "fp8_train"],
)
def test_aggregated_variants_match_jax(lm, fields):
    jscore, tscore = _args(**fields)
    _match(_port(lm, tscore), _jax(lm, jscore))


@pytest.mark.parametrize("mode", ["query", "train", "both"])
def test_aggregation_under_remat_is_bitwise(lm, mode):
    fields = dict(aggregate_query_gradients=mode != "train",
                  aggregate_train_gradients=mode != "query")
    _, plain = _args(**fields)
    _, remat = _args(offload_activations_to_cpu=True, **fields)
    got, want = _port(lm, remat), _port(lm, plain)
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.fixture(scope="module")
def analyzers(lm, tmp_path_factory):
    """Both packages' Analyzers with factors fitted on the same data."""
    jdir, tdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    jax_analyzer = JaxAnalyzer("lm", lm["jmodel"], lm["jtask"], params=lm["params"], cpu=True,
                               output_dir=str(jdir))
    port_analyzer = Analyzer("lm", lm["tmodel"], lm["ttask"], cpu=True, output_dir=str(tdir))
    jax_analyzer.fit_all_factors("ekfac", lm["train"], per_device_batch_size=TRAIN_BATCH,
                                 factor_args=jax_factor_args("ekfac"))
    port_analyzer.fit_all_factors("ekfac", lm["train"], per_device_batch_size=TRAIN_BATCH,
                                  factor_args=pytest_factor_arguments("ekfac"))
    return jax_analyzer, port_analyzer


def _both_analyzers(lm, analyzers, name, **fields):
    jax_analyzer, port_analyzer = analyzers
    jscore, tscore = _args(**fields)
    for analyzer, args in ((jax_analyzer, jscore), (port_analyzer, tscore)):
        analyzer.compute_pairwise_scores(
            name, "ekfac", lm["query"], lm["train"], per_device_query_batch_size=QUERY_BATCH,
            per_device_train_batch_size=TRAIN_BATCH, score_args=args,
        )
    return port_analyzer.load_pairwise_scores(name), jax_analyzer.load_pairwise_scores(name)


def test_aggregated_train_with_data_partitions_matches_jax(lm, analyzers):
    """The JAX package concatenates one column per data partition (it does
    not sum them); the port follows it."""
    got, want = _both_analyzers(lm, analyzers, "agg_parts", aggregate_train_gradients=True,
                                data_partitions=2)
    assert got[ALL_MODULE_NAME].shape == (NUM_QUERY, 2)
    _match(got, want)
    dense = _port(lm, pytest_score_arguments())[ALL_MODULE_NAME]
    split = -(-NUM_TRAIN // 2)  # the partitions' train ranges: 5 and 5
    columns = torch.stack([dense[:, :split].sum(1), dense[:, split:].sum(1)], 1)
    np.testing.assert_allclose(got[ALL_MODULE_NAME].numpy(), columns.numpy(), rtol=SUM_RTOL,
                               atol=SUM_RTOL * float(dense.abs().sum()))


def test_lowrank_through_the_analyzer_matches_jax(lm, analyzers):
    got, want = _both_analyzers(lm, analyzers, "lowrank", query_gradient_low_rank=RANK,
                                use_full_svd=True, query_gradient_storage_dtype="float8_e4m3fn")
    _match(got, want)


@pytest.fixture(scope="module")
def probes(lm):
    jbatch, _ = JaxBatchLoader(lm["train"], QUERY_BATCH).probe()
    tbatch, _ = BatchLoader(lm["train"], QUERY_BATCH, device="cpu").probe()
    return (jax_memory.probe_modules(lm["jmodel"], lm["jtask"], lm["params"], jbatch, QUERY_BATCH),
            memory.probe_modules(lm["tmodel"], lm["ttask"], tbatch, QUERY_BATCH))


@pytest.mark.parametrize("storage", [None, "float8_e4m3fn"])
@pytest.mark.parametrize("rank", [None, 8, 32, 64])
def test_query_block_sizes_with_a_rank_match_jax(probes, lm, rank, storage):
    jprobes, tprobes = probes
    fields = dict(query_gradient_low_rank=rank, query_gradient_storage_dtype=storage,
                  score_dtype="bfloat16", per_sample_gradient_dtype="bfloat16")
    jargs, targs = JaxScoreArguments(**fields), ScoreArguments(**fields)
    for n in (1, 7):
        assert memory.query_block_bytes(tprobes, targs, n) == jax_memory.query_block_bytes(
            jprobes, jargs, n)
    for reserve in (0.0, 3e7):
        kw = dict(train_batch_size=TRAIN_BATCH, num_train=100, budget_bytes=2e8,
                  query_batch_size=2, reserve_bytes=reserve)
        assert memory.max_queries_per_block(
            tprobes, targs, params=lm["tmodel"].module, **kw
        ) == jax_memory.max_queries_per_block(jprobes, jargs, params=lm["params"], **kw)


@pytest.mark.parametrize("storage", [None, "float8_e4m3fn"])
def test_aggregated_query_block_is_one_dense_row(probes, storage):
    """An aggregated block holds one dense row a module in the score dtype,
    whatever rank or storage dtype is set: the query step's rule
    (`goes_lowrank`) and the memory model agree."""
    _, tprobes = probes
    fields = dict(query_gradient_storage_dtype=storage, score_dtype="bfloat16")
    dense = memory.query_block_bytes(tprobes, ScoreArguments(score_dtype="bfloat16"), 1)
    aggregated = ScoreArguments(aggregate_query_gradients=True, query_gradient_low_rank=RANK,
                                **fields)
    assert memory.query_block_bytes(tprobes, aggregated, 1) == dense
    assert memory.lowrank_transient_bytes(tprobes, aggregated, 2, TRAIN_BATCH) == 0
    assert not any(goes_lowrank(p.spec.activation_dim, p.spec.gradient_dim, aggregated)
                   for p in tprobes.values())
    assert any(goes_lowrank(p.spec.activation_dim, p.spec.gradient_dim,
                            ScoreArguments(query_gradient_low_rank=RANK))
               for p in tprobes.values())


def test_factor_bytes_count_the_device_tensors(lm):
    factors = lm["tf"]
    want = sum(t.nbytes for per_module in factors.values() for t in per_module.values())
    assert memory.factor_bytes_on(factors, "cpu") == want > 0
    assert memory.factor_bytes_on(factors, "meta") == 0


def test_lowrank_block_is_smaller_and_its_transient_is_planned_on_the_card(probes):
    _, tprobes = probes
    dense, lowrank = ScoreArguments(), ScoreArguments(query_gradient_low_rank=RANK)
    assert memory.query_block_bytes(tprobes, lowrank, 1) < memory.query_block_bytes(
        tprobes, dense, 1)
    assert memory.lowrank_transient_bytes(tprobes, dense, 2, TRAIN_BATCH) == 0
    # A chunk of 2 queries against 4 examples of 32 tokens: the token route's
    # 2 x (2 x 4 x 32 x 8) = 4,096 elements, or a rebuilt (2, o, i) chunk
    # where the per-sample gradients are materialized, 2 x 128 x 33 = 8,448
    # at c_fc and the head: the largest, in fp32.
    assert memory.lowrank_transient_bytes(tprobes, lowrank, 2, TRAIN_BATCH) == 8448 * 4
    budget = dict(train_batch_size=TRAIN_BATCH, num_train=100, budget_bytes=5e6,
                  query_batch_size=2)
    assert memory.max_queries_per_block(tprobes, lowrank, device="cuda", **budget) < (
        memory.max_queries_per_block(tprobes, lowrank, **budget))


@pytest.mark.parametrize(
    "storage,damping,warns",
    [("float8_e4m3fn", 1e-8, True), ("float8_e4m3fn", None, False),
     ("float8_e4m3fn", 1e-3, False), (None, 1e-8, False), ("bfloat16", 1e-8, False)],
)
def test_fp8_low_damping_warns_as_jax(lm, caplog, storage, damping, warns):
    _, tscore = _args(query_gradient_storage_dtype=storage, damping_factor=damping)
    with caplog.at_level(logging.WARNING, logger="kronfluence_tpu_torch"):
        _port(lm, tscore)
    said = [r.getMessage() for r in caplog.records if "near-zero damping" in r.getMessage()]
    assert bool(said) == warns
    if warns:
        assert "damping_factor=1e-08" in said[0] and "damping_factor=None" in said[0]
