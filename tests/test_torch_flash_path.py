"""The flash-attention path of the port with the bench's query recipe, on the
tiny GPT-2 (2 layers, d 128, 2 heads of 64, T 128, vocab 128, padded data):

  * `attention="flash"` (F1-F3's plain versions on the CPU) through all four
    stages against the JAX package on its naive route, in fp64;
  * fp8 (e4m3fn) query blocks against the JAX package's fp8 scores;
  * the query-block sizer's integers against the JAX package's;
  * the two entry points that now default to the card.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from kronfluence_tpu.factor.covariance import (
    fit_covariance_matrices_with_loader as jax_fit_covariance,
)
from kronfluence_tpu.factor.eigen import (
    fit_lambda_matrices_with_loader as jax_fit_lambda,
    perform_eigendecomposition as jax_eigendecomposition,
)
from kronfluence_tpu.score.pairwise import (
    compute_pairwise_scores_with_loaders as jax_pairwise,
    resolve_query_accumulation as jax_resolve_query_accumulation,
)
from kronfluence_tpu.utils.common.factor_arguments import (
    pytest_factor_arguments as jax_factor_args,
)
from kronfluence_tpu.utils.common.score_arguments import (
    pytest_score_arguments as jax_score_args,
)
from kronfluence_tpu.utils import memory as jax_memory
from kronfluence_tpu.utils.dataset import BatchLoader as JaxBatchLoader
from kronfluence_tpu.utils.memory import max_queries_per_block as jax_max_queries_per_block
from kronfluence_tpu.utils.memory import probe_modules as jax_probe_modules
from kronfluence_tpu_torch.factor.covariance import fit_covariance_matrices_with_loader
from kronfluence_tpu_torch.factor.eigen import (
    fit_lambda_matrices_with_loader,
    perform_eigendecomposition,
)
from kronfluence_tpu_torch.models.transformer import init_transformer, tiny_config
from kronfluence_tpu_torch.ops.attention import naive_attention
from kronfluence_tpu_torch.ops.quantize import QuantizedGradient
from kronfluence_tpu_torch.score import pairwise as pairwise_mod
from kronfluence_tpu_torch.score.pairwise import (
    compute_pairwise_scores_with_loaders,
    resolve_query_accumulation,
)
from kronfluence_tpu_torch.utils.common.factor_arguments import pytest_factor_arguments
from kronfluence_tpu_torch.utils.common.score_arguments import pytest_score_arguments
from kronfluence_tpu_torch.utils.constants import (
    ACTIVATION_COVARIANCE_MATRIX_NAME,
    ACTIVATION_EIGENVALUES_NAME,
    ALL_MODULE_NAME,
    GRADIENT_COVARIANCE_MATRIX_NAME,
    GRADIENT_EIGENVALUES_NAME,
    LAMBDA_MATRIX_NAME,
)
from kronfluence_tpu_torch.utils import memory as torch_memory
from kronfluence_tpu_torch.utils.dataset import BatchLoader
from kronfluence_tpu_torch.utils.memory import max_queries_per_block, probe_modules

from tests.testable_tasks.language_modeling import make_lm, make_lm_data
from tests.testable_tasks.torch_language_modeling import make_torch_lm

# The reference's own equivalence tolerance (tests/test_reference_parity.py:61).
RTOL, ATOL = 1.3e-6, 1e-5
SEQ, D_MODEL, HEADS = 128, 128, 2
NUM_TRAIN, TRAIN_BATCH = 6, 3
NUM_QUERY, QUERY_BATCH = 4, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, and one BLAS thread for numpy's host eigh (see
    tests/test_torch_analyzer_release.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def path():
    jmodel, params, jtask, config = make_lm(
        max_seq_len=SEQ, d_model=D_MODEL, num_heads=HEADS, num_layers=2, vocab_size=128
    )
    tmodel, ttask, _ = make_torch_lm(params, config, attention="flash")
    train = make_lm_data(NUM_TRAIN, seq_len=SEQ, vocab=128, seed=0)
    query = make_lm_data(NUM_QUERY, seq_len=SEQ, vocab=128, seed=1)
    assert (train["attention_mask"] == 0).any() and (query["attention_mask"] == 0).any()
    jargs, targs = jax_factor_args("ekfac"), pytest_factor_arguments("ekfac")

    def jloader(data, batch):
        return JaxBatchLoader(data, batch)

    def tloader(data, batch):
        return BatchLoader(data, batch, device="cpu")

    calls = naive_attention.calls
    jcov = jax_fit_covariance(jmodel, params, jtask, jloader(train, TRAIN_BATCH), jargs)
    jeig = jax_eigendecomposition(jcov, jargs)
    jlam = jax_fit_lambda(jmodel, params, jtask, jloader(train, TRAIN_BATCH), jargs,
                          eigen_factors=jeig)
    tcov = fit_covariance_matrices_with_loader(tmodel, ttask, tloader(train, TRAIN_BATCH), targs)
    teig = perform_eigendecomposition(tcov, targs)
    tlam = fit_lambda_matrices_with_loader(tmodel, ttask, tloader(train, TRAIN_BATCH), targs,
                                           eigen_factors=teig)
    assert naive_attention.calls == calls, "the flash model ran the naive form"
    return dict(
        jmodel=jmodel, params=params, jtask=jtask, tmodel=tmodel, ttask=ttask, train=train,
        query=query, jargs=jargs, targs=targs, jloader=jloader, tloader=tloader,
        jf={**jcov, **jeig, **jlam}, tf={**tcov, **teig, **tlam},
    )


def _scores(p, jscore, tscore):
    want = jax_pairwise(
        p["jmodel"], p["params"], p["jtask"], p["jloader"](p["query"], QUERY_BATCH),
        p["jloader"](p["train"], TRAIN_BATCH), p["jf"], p["jargs"], jscore,
    )
    got = compute_pairwise_scores_with_loaders(
        p["tmodel"], p["ttask"], p["tloader"](p["query"], QUERY_BATCH),
        p["tloader"](p["train"], TRAIN_BATCH), p["tf"], p["targs"], tscore,
    )
    return got[ALL_MODULE_NAME].numpy(), np.asarray(want[ALL_MODULE_NAME])


@pytest.mark.parametrize(
    "factor_name",
    [ACTIVATION_COVARIANCE_MATRIX_NAME, GRADIENT_COVARIANCE_MATRIX_NAME,
     ACTIVATION_EIGENVALUES_NAME, GRADIENT_EIGENVALUES_NAME, LAMBDA_MATRIX_NAME],
)
def test_flash_factors_match_jax_naive(path, factor_name):
    """Lambda and the eigenvalues are sign-invariant in the eigenvectors."""
    want, got = path["jf"][factor_name], path["tf"][factor_name]
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=RTOL, atol=ATOL)


def test_flash_scores_match_jax_naive(path):
    calls = naive_attention.calls
    got, want = _scores(path, jax_score_args(), pytest_score_arguments())
    assert naive_attention.calls == calls
    assert got.shape == (NUM_QUERY, NUM_TRAIN)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_fp8_query_blocks_match_jax_fp8_scores(path, monkeypatch):
    """fp8 e4m3fn blocks, 2 accumulation steps (the chunks are merged). Both
    packages quantize fp64 gradients that agree to ~1e-12; on this data every
    payload element rounds alike, so the scores differ by fp64 summation
    order only: limit 1e-9 of max |score|. (fp8 and dense fp64 scores differ
    by 0.83 of max |score| here: damping 1e-8 amplifies fp8's element noise,
    which is why the JAX package warns about fp8 at near-zero damping.)"""
    blocks = []
    original = pairwise_mod._collect_blocks
    monkeypatch.setattr(
        pairwise_mod, "_collect_blocks", lambda b: blocks.append(original(b)) or blocks[-1]
    )
    jscore, tscore = jax_score_args(), pytest_score_arguments()
    for args in (jscore, tscore):
        args.query_gradient_storage_dtype = "float8_e4m3fn"
        args.query_gradient_accumulation_steps = 2
    got, want = _scores(path, jscore, tscore)
    assert len(blocks) == 1
    assert all(len(c) == 1 and isinstance(c[0], QuantizedGradient) for c in blocks[0].values())
    assert all(c[0].data.dtype == torch.float8_e4m3fn and c[0].shape[0] == NUM_QUERY
               for c in blocks[0].values())
    assert compute_pairwise_scores_with_loaders.last_run["formats"] == [
        "QuantizedGradient[torch.float8_e4m3fn]"
    ]
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * scale)
    dense, _ = _scores(path, jax_score_args(), pytest_score_arguments())
    assert np.abs(got - dense).max() > 1e-2 * scale  # the fp8 path really quantized


@pytest.mark.parametrize("storage", [None, "float8_e4m3fn"])
@pytest.mark.parametrize("budget", [2e7, 6e7, 1e9])
def test_max_queries_per_block_matches_jax(path, storage, budget):
    jscore, tscore = jax_score_args(), pytest_score_arguments()
    jscore.query_gradient_storage_dtype = tscore.query_gradient_storage_dtype = storage
    jbatch, _ = next(iter(path["jloader"](path["query"], QUERY_BATCH)))
    tbatch, _ = next(iter(path["tloader"](path["query"], QUERY_BATCH)))
    jprobes = jax_probe_modules(path["jmodel"], path["jtask"], path["params"], jbatch, QUERY_BATCH)
    tprobes = probe_modules(path["tmodel"], path["ttask"], tbatch, QUERY_BATCH)
    def facts(probes):
        return {n: (p.tokens, p.uses, p.spec.kind, p.spec.has_bias, p.spec.in_dim, p.spec.out_dim)
                for n, p in probes.items()}

    assert facts(tprobes) == facts(jprobes)
    common = dict(train_batch_size=TRAIN_BATCH, num_train=NUM_TRAIN, budget_bytes=budget,
                  query_batch_size=QUERY_BATCH)
    want = jax_max_queries_per_block(jprobes, jscore, params=path["params"], **common)
    got = max_queries_per_block(tprobes, tscore, params=path["tmodel"].module, **common)
    assert got == want and 1 <= got <= 4096


@pytest.mark.parametrize("taken_gib,expected", [(0.0, 20), (13.46, 15), (13.47, 2), (13.5, 1)])
def test_resolve_query_accumulation_matches_jax(path, monkeypatch, taken_gib, expected):
    """Both packages plan against 0.9 of the device limit (15 GiB on the
    CPU). With the limit lowered so the budget is `taken_gib` under
    15 GiB x 0.9 on both sides, the block holds the whole query set (20
    batches, the cap), 15 batches, 2, or none (at least 1)."""
    limit = 15 * 2**30 - taken_gib * 2**30 / 0.9
    monkeypatch.setattr(jax_memory, "_device_hbm_limit", lambda: limit)
    monkeypatch.setattr(torch_memory, "device_memory_limit", lambda device: limit)
    jscore, tscore = jax_score_args(), pytest_score_arguments()
    jscore.query_gradient_storage_dtype = tscore.query_gradient_storage_dtype = "float8_e4m3fn"
    many = make_lm_data(40, seq_len=SEQ, vocab=128, seed=2)
    jq, tq = path["jloader"](many, QUERY_BATCH), path["tloader"](many, QUERY_BATCH)
    want = jax_resolve_query_accumulation(
        path["jmodel"], path["jtask"], path["params"], next(iter(jq))[0], jq,
        path["jloader"](path["train"], TRAIN_BATCH), jscore,
    )
    got = resolve_query_accumulation(
        path["tmodel"], path["ttask"], next(iter(tq))[0], tq,
        path["tloader"](path["train"], TRAIN_BATCH), tscore,
    )
    assert got == want == expected


def test_max_queries_per_block_needs_a_budget_or_device(path):
    tbatch, _ = next(iter(path["tloader"](path["query"], QUERY_BATCH)))
    probes = probe_modules(path["tmodel"], path["ttask"], tbatch, QUERY_BATCH)
    with pytest.raises(ValueError, match="budget_bytes or the device"):
        max_queries_per_block(probes, pytest_score_arguments())


def test_auto_accumulation_scores_match_explicit(path):
    """`query_gradient_accumulation_steps=None` runs the sizer (15 GiB on the
    CPU: one block of all queries) and scores as the explicit count does."""
    auto, explicit = pytest_score_arguments(), pytest_score_arguments()
    auto.query_gradient_accumulation_steps = None
    explicit.query_gradient_accumulation_steps = NUM_QUERY // QUERY_BATCH
    runs = []
    for args in (auto, explicit):
        runs.append(compute_pairwise_scores_with_loaders(
            path["tmodel"], path["ttask"], path["tloader"](path["query"], QUERY_BATCH),
            path["tloader"](path["train"], TRAIN_BATCH), path["tf"], path["targs"], args,
        )[ALL_MODULE_NAME])
        if args is auto:
            assert compute_pairwise_scores_with_loaders.last_run == dict(
                accumulation=NUM_QUERY // QUERY_BATCH, blocks=1, formats=["Tensor[torch.float64]"]
            )
    assert torch.equal(runs[0], runs[1])


def test_batch_loader_defaults_to_the_card():
    """Constructing a loader touches no device; its batches go to cuda."""
    loader = BatchLoader({"x": np.zeros((4, 2), np.float32)}, 2)
    assert loader.device == torch.device("cuda")


@pytest.mark.cuda
def test_init_transformer_defaults_to_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model = init_transformer(tiny_config(), seed=0)
    assert all(p.device.type == "cuda" for p in model.parameters())
