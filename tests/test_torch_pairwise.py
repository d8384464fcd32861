"""The whole slice (covariance -> eigendecomposition -> lambda -> pairwise)
of the port against kronfluence_tpu on the tiny GPT-2."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from kronfluence_tpu.arguments import FactorArguments as JaxFactorArguments
from kronfluence_tpu.arguments import ScoreArguments as JaxScoreArguments
from kronfluence_tpu.factor.covariance import (
    fit_covariance_matrices_with_loader as jax_fit_covariance,
)
from kronfluence_tpu.factor.eigen import (
    fit_lambda_matrices_with_loader as jax_fit_lambda,
    perform_eigendecomposition as jax_eigendecomposition,
)
from kronfluence_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from kronfluence_tpu.prepare import prepare_model as jax_prepare
from kronfluence_tpu.score.pairwise import (
    compute_pairwise_scores_with_loaders as jax_pairwise,
)
from kronfluence_tpu.utils.common.factor_arguments import (
    pytest_factor_arguments as jax_factor_args,
)
from kronfluence_tpu.utils.common.score_arguments import (
    pytest_score_arguments as jax_score_args,
)
from kronfluence_tpu.utils.dataset import BatchLoader as JaxBatchLoader
from kronfluence_tpu_torch.arguments import FactorArguments, ScoreArguments
from kronfluence_tpu_torch.factor.covariance import fit_covariance_matrices_with_loader
from kronfluence_tpu_torch.factor.eigen import (
    fit_lambda_matrices_with_loader,
    perform_eigendecomposition,
)
from kronfluence_tpu_torch.score.pairwise import compute_pairwise_scores_with_loaders
from kronfluence_tpu_torch.utils.common.factor_arguments import pytest_factor_arguments
from kronfluence_tpu_torch.utils.common.score_arguments import pytest_score_arguments
from kronfluence_tpu_torch.utils.constants import ALL_MODULE_NAME
from kronfluence_tpu_torch.utils.dataset import BatchLoader

from tests.testable_tasks.language_modeling import LanguageModelingTask, make_lm, make_lm_data
from tests.testable_tasks.torch_language_modeling import make_torch_lm

# The reference's own equivalence tolerance (tests/test_reference_parity.py:61).
RTOL, ATOL = 1.3e-6, 1e-5
NUM_TRAIN, TRAIN_BATCH = 10, 4
NUM_QUERY = 5


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread for numpy's host eigh: OpenBLAS's thread team spins
    against the suite's other workers (tests/test_torch_analyzer_release.py)."""
    with threadpool_limits(limits=1):
        yield


def _factors(jmodel, params, jtask, tmodel, ttask, train, jargs, targs):
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
    return {**jcov, **jeig, **jlam}, {**tcov, **teig, **tlam}


@pytest.fixture(scope="module")
def fp64():
    jmodel, params, jtask, config = make_lm()
    tmodel, ttask, _ = make_torch_lm(params, config)
    train = make_lm_data(NUM_TRAIN, seq_len=config.max_seq_len, vocab=config.vocab_size, seed=0)
    query = make_lm_data(NUM_QUERY, seq_len=config.max_seq_len, vocab=config.vocab_size, seed=1)
    jargs, targs = jax_factor_args("ekfac"), pytest_factor_arguments("ekfac")
    jf, tf = _factors(jmodel, params, jtask, tmodel, ttask, train, jargs, targs)
    return dict(
        jmodel=jmodel, params=params, jtask=jtask, tmodel=tmodel, ttask=ttask, config=config,
        train=train, query=query, jargs=jargs, targs=targs, jf=jf, tf=tf,
    )


def _scores(s, query_batch, jscore, tscore):
    want = jax_pairwise(
        s["jmodel"], s["params"], s["jtask"], JaxBatchLoader(s["query"], query_batch),
        JaxBatchLoader(s["train"], TRAIN_BATCH), s["jf"], s["jargs"], jscore,
    )
    got = compute_pairwise_scores_with_loaders(
        s["tmodel"], s["ttask"], BatchLoader(s["query"], query_batch, device="cpu"),
        BatchLoader(s["train"], TRAIN_BATCH, device="cpu"), s["tf"], s["targs"], tscore,
    )
    assert set(got) == set(want)
    return got, want


def test_fp64_slice_matches(fp64):
    got, want = _scores(fp64, 2, jax_score_args(), pytest_score_arguments())
    got, want = got[ALL_MODULE_NAME], np.asarray(want[ALL_MODULE_NAME])
    assert got.shape == (NUM_QUERY, NUM_TRAIN) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("option", ["accumulation_2_ragged", "per_module", "per_token"])
def test_fp64_score_options_match(fp64, option):
    """accumulation_2_ragged: 5 queries in batches of 2 with 2 accumulation
    steps, so the second block is one real batch plus a padded repeat."""
    jscore, tscore = jax_score_args(), pytest_score_arguments()
    if option == "accumulation_2_ragged":
        jscore.query_gradient_accumulation_steps = 2
        tscore.query_gradient_accumulation_steps = 2
    elif option == "per_module":
        jscore.compute_per_module_scores = tscore.compute_per_module_scores = True
    else:
        jscore.compute_per_token_scores = tscore.compute_per_token_scores = True
    got, want = _scores(fp64, 2, jscore, tscore)
    for key in want:
        assert got[key].shape[:2] == (NUM_QUERY, NUM_TRAIN)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=RTOL, atol=ATOL)


def test_fp32_recipe_matches(fp64):
    """fp32 model and the default fp32 recipe on both sides, heuristic
    damping. Both use host fp32 LAPACK eigh; the gap is fp32 summation order
    grown by the preconditioner: held at 1e-4 of the largest score."""
    config = dataclasses.replace(fp64["config"], dtype=jnp.float32, param_dtype=jnp.float32)
    params = jax.tree_util.tree_map(lambda p: p.astype(jnp.float32), fp64["params"])
    jtask = LanguageModelingTask()
    jmodel = jax_prepare(FlaxTransformerLM(config), jtask)
    tmodel, ttask, _ = make_torch_lm(params, config, dtype=torch.float32)
    train = make_lm_data(NUM_TRAIN, seq_len=config.max_seq_len, vocab=config.vocab_size, seed=0)
    query = make_lm_data(NUM_QUERY, seq_len=config.max_seq_len, vocab=config.vocab_size, seed=1)
    common = dict(use_empirical_fisher=True, eigendecomposition_dtype="float32")
    jargs, targs = JaxFactorArguments(**common), FactorArguments(**common)
    jf, tf = _factors(jmodel, params, jtask, tmodel, ttask, train, jargs, targs)
    s = dict(
        jmodel=jmodel, params=params, jtask=jtask, tmodel=tmodel, ttask=ttask,
        train=train, query=query, jargs=jargs, targs=targs, jf=jf, tf=tf,
    )
    got, want = _scores(
        s, 2, JaxScoreArguments(damping_factor=None), ScoreArguments(damping_factor=None)
    )
    got, want = got[ALL_MODULE_NAME], np.asarray(want[ALL_MODULE_NAME])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
