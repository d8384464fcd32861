"""Factor stages of the port (covariance, eigendecomposition, lambda) against
kronfluence_tpu in fp64 on the tiny GPT-2, through the pytest_* recipes."""

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
from kronfluence_tpu.prepare import prepare_model as jax_prepare
from kronfluence_tpu.utils.common.factor_arguments import (
    pytest_factor_arguments as jax_factor_args,
)
from kronfluence_tpu.utils.dataset import BatchLoader as JaxBatchLoader
from kronfluence_tpu_torch.factor.covariance import fit_covariance_matrices_with_loader
from kronfluence_tpu_torch.factor.eigen import (
    _device_eigendecomposition,
    fit_lambda_matrices_with_loader,
    perform_eigendecomposition,
)
from kronfluence_tpu_torch.utils.common.factor_arguments import pytest_factor_arguments
from kronfluence_tpu_torch.utils.constants import (
    ACTIVATION_COVARIANCE_MATRIX_NAME,
    ACTIVATION_EIGENVALUES_NAME,
    ACTIVATION_EIGENVECTORS_NAME,
    GRADIENT_COVARIANCE_MATRIX_NAME,
    GRADIENT_EIGENVALUES_NAME,
    GRADIENT_EIGENVECTORS_NAME,
    LAMBDA_MATRIX_NAME,
    NUM_ACTIVATION_COVARIANCE_PROCESSED,
    NUM_GRADIENT_COVARIANCE_PROCESSED,
    NUM_LAMBDA_PROCESSED,
)
from kronfluence_tpu_torch.utils.dataset import BatchLoader

from tests.testable_tasks.language_modeling import LanguageModelingTask, make_lm, make_lm_data
from tests.testable_tasks.torch_language_modeling import (
    TorchLanguageModelingTask,
    make_torch_lm,
)

# 10 examples in batches of 4: the last batch is padded and masked.
NUM_TRAIN, BATCH = 10, 4
PAIRS = (
    (ACTIVATION_COVARIANCE_MATRIX_NAME, NUM_ACTIVATION_COVARIANCE_PROCESSED,
     ACTIVATION_EIGENVALUES_NAME, ACTIVATION_EIGENVECTORS_NAME),
    (GRADIENT_COVARIANCE_MATRIX_NAME, NUM_GRADIENT_COVARIANCE_PROCESSED,
     GRADIENT_EIGENVALUES_NAME, GRADIENT_EIGENVECTORS_NAME),
)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread for numpy's host eigh: OpenBLAS's thread team spins
    against the suite's other workers (tests/test_torch_analyzer_release.py)."""
    with threadpool_limits(limits=1):
        yield


def _close(got, want, rtol, err_msg=""):
    """fp64 comparison with an absolute floor at rtol x max|want|, so
    entries that cancel to ~0 are held to the matrix's own scale."""
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max(), err_msg=err_msg)


@pytest.fixture(scope="module")
def setup():
    jmodel, params, jtask, config = make_lm()
    tmodel, ttask, _ = make_torch_lm(params, config)
    train = make_lm_data(NUM_TRAIN, seq_len=config.max_seq_len, vocab=config.vocab_size, seed=0)
    jargs, targs = jax_factor_args("ekfac"), pytest_factor_arguments("ekfac")
    jcov = jax_fit_covariance(jmodel, params, jtask, JaxBatchLoader(train, BATCH), jargs)
    tcov = fit_covariance_matrices_with_loader(
        tmodel, ttask, BatchLoader(train, BATCH, device="cpu"), targs
    )
    jeig = jax_eigendecomposition(jcov, jargs)
    teig = perform_eigendecomposition(tcov, targs)
    return dict(
        jmodel=jmodel, params=params, jtask=jtask, tmodel=tmodel, ttask=ttask, train=train,
        jcov=jcov, tcov=tcov, jeig=jeig, teig=teig, config=config,
    )


def test_covariance_matrices_and_counts_match(setup):
    jcov, tcov, train = setup["jcov"], setup["tcov"], setup["train"]
    assert set(tcov) == set(jcov)
    tokens = int(train["attention_mask"].sum())
    for cov_name, count_name, _, _ in PAIRS:
        assert set(tcov[cov_name]) == set(jcov[cov_name])
        for name, want in jcov[cov_name].items():
            assert tcov[cov_name][name].dtype == torch.float64
            _close(tcov[cov_name][name], want, 1e-10, f"{cov_name}/{name}")
            assert int(tcov[count_name][name][0]) == int(np.asarray(jcov[count_name][name])[0])
            assert int(tcov[count_name][name][0]) == tokens


def test_eigenvalues_and_reconstructions_match(setup):
    jcov, jeig, teig = setup["jcov"], setup["jeig"], setup["teig"]
    for cov_name, count_name, eval_name, evec_name in PAIRS:
        for name in jcov[cov_name]:
            _close(teig[eval_name][name], jeig[eval_name][name], 1e-9, f"{eval_name}/{name}")
            q, lam = teig[evec_name][name], teig[eval_name][name]
            jq, jlam = np.asarray(jeig[evec_name][name]), np.asarray(jeig[eval_name][name])
            _close((q * lam) @ q.T, (jq * jlam) @ jq.T, 1e-9, f"reconstruction {name}")


def test_device_eigendecomposition_path(setup):
    """The fp32 device path (batched torch.linalg.eigh, here on CPU tensors)
    reconstructs the normalized covariance to fp32 accuracy (1e-5 of scale)
    and agrees with the fp64 host eigenvalues."""
    tcov, teig = setup["tcov"], setup["teig"]
    cov32 = {k: {n: t.to(torch.float32) if t.is_floating_point() else t for n, t in v.items()}
             for k, v in tcov.items()}
    out = {name: {} for _, _, e, v in PAIRS for name in (e, v)}
    _device_eigendecomposition(cov32, out)
    for cov_name, count_name, eval_name, evec_name in PAIRS:
        for name, mat in tcov[cov_name].items():
            assert out[evec_name][name].dtype == torch.float32
            normalized = mat / float(tcov[count_name][name][0])
            q, lam = out[evec_name][name].double(), out[eval_name][name].double()
            _close((q * lam) @ q.T, normalized, 1e-5, f"reconstruction {name}")
            _close(lam, teig[eval_name][name], 1e-5, f"{eval_name}/{name}")


class _PostProcessed:
    """Doubles one module's per-sample gradients: exercises the lambda
    branch that materializes raw per-sample gradients."""

    enable_post_process_per_sample_gradient = True

    def post_process_per_sample_gradient(self, module_name, gradient):
        return gradient * 2.0 if module_name == "h_0/mlp/c_fc" else gradient


class _JaxPostProcessed(_PostProcessed, LanguageModelingTask):
    pass


class _TorchPostProcessed(_PostProcessed, TorchLanguageModelingTask):
    pass


@pytest.mark.parametrize("variant", ["ekfac", "ekfac_iterative", "ekfac_post_process", "diagonal"])
def test_lambda_matches(setup, variant):
    """Lambda is sign-invariant in the eigenvectors, so it is compared
    directly (fp64 on both sides, same host LAPACK eigenvectors)."""
    strategy = "diagonal" if variant == "diagonal" else "ekfac"
    jargs, targs = jax_factor_args(strategy), pytest_factor_arguments(strategy)
    if variant == "ekfac_iterative":
        jargs.use_iterative_lambda_aggregation = True
        targs.use_iterative_lambda_aggregation = True
    jmodel, jtask = setup["jmodel"], setup["jtask"]
    tmodel, ttask = setup["tmodel"], setup["ttask"]
    if variant == "ekfac_post_process":
        jtask, ttask = _JaxPostProcessed(), _TorchPostProcessed()
        jmodel = jax_prepare(jmodel.module, jtask)
    train = setup["train"]
    jlam = jax_fit_lambda(
        jmodel, setup["params"], jtask, JaxBatchLoader(train, BATCH), jargs,
        eigen_factors=setup["jeig"],
    )
    tlam = fit_lambda_matrices_with_loader(
        tmodel, ttask, BatchLoader(train, BATCH, device="cpu"), targs, eigen_factors=setup["teig"]
    )
    assert set(tlam[LAMBDA_MATRIX_NAME]) == set(jlam[LAMBDA_MATRIX_NAME])
    for name, want in jlam[LAMBDA_MATRIX_NAME].items():
        _close(tlam[LAMBDA_MATRIX_NAME][name], want, 1e-9, name)
        assert int(tlam[NUM_LAMBDA_PROCESSED][name][0]) == NUM_TRAIN


def test_gradient_contractions_match_jax():
    """per_sample_gradient and summed_gradient against the JAX ops (fp64)."""
    import jax.numpy as jnp

    from kronfluence_tpu.ops.covariance import per_sample_gradient as jax_psg
    from kronfluence_tpu.ops.covariance import summed_gradient as jax_summed
    from kronfluence_tpu_torch.ops.covariance import per_sample_gradient, summed_gradient

    rng = np.random.default_rng(5)
    a, g = rng.standard_normal((3, 6, 5)), rng.standard_normal((3, 6, 4))
    ta, tg = torch.from_numpy(a), torch.from_numpy(g)
    ja, jg = jnp.asarray(a), jnp.asarray(g)
    _close(per_sample_gradient(ta, tg, "float64"), jax_psg(ja, jg, jnp.float64), 1e-12)
    _close(summed_gradient(ta, tg, "float64"), jax_summed(ja, jg, jnp.float64), 1e-12)


@pytest.mark.parametrize("num,batch", [(10, 4), (8, 4), (3, 5)])
def test_batch_loader_padding_matches_jax(num, batch):
    """Same batches and the same valid mask on a short last batch."""
    from kronfluence_tpu.utils.dataset import make_indices_partition as jax_partition
    from kronfluence_tpu_torch.utils.dataset import make_indices_partition

    data = make_lm_data(num, seq_len=8, vocab=32, seed=2)
    jbatches = list(JaxBatchLoader(data, batch))
    tbatches = list(BatchLoader(data, batch, device="cpu"))
    assert len(tbatches) == len(jbatches) == len(BatchLoader(data, batch, device="cpu"))
    for (jb, jv), (tb, tv) in zip(jbatches, tbatches):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        for key in jb:
            np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]))
    assert make_indices_partition(num, 2) == jax_partition(num, 2)
    assert make_indices_partition(num, 2, [1]) == jax_partition(num, 2, [1])


def test_cast_params_copies_only_when_needed(setup):
    from kronfluence_tpu_torch.factor.covariance import cast_params

    tmodel = setup["tmodel"]
    assert cast_params(tmodel, None) is tmodel
    assert cast_params(tmodel, "float64") is tmodel
    cast = cast_params(tmodel, "float32")
    assert cast is not tmodel and cast.tracked_names == tmodel.tracked_names
    assert all(p.dtype == torch.float32 for p in cast.module.parameters())
    assert all(p.dtype == torch.float64 for p in tmodel.module.parameters())
