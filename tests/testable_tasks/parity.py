"""The four stages and both score kinds through the JAX package and the
port on the same model, weights and data, and the comparisons the port's
parity tests make between them.

Factors and scores are held to the reference's own tolerance, rtol 1.3e-6 /
atol 1e-5 (tests/test_reference_parity.py:61). Eigendecompositions are held
by their eigenvalues and reconstructions Q diag(λ) Qᵀ: eigenvector signs and
the bases of close eigenvalues differ between solvers.
"""

import numpy as np
import torch

from kronfluence_tpu.factor.covariance import (
    fit_covariance_matrices_with_loader as jax_fit_covariance,
)
from kronfluence_tpu.factor.eigen import (
    fit_lambda_matrices_with_loader as jax_fit_lambda,
    perform_eigendecomposition as jax_eigendecomposition,
)
from kronfluence_tpu.score.pairwise import (
    compute_pairwise_scores_with_loaders as jax_pairwise,
)
from kronfluence_tpu.score.self_scores import compute_self_scores_with_loaders as jax_self
from kronfluence_tpu.utils.common.factor_arguments import (
    pytest_factor_arguments as jax_factor_args,
)
from kronfluence_tpu.utils.common.score_arguments import (
    pytest_score_arguments as jax_score_args,
)
from kronfluence_tpu.utils.dataset import BatchLoader as JaxBatchLoader
from kronfluence_tpu_torch.factor.covariance import fit_covariance_matrices_with_loader
from kronfluence_tpu_torch.factor.eigen import (
    fit_lambda_matrices_with_loader,
    perform_eigendecomposition,
)
from kronfluence_tpu_torch.score.pairwise import compute_pairwise_scores_with_loaders
from kronfluence_tpu_torch.score.self_scores import compute_self_scores_with_loaders
from kronfluence_tpu_torch.utils.common.factor_arguments import pytest_factor_arguments
from kronfluence_tpu_torch.utils.common.score_arguments import pytest_score_arguments
from kronfluence_tpu_torch.utils.constants import (
    ACTIVATION_COVARIANCE_MATRIX_NAME,
    ACTIVATION_EIGENVALUES_NAME,
    ACTIVATION_EIGENVECTORS_NAME,
    ALL_MODULE_NAME,
    GRADIENT_COVARIANCE_MATRIX_NAME,
    GRADIENT_EIGENVALUES_NAME,
    GRADIENT_EIGENVECTORS_NAME,
    LAMBDA_MATRIX_NAME,
    NUM_ACTIVATION_COVARIANCE_PROCESSED,
    NUM_GRADIENT_COVARIANCE_PROCESSED,
    NUM_LAMBDA_PROCESSED,
)
from kronfluence_tpu_torch.utils.dataset import BatchLoader

RTOL, ATOL = 1.3e-6, 1e-5
MATRICES = (ACTIVATION_COVARIANCE_MATRIX_NAME, GRADIENT_COVARIANCE_MATRIX_NAME,
            ACTIVATION_EIGENVALUES_NAME, GRADIENT_EIGENVALUES_NAME, LAMBDA_MATRIX_NAME)
COUNTS = (NUM_ACTIVATION_COVARIANCE_PROCESSED, NUM_GRADIENT_COVARIANCE_PROCESSED,
          NUM_LAMBDA_PROCESSED)
EIGENPAIRS = ((ACTIVATION_EIGENVECTORS_NAME, ACTIVATION_EIGENVALUES_NAME),
              (GRADIENT_EIGENVECTORS_NAME, GRADIENT_EIGENVALUES_NAME))


def jax_stages(model, params, task, train, query, batch, query_batch):
    """{factors}, pairwise scores and self scores of the JAX package."""
    fargs, sargs = jax_factor_args("ekfac"), jax_score_args()
    cov = jax_fit_covariance(model, params, task, JaxBatchLoader(train, batch), fargs)
    eig = jax_eigendecomposition(cov, fargs)
    lam = jax_fit_lambda(model, params, task, JaxBatchLoader(train, batch), fargs,
                         eigen_factors=eig)
    factors = {**cov, **eig, **lam}
    pair = jax_pairwise(model, params, task, JaxBatchLoader(query, query_batch),
                        JaxBatchLoader(train, batch), factors, fargs, sargs)
    self_ = jax_self(model, params, task, JaxBatchLoader(train, batch), factors, fargs, sargs)
    return factors, np.asarray(pair[ALL_MODULE_NAME]), np.asarray(self_[ALL_MODULE_NAME])


def torch_stages(model, task, train, query, batch, query_batch, fargs=None):
    """The same through the port on the CPU."""
    fargs = pytest_factor_arguments("ekfac") if fargs is None else fargs
    sargs = pytest_score_arguments()

    def loader(data, size):
        return BatchLoader(data, size, device="cpu")

    cov = fit_covariance_matrices_with_loader(model, task, loader(train, batch), fargs)
    eig = perform_eigendecomposition(cov, fargs)
    lam = fit_lambda_matrices_with_loader(model, task, loader(train, batch), fargs,
                                          eigen_factors=eig)
    factors = {**cov, **eig, **lam}
    pair = compute_pairwise_scores_with_loaders(
        model, task, loader(query, query_batch), loader(train, batch), factors, fargs, sargs)
    self_ = compute_self_scores_with_loaders(model, task, loader(train, batch), factors, fargs,
                                             sargs)
    return factors, pair[ALL_MODULE_NAME], self_[ALL_MODULE_NAME]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _reconstruction(vectors, values):
    vectors, values = _np(vectors), _np(values)
    return (vectors * values) @ vectors.T


def assert_factors_match(got, want, names):
    """The port's factors `got` against the JAX package's `want` for each
    module of `names`: covariances, eigenvalues, reconstructions and lambda
    at the reference tolerance, counts equal."""
    assert set(got[ACTIVATION_COVARIANCE_MATRIX_NAME]) == set(names)
    assert set(want[ACTIVATION_COVARIANCE_MATRIX_NAME]) == set(names)
    for name in names:
        for key in MATRICES:
            np.testing.assert_allclose(_np(got[key][name]), _np(want[key][name]), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{key}/{name}")
        for key in COUNTS:
            assert int(_np(got[key][name]).reshape(-1)[0]) == int(
                _np(want[key][name]).reshape(-1)[0]), f"{key}/{name}"
        for vectors, values in EIGENPAIRS:
            np.testing.assert_allclose(
                _reconstruction(got[vectors][name], got[values][name]),
                _reconstruction(want[vectors][name], want[values][name]),
                rtol=RTOL, atol=ATOL, err_msg=f"{vectors}/{name}")


def assert_scores_match(got, want, shape):
    assert tuple(got.shape) == shape and got.dtype == torch.float64
    np.testing.assert_allclose(_np(got), want, rtol=RTOL, atol=ATOL)


def assert_bitwise(got, want):
    """Two of the port's stage results (factor dicts or score tensors) equal
    bit for bit."""
    if isinstance(want, torch.Tensor):
        assert torch.equal(got, want)
        return
    assert set(got) == set(want)
    for key, per_module in want.items():
        assert set(got[key]) == set(per_module), key
        for name, tensor in per_module.items():
            assert torch.equal(got[key][name], tensor), f"{key}/{name}"
