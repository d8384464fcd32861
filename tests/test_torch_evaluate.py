"""The port's LDS harness (kronfluence_tpu_torch/evaluate.py) against
kronfluence_tpu/evaluate.py: the same masks for a seed, the same Spearman
ranks with ties, the same LDS, tests/test_lds.py's ordering of strategies
through the port's Analyzer, and the shape check the JAX package lacks."""

from collections import OrderedDict

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from kronfluence_tpu import evaluate as jax_evaluate
from kronfluence_tpu_torch import Analyzer, FactorArguments, ScoreArguments, Task, prepare_model
from kronfluence_tpu_torch import evaluate

# tests/test_lds.py's ridge problem.
D, N_TRAIN, N_QUERY = 6, 64, 8
RIDGE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("seed,n,m,fraction", [(0, 10, 5, 0.5), (3, 64, 48, 0.5), (7, 33, 9, 0.3)])
def test_masks_equal_jax(seed, n, m, fraction):
    got = evaluate.sample_subset_masks(n, m, fraction, seed)
    want = jax_evaluate.sample_subset_masks(n, m, fraction, seed)
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("levels", [3, 6, None], ids=["many_ties", "some_ties", "no_ties"])
def test_spearman_with_ties_equals_jax(levels):
    rng = np.random.default_rng(11)
    shape = (4, 30)
    if levels is None:
        a, b = rng.standard_normal(shape), rng.standard_normal(shape)
    else:
        a = rng.integers(0, levels, shape).astype(np.float64)
        b = rng.integers(0, levels, shape).astype(np.float64)
    want = jax_evaluate.spearman_correlation(a, b)
    np.testing.assert_array_equal(evaluate.spearman_correlation(a, b), want)
    np.testing.assert_array_equal(
        evaluate.spearman_correlation(torch.from_numpy(a), torch.from_numpy(b)), want
    )
    assert evaluate.spearman_correlation(a[0], a[0])[0] == 1.0
    assert evaluate.spearman_correlation(a[0], -a[0])[0] == -1.0


def test_spearman_on_a_constant_row_is_zero_as_jax():
    a = np.array([[1.0, 1.0, 1.0], [1.0, 2.0, 3.0]])
    b = np.array([[3.0, 1.0, 2.0], [1.0, 2.0, 3.0]])
    np.testing.assert_array_equal(
        evaluate.spearman_correlation(a, b), jax_evaluate.spearman_correlation(a, b)
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_lds_equals_jax(seed):
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((3, 20))
    masks = evaluate.sample_subset_masks(20, 12, 0.5, seed)
    measurements = rng.standard_normal((12, 3))
    mean, per_query = evaluate.linear_datamodeling_score(
        torch.from_numpy(scores).to(torch.float32).double(), measurements, masks
    )
    want_mean, want_per_query = jax_evaluate.linear_datamodeling_score(scores, measurements, masks)
    np.testing.assert_array_equal(per_query, want_per_query)
    assert mean == want_mean and per_query.shape == (3,)


def test_collected_measurements_and_lds_equal_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((20, 3))
    scores = rng.standard_normal((4, 20))

    def train_fn(idx, seed):
        return x[idx].sum(0) + seed

    def measure_fn(state):
        return np.tile(state.sum(), 4) * np.arange(1, 5)

    masks = evaluate.sample_subset_masks(20, 6, 0.5, 2)
    got = evaluate.collect_subset_measurements(train_fn, measure_fn, masks, seed=1)
    want = jax_evaluate.collect_subset_measurements(train_fn, measure_fn, masks, seed=1)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (6, 4) and got.dtype == np.float64
    lds = evaluate.evaluate_lds(scores, train_fn, measure_fn, 20, num_subsets=6, seed=2)
    jax_lds = jax_evaluate.evaluate_lds(scores, train_fn, measure_fn, 20, num_subsets=6, seed=2)
    assert lds[0] == jax_lds[0]
    np.testing.assert_array_equal(lds[1], jax_lds[1])


def test_mismatched_measurements_raise():
    scores = np.zeros((3, 10))
    masks = evaluate.sample_subset_masks(10, 5, 0.5, 1)
    with pytest.raises(ValueError, match="one measurement row per subset mask"):
        evaluate.linear_datamodeling_score(scores, np.zeros((4, 3)), masks)
    with pytest.raises(ValueError, match="one measurement row per subset mask"):
        evaluate.evaluate_lds(scores, None, None, 10, masks=masks, measurements=np.zeros((6, 3)))


class RegressionTask(Task):
    def compute_train_loss(self, batch, model, sample=False, generator=None):
        return 0.5 * torch.sum((model(batch["x"]) - batch["y"]) ** 2)

    def compute_measurement(self, batch, model):
        return self.compute_train_loss(batch, model)


def _problem(seed=0):
    """tests/test_lds.py:_make_problem."""
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal((D, 1))
    x_train = rng.standard_normal((N_TRAIN, D))
    y_train = x_train @ w_true + 0.3 * rng.standard_normal((N_TRAIN, 1))
    x_query = rng.standard_normal((N_QUERY, D))
    y_query = x_query @ w_true + 0.3 * rng.standard_normal((N_QUERY, 1))
    return x_train, y_train, x_query, y_query


def _scores(strategy, train, query, tmp_path):
    """The port's Analyzer on Linear(6, 1) at the full-data ridge solution."""
    x, y = train["x"], train["y"]
    w_star = np.linalg.solve(x.T @ x + RIDGE * np.eye(D), x.T @ y)
    fc = torch.nn.Linear(D, 1, bias=False, dtype=torch.float64)
    with torch.no_grad():
        fc.weight.copy_(torch.from_numpy(w_star.T))
    task = RegressionTask()
    model = prepare_model(torch.nn.Sequential(OrderedDict(fc=fc)), task)
    analyzer = Analyzer(f"lds_{strategy}", model, task, cpu=True, output_dir=str(tmp_path))
    fa = FactorArguments(
        strategy=strategy, use_empirical_fisher=True,
        activation_covariance_dtype="float64", gradient_covariance_dtype="float64",
        eigendecomposition_dtype="float64", per_sample_gradient_dtype="float64",
        lambda_dtype="float64",
    )
    sa = ScoreArguments(
        damping_factor=1e-3, per_sample_gradient_dtype="float64", precondition_dtype="float64",
        score_dtype="float64", query_gradient_svd_dtype="float64",
    )
    analyzer.fit_all_factors("f", train, per_device_batch_size=16, factor_args=fa)
    analyzer.compute_pairwise_scores(
        "s", "f", query, train, per_device_query_batch_size=8,
        per_device_train_batch_size=16, score_args=sa,
    )
    return analyzer.load_pairwise_scores("s")["all_modules"]


def test_lds_orders_strategies_through_the_port(tmp_path):
    x_train, y_train, x_query, y_query = _problem()
    train = {"x": x_train, "y": y_train}
    query = {"x": x_query, "y": y_query}
    ekfac = _scores("ekfac", train, query, tmp_path)
    identity = _scores("identity", train, query, tmp_path)
    assert ekfac.shape == identity.shape == (N_QUERY, N_TRAIN)

    def train_fn(idx, seed):
        xs, ys = x_train[idx], y_train[idx]
        return np.linalg.solve(xs.T @ xs + RIDGE * np.eye(D), xs.T @ ys)

    def measure_fn(w):
        return -0.5 * np.sum((x_query @ w - y_query) ** 2, axis=1)

    masks = evaluate.sample_subset_masks(N_TRAIN, num_subsets=48, subset_fraction=0.5, seed=3)
    measurements = evaluate.collect_subset_measurements(train_fn, measure_fn, masks)
    lds_ekfac, _ = evaluate.evaluate_lds(
        ekfac, train_fn, measure_fn, N_TRAIN, masks=masks, measurements=measurements
    )
    lds_identity, _ = evaluate.evaluate_lds(
        identity, train_fn, measure_fn, N_TRAIN, masks=masks, measurements=measurements
    )
    # The JAX test's bars (tests/test_lds.py).
    assert lds_ekfac > 0.35, (lds_ekfac, lds_identity)
    assert lds_ekfac > lds_identity - 1e-6, (lds_ekfac, lds_identity)
