"""The port's MLP and RepeatedMLP (models/mlp.py) through the four stages
and both score kinds, against the JAX package's regression testable task
(tests/testable_tasks/regression.py) on the CPU in fp64: the same flax
weights (carried over by models/convert.py), the same data from a numpy seed.
RepeatedMLP's shared layer is one tracked name used three times a forward."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from kronfluence_tpu_torch.prepare import prepare_model

from tests.testable_tasks.parity import (
    assert_factors_match,
    assert_scores_match,
    jax_stages,
    torch_stages,
)
from tests.testable_tasks.regression import make_mlp, make_regression_data
from tests.testable_tasks.torch_regression import TorchRegressionTask, torch_mlp

# 10 examples in batches of 4: the last batch is padded and masked.
NUM_TRAIN, BATCH, NUM_QUERY, QUERY_BATCH = 10, 4, 5, 2
NAMES = {False: ("layers_0", "layers_1", "output"),
         True: ("input_layer", "shared_layer", "output")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=[False, True], ids=["mlp", "repeated"])
def run(request):
    shared = request.param
    jmodel, params, jtask = make_mlp(shared=shared)
    module = torch_mlp(params, shared=shared)
    train = make_regression_data(NUM_TRAIN, seed=0)
    query = make_regression_data(NUM_QUERY, seed=1)
    want = jax_stages(jmodel, params, jtask, train, query, BATCH, QUERY_BATCH)
    got = torch_stages(prepare_model(module, TorchRegressionTask()), TorchRegressionTask(),
                       train, query, BATCH, QUERY_BATCH)
    return dict(shared=shared, jmodel=jmodel, params=params, module=module, train=train,
                want=want, got=got)


def test_forward_matches_flax(run):
    x = run["train"]["x"]
    want = np.asarray(run["jmodel"].bind(run["params"])(x))
    with torch.no_grad():
        got = run["module"](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_factors_match(run):
    assert_factors_match(run["got"][0], run["want"][0], NAMES[run["shared"]])


def test_pairwise_scores_match(run):
    assert_scores_match(run["got"][1], run["want"][1], (NUM_QUERY, NUM_TRAIN))


def test_self_scores_match(run):
    assert_scores_match(run["got"][2], run["want"][2], (NUM_TRAIN,))


def test_shared_layer_counts_every_use():
    """The shared layer's rows are its three uses a forward: its covariance
    count is three times the examples, the other layers' once."""
    from kronfluence_tpu_torch.factor.covariance import fit_covariance_matrices_with_loader
    from kronfluence_tpu_torch.utils.common.factor_arguments import pytest_factor_arguments
    from kronfluence_tpu_torch.utils.constants import NUM_ACTIVATION_COVARIANCE_PROCESSED
    from kronfluence_tpu_torch.utils.dataset import BatchLoader

    _, params, _ = make_mlp(shared=True)
    task = TorchRegressionTask()
    model = prepare_model(torch_mlp(params, shared=True), task)
    cov = fit_covariance_matrices_with_loader(
        model, task, BatchLoader(make_regression_data(NUM_TRAIN), BATCH, device="cpu"),
        pytest_factor_arguments("ekfac"))
    counts = {n: int(c[0]) for n, c in cov[NUM_ACTIVATION_COVARIANCE_PROCESSED].items()}
    assert counts == {"input_layer": NUM_TRAIN, "shared_layer": 3 * NUM_TRAIN,
                      "output": NUM_TRAIN}
