"""SmallCNN through the port's four stages and its pairwise and self scores,
against kronfluence_tpu on the CPU in fp64: the same flax weights (carried
over by models/convert.py), the same images and labels from a numpy seed.

Factors and scores are held to the reference's own tolerance, rtol 1.3e-6 /
atol 1e-5 (tests/test_reference_parity.py:61); covariances and lambdas also
to 1e-10 of their max, and eigenvalues to 1e-9. Variants: bias, no bias, a
grouped second conv, and stride 2 (flax "SAME" pads (0, 1) there)."""

import jax
import jax.numpy as jnp
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
from kronfluence_tpu.models.cnn import SmallCNN as FlaxSmallCNN
from kronfluence_tpu.prepare import prepare_model as jax_prepare
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
from kronfluence_tpu_torch.models.cnn import SmallCNN
from kronfluence_tpu_torch.prepare import prepare_model
from kronfluence_tpu_torch.score.pairwise import compute_pairwise_scores_with_loaders
from kronfluence_tpu_torch.score.self_scores import compute_self_scores_with_loaders
from kronfluence_tpu_torch.utils.common.factor_arguments import pytest_factor_arguments
from kronfluence_tpu_torch.utils.common.score_arguments import pytest_score_arguments
from kronfluence_tpu_torch.utils.constants import (
    ACTIVATION_COVARIANCE_MATRIX_NAME,
    ACTIVATION_EIGENVALUES_NAME,
    ALL_MODULE_NAME,
    GRADIENT_COVARIANCE_MATRIX_NAME,
    GRADIENT_EIGENVALUES_NAME,
    LAMBDA_MATRIX_NAME,
    NUM_ACTIVATION_COVARIANCE_PROCESSED,
    NUM_GRADIENT_COVARIANCE_PROCESSED,
)
from kronfluence_tpu_torch.utils.dataset import BatchLoader
from kronfluence_tpu_torch.utils.task_check import verify_task_configuration

from tests.testable_tasks.classification import ClassificationTask, make_classification_data
from tests.testable_tasks.torch_classification import TorchClassificationTask, load_flax, nchw

RTOL, ATOL = 1.3e-6, 1e-5
# 10 examples in batches of 4: the last batch is padded and masked.
NUM_TRAIN, BATCH, NUM_QUERY = 10, 4, 5
SIZE, CLASSES = 8, 5
VARIANTS = {
    "bias": dict(use_bias=True),
    "no_bias": dict(use_bias=False),
    "groups": dict(use_bias=True, groups=2),
    "stride2": dict(use_bias=True, strides=(2, 2)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def _models(variant):
    kwargs = dict(num_classes=CLASSES, channels=(4, 6), **VARIANTS[variant])
    flax_module = FlaxSmallCNN(**kwargs)
    params = flax_module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3), jnp.float64)
    )["params"]
    params = jax.tree_util.tree_map(lambda p: p.astype(jnp.float64), params)
    jtask, ttask = ClassificationTask(), TorchClassificationTask()
    module = load_flax(
        SmallCNN(image_size=(SIZE, SIZE), dtype=torch.float64, **kwargs), {"params": params}
    )
    return jax_prepare(flax_module, jtask), params, jtask, prepare_model(module, ttask), ttask


def _close(got, want, rtol, err_msg=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max(),
                               err_msg=err_msg)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def run(request):
    jmodel, params, jtask, tmodel, ttask = _models(request.param)
    train = make_classification_data(NUM_TRAIN, size=SIZE, classes=CLASSES, seed=0)
    query = make_classification_data(NUM_QUERY, size=SIZE, classes=CLASSES, seed=1)
    jargs, targs = jax_factor_args("ekfac"), pytest_factor_arguments("ekfac")
    jscore, tscore = jax_score_args(), pytest_score_arguments()

    def jloader(data, batch):
        return JaxBatchLoader(data, batch)

    def tloader(data, batch):
        return BatchLoader(nchw(data), batch, device="cpu")

    jcov = jax_fit_covariance(jmodel, params, jtask, jloader(train, BATCH), jargs)
    jeig = jax_eigendecomposition(jcov, jargs)
    jlam = jax_fit_lambda(jmodel, params, jtask, jloader(train, BATCH), jargs, eigen_factors=jeig)
    jf = {**jcov, **jeig, **jlam}
    tcov = fit_covariance_matrices_with_loader(tmodel, ttask, tloader(train, BATCH), targs)
    teig = perform_eigendecomposition(tcov, targs)
    tlam = fit_lambda_matrices_with_loader(
        tmodel, ttask, tloader(train, BATCH), targs, eigen_factors=teig
    )
    tf = {**tcov, **teig, **tlam}
    return dict(
        variant=request.param, train=train, query=query, jf=jf, tf=tf,
        jpair=jax_pairwise(jmodel, params, jtask, jloader(query, 2), jloader(train, BATCH), jf,
                           jargs, jscore),
        tpair=compute_pairwise_scores_with_loaders(
            tmodel, ttask, tloader(query, 2), tloader(train, BATCH), tf, targs, tscore),
        jself=jax_self(jmodel, params, jtask, jloader(train, BATCH), jf, jargs, jscore),
        tself=compute_self_scores_with_loaders(tmodel, ttask, tloader(train, BATCH), tf, targs,
                                               tscore),
        tmodel=tmodel, ttask=ttask, targs=targs,
    )


def test_factors_match(run):
    jf, tf = run["jf"], run["tf"]
    assert set(tf[ACTIVATION_COVARIANCE_MATRIX_NAME]) == {"conv_0", "conv_1", "head"}
    for name in ("conv_0", "conv_1", "head"):
        for cov, count in ((ACTIVATION_COVARIANCE_MATRIX_NAME, NUM_ACTIVATION_COVARIANCE_PROCESSED),
                           (GRADIENT_COVARIANCE_MATRIX_NAME, NUM_GRADIENT_COVARIANCE_PROCESSED)):
            _close(tf[cov][name], jf[cov][name], 1e-10, f"{cov}/{name}")
            assert int(tf[count][name][0]) == int(np.asarray(jf[count][name])[0])
        for evals in (ACTIVATION_EIGENVALUES_NAME, GRADIENT_EIGENVALUES_NAME):
            _close(tf[evals][name], jf[evals][name], 1e-9, f"{evals}/{name}")
        _close(tf[LAMBDA_MATRIX_NAME][name], jf[LAMBDA_MATRIX_NAME][name], 1e-9,
               f"lambda/{name}")
        for key in tf:
            got, want = tf[key][name], np.asarray(jf[key][name])
            if key.endswith("eigenvectors"):
                continue  # signs differ between solvers; eigenvalues and lambda hold them
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL, err_msg=key)
    # Conv rows: valid examples x output positions (stride 2 on 8x8: 4x4, then 2x2).
    positions = 4 * 4 if run["variant"] == "stride2" else SIZE * SIZE
    assert int(tf[NUM_ACTIVATION_COVARIANCE_PROCESSED]["conv_0"][0]) == NUM_TRAIN * positions


def test_pairwise_scores_match(run):
    got, want = run["tpair"][ALL_MODULE_NAME], np.asarray(run["jpair"][ALL_MODULE_NAME])
    assert got.shape == (NUM_QUERY, NUM_TRAIN) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_self_scores_match(run):
    got, want = run["tself"][ALL_MODULE_NAME], np.asarray(run["jself"][ALL_MODULE_NAME])
    assert got.shape == (NUM_TRAIN,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant", ["bias", "stride2"])
def test_remat_covariance_matches(variant):
    """Rematerialisation over a model whose tracked convs sit on the root
    module (one region, the whole forward) gives the same covariance."""
    _, _, _, tmodel, ttask = _models(variant)
    train = nchw(make_classification_data(NUM_TRAIN, size=SIZE, classes=CLASSES, seed=0))
    args = pytest_factor_arguments("ekfac")
    plain = fit_covariance_matrices_with_loader(tmodel, ttask, BatchLoader(train, BATCH,
                                                                           device="cpu"), args)
    args.offload_activations_to_cpu = True
    remat = fit_covariance_matrices_with_loader(tmodel, ttask, BatchLoader(train, BATCH,
                                                                           device="cpu"), args)
    for key, per_module in plain.items():
        for name, want in per_module.items():
            _close(remat[key][name], want.numpy(), 1e-12, f"{key}/{name}")


class _MaskedTask(TorchClassificationTask):
    """A task that hands out an attention mask of no conv layer's size."""

    def get_attention_mask(self, batch):
        return torch.ones(batch["x"].shape[0], 7)


def test_task_check_passes_conv_specs():
    """The attention-mask rows check is linear-only: with only the convs
    tracked, a mask that fits no layer is no error; with the head tracked
    too, it is."""
    from kronfluence_tpu_torch.utils.exceptions import IllegalTaskConfigurationError

    _, _, _, tmodel, _ = _models("groups")
    batch = {k: torch.from_numpy(v) for k, v in
             nchw(make_classification_data(3, size=SIZE, classes=CLASSES, seed=2)).items()}
    verify_task_configuration(tmodel, TorchClassificationTask(), batch)
    convs = _MaskedTask(tracked=["conv_0", "conv_1"])
    verify_task_configuration(prepare_model(tmodel.module, convs), convs, batch)
    everything = _MaskedTask(tracked=["conv_0", "conv_1", "head"])
    with pytest.raises(IllegalTaskConfigurationError, match="Attention mask"):
        verify_task_configuration(prepare_model(tmodel.module, everything), everything, batch)
