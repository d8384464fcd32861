"""The port's ResNets (models/resnet.py) against kronfluence_tpu's flax
models on the CPU in fp64: forwards on weights and BatchNorm statistics
carried over by models/convert.py, the stem's max-pool padding, factors on a
tracked subset of ResNet-9, and the memory model's conv token counts.

Forwards are held to 1e-10 of the logits' max; factors to the tolerances of
tests/test_torch_cnn.py (1e-10 of max for covariances and lambdas, 1e-9 for
eigenvalues)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
import torch.nn.functional as F

from kronfluence_tpu.factor.covariance import (
    fit_covariance_matrices_with_loader as jax_fit_covariance,
)
from kronfluence_tpu.factor.eigen import (
    fit_lambda_matrices_with_loader as jax_fit_lambda,
    perform_eigendecomposition as jax_eigendecomposition,
)
from kronfluence_tpu.models import resnet as flax_resnet
from kronfluence_tpu.ops.covariance import use_conv_sym_gram as jax_use_conv_sym_gram
from kronfluence_tpu.prepare import prepare_model as jax_prepare
from kronfluence_tpu.utils.common.factor_arguments import (
    pytest_factor_arguments as jax_factor_args,
)
from kronfluence_tpu.utils.dataset import BatchLoader as JaxBatchLoader
from kronfluence_tpu.utils.memory import probe_modules as jax_probe_modules
from kronfluence_tpu_torch.factor.covariance import fit_covariance_matrices_with_loader
from kronfluence_tpu_torch.factor.eigen import (
    fit_lambda_matrices_with_loader,
    perform_eigendecomposition,
)
from kronfluence_tpu_torch.models import resnet
from kronfluence_tpu_torch.models.cnn import max_pool
from kronfluence_tpu_torch.prepare import prepare_model
from kronfluence_tpu_torch.utils.common.factor_arguments import pytest_factor_arguments
from kronfluence_tpu_torch.utils.constants import (
    ACTIVATION_COVARIANCE_MATRIX_NAME,
    ACTIVATION_EIGENVALUES_NAME,
    GRADIENT_COVARIANCE_MATRIX_NAME,
    GRADIENT_EIGENVALUES_NAME,
    LAMBDA_MATRIX_NAME,
    NUM_ACTIVATION_COVARIANCE_PROCESSED,
    NUM_GRADIENT_COVARIANCE_PROCESSED,
)
from kronfluence_tpu_torch.utils.dataset import BatchLoader
from kronfluence_tpu_torch.utils.memory import probe_modules

from tests.testable_tasks.classification import ClassificationTask, make_classification_data
from tests.testable_tasks.torch_classification import TorchClassificationTask, load_flax, nchw

TRACKED = ["stem/conv", "layer1/conv", "res1/block_0/conv", "classifier"]
SIZE, CLASSES = 8, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def _random_variables(flax_module, x, seed):
    """fp64 flax variables with every BatchNorm's scale, bias, mean and var
    drawn from a numpy seed (init would leave them 1, 0, 0, 1 and a ResNet's
    bn3 scale 0)."""
    variables = flax_module.init(jax.random.PRNGKey(seed), x)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        leaf = np.asarray(leaf, np.float64)
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape)
        if name in ("mean", "bias") and leaf.ndim == 1:
            return 0.1 * rng.standard_normal(leaf.shape)
        if name == "scale":
            return 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        return leaf

    return jax.tree_util.tree_map_with_path(draw, jax.device_get(variables))


def _images(n, size, channels, seed):
    return np.random.default_rng(seed).standard_normal((n, size, size, channels))


def _logits_pair(flax_module, torch_module, x, seed=0):
    variables = _random_variables(flax_module, jnp.asarray(x), seed)
    want = np.asarray(flax_module.apply(variables, jnp.asarray(x)))
    load_flax(torch_module, variables).eval()
    with torch.no_grad():
        got = torch_module(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    return got.numpy(), want


def test_resnet9_forward_matches_flax():
    x = _images(3, SIZE, 3, seed=1)
    got, want = _logits_pair(flax_resnet.ResNet9(num_classes=CLASSES, dtype=jnp.float64),
                             resnet.ResNet9(CLASSES, dtype=torch.float64), x)
    assert got.shape == (3, CLASSES)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("in_channels,strides,size", [(16, 2, 8), (32, 1, 6), (16, 2, 7)])
def test_bottleneck_forward_matches_flax(in_channels, strides, size):
    """A strided block (proj; flax "SAME" pads its 3x3 conv (0, 1) on an even
    input, (1, 1) on an odd one), and one whose residual is the identity."""
    x = _images(2, size, in_channels, seed=2)
    block = resnet.BottleneckBlock(in_channels, 8, strides, dtype=torch.float64)
    assert (block.proj is None) == (strides == 1 and in_channels == 32)
    got, want = _logits_pair(
        flax_resnet.BottleneckBlock(8, (strides, strides), dtype=jnp.float64), block, x, seed=3)
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), rtol=0,
                               atol=1e-10 * np.abs(want).max())


def test_resnet_forward_matches_flax():
    """The stem (7x7 at stride 2, explicit pads 3), the "SAME" max-pool and
    two stages of bottlenecks, at a 16x16 input."""
    x = _images(2, 16, 3, seed=4)
    got, want = _logits_pair(
        flax_resnet.ResNet(stage_sizes=(1, 1), num_classes=CLASSES, dtype=jnp.float64),
        resnet.ResNet((1, 1), CLASSES, dtype=torch.float64), x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())


def test_stem_max_pool_pads_like_flax():
    """flax's "SAME" 3x3 max-pool at stride 2 on an even input pads (0, 1)
    with -inf; torch's padding=1 pads (1, 1), another network."""
    x = _images(2, 8, 4, seed=5)
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME"))
    t = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    got = max_pool(t, 3, 2, padding="SAME").numpy().transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(got, want)
    torch_pad = F.max_pool2d(t, 3, 2, padding=1).numpy().transpose(0, 2, 3, 1)
    assert torch_pad.shape == want.shape and not np.array_equal(torch_pad, want)
    neg = -np.abs(x)  # all negative: a zero pad would win every edge window
    np.testing.assert_array_equal(
        max_pool(torch.from_numpy(np.ascontiguousarray(neg.transpose(0, 3, 1, 2))), 3, 2,
                 padding="SAME").numpy().transpose(0, 2, 3, 1),
        np.asarray(fnn.max_pool(jnp.asarray(neg), (3, 3), strides=(2, 2), padding="SAME")))


def test_module_names_are_flax_paths():
    """Every conv and Dense of the port's ResNets has its flax path as name."""
    for flax_module, module, size in (
        (flax_resnet.ResNet9(num_classes=CLASSES), resnet.ResNet9(CLASSES), SIZE),
        (flax_resnet.ResNet(stage_sizes=(1, 2), num_classes=CLASSES),
         resnet.ResNet((1, 2), CLASSES), 16),
    ):
        params = flax_module.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
        flax_names = {
            "/".join(str(k.key) for k in path[1:-1])
            for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]
            if str(path[-1].key) == "kernel"
        }
        assert set(prepare_model(module).tracked_modules()) == flax_names


class _JaxTracked(ClassificationTask):
    def get_influence_tracked_modules(self):
        return TRACKED


@pytest.fixture(scope="module")
def resnet9():
    flax_module = flax_resnet.ResNet9(num_classes=CLASSES, dtype=jnp.float64)
    x = jnp.zeros((1, SIZE, SIZE, 3), jnp.float64)
    variables = _random_variables(flax_module, x, seed=6)
    jtask, ttask = _JaxTracked(), TorchClassificationTask(tracked=TRACKED)
    module = load_flax(resnet.ResNet9(CLASSES, dtype=torch.float64), variables)
    return (jax_prepare(flax_module, jtask), variables, jtask, prepare_model(module, ttask),
            ttask)


def test_resnet9_factors_match(resnet9):
    """Covariance, eigendecomposition and lambda on the tracked subset,
    against the JAX package. The port takes every conv's activation gram from
    im2col; at res1/block_0/conv (128 channels) the JAX package takes its
    symmetric-block gram, so the two forms are held equal there."""
    jmodel, variables, jtask, tmodel, ttask = resnet9
    train = make_classification_data(6, size=SIZE, classes=CLASSES, seed=7)
    jargs, targs = jax_factor_args("ekfac"), pytest_factor_arguments("ekfac")
    jcov = jax_fit_covariance(jmodel, variables, jtask, JaxBatchLoader(train, 4), jargs)
    jeig = jax_eigendecomposition(jcov, jargs)
    jlam = jax_fit_lambda(jmodel, variables, jtask, JaxBatchLoader(train, 4), jargs,
                          eigen_factors=jeig)
    loader = BatchLoader(nchw(train), 4, device="cpu")
    tcov = fit_covariance_matrices_with_loader(tmodel, ttask, loader, targs)
    teig = perform_eigendecomposition(tcov, targs)
    tlam = fit_lambda_matrices_with_loader(tmodel, ttask, loader, targs, eigen_factors=teig)
    sym = {name: spec.kind == "conv2d" and jax_use_conv_sym_gram(spec)
           for name, spec in _specs(tmodel, ttask).items()}
    assert sym == {"stem/conv": False, "layer1/conv": False, "res1/block_0/conv": True,
                   "classifier": False}
    assert set(tcov[ACTIVATION_COVARIANCE_MATRIX_NAME]) == set(TRACKED)
    for name in TRACKED:
        for key, rtol in ((ACTIVATION_COVARIANCE_MATRIX_NAME, 1e-10),
                          (GRADIENT_COVARIANCE_MATRIX_NAME, 1e-10),
                          (ACTIVATION_EIGENVALUES_NAME, 1e-9),
                          (GRADIENT_EIGENVALUES_NAME, 1e-9), (LAMBDA_MATRIX_NAME, 1e-9)):
            factors = {**jcov, **jeig, **jlam}
            want = np.asarray(factors[key][name])
            got = {**tcov, **teig, **tlam}[key][name].numpy()
            np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max(),
                                       err_msg=f"{key}/{name}")
        for count in (NUM_ACTIVATION_COVARIANCE_PROCESSED, NUM_GRADIENT_COVARIANCE_PROCESSED):
            assert int(tcov[count][name][0]) == int(np.asarray(jcov[count][name])[0])
    assert float(tcov[GRADIENT_COVARIANCE_MATRIX_NAME]["res1/block_0/conv"].abs().max()) > 0


def _specs(tmodel, ttask):
    from kronfluence_tpu_torch.factor.covariance import discover_stage_specs

    batch = {k: torch.from_numpy(v) for k, v in
             nchw(make_classification_data(2, size=SIZE, classes=CLASSES, seed=8)).items()}
    return discover_stage_specs(tmodel, ttask, batch)


def test_probe_modules_counts_conv_rows(resnet9):
    """The memory model's token rows per example: output positions for a conv
    layer (oh * ow of its NCHW output, not C_out * oh), as the JAX package
    counts its NHWC output."""
    jmodel, variables, jtask, tmodel, ttask = resnet9
    data = make_classification_data(3, size=SIZE, classes=CLASSES, seed=9)
    batch = {k: torch.from_numpy(v) for k, v in nchw(data).items()}
    got = probe_modules(tmodel, ttask, batch, 3)
    want = jax_probe_modules(jmodel, jtask, variables,
                             {k: jnp.asarray(v) for k, v in data.items()}, 3)
    assert {n: (p.tokens, p.uses) for n, p in got.items()} == {
        n: (p.tokens, p.uses) for n, p in want.items()}
    assert {n: p.tokens for n, p in got.items()} == {
        "stem/conv": 64, "layer1/conv": 64, "res1/block_0/conv": 16, "classifier": 1}
