"""Tagged functional layers (capture/functional.py, kronfluence_tpu_torch.nn)
and the functional model form (prepare.FunctionalModel) against the JAX
package's tagged ops on the CPU in fp64, and against the port's module form
bit for bit:

  * the raw functional MLP of tests/test_misc_features.py:49, through the
    four stages and both score kinds;
  * a functional CNN whose second conv runs at stride 2 with "SAME" padding
    (flax pads (0, 1) there) and two groups;
  * hooks and taps in one forward, the tracked-name filter on taps, the
    errors, and the ops outside a capture context.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
import torch.nn.functional as F
from torch import nn

import kronfluence_tpu.nn as jnn
from kronfluence_tpu.prepare import prepare_model as jax_prepare
import kronfluence_tpu_torch.nn as knn
from kronfluence_tpu_torch import FunctionalModel
from kronfluence_tpu_torch.capture.engine import capture, discover_specs
from kronfluence_tpu_torch.capture.context import conv_spec
from kronfluence_tpu_torch.factor.covariance import fit_covariance_matrices_with_loader
from kronfluence_tpu_torch.models.cnn import Conv2d
from kronfluence_tpu_torch.prepare import prepare_model
from kronfluence_tpu_torch.utils.common.factor_arguments import pytest_factor_arguments
from kronfluence_tpu_torch.utils.constants import (
    ACTIVATION_COVARIANCE_MATRIX_NAME,
    NUM_ACTIVATION_COVARIANCE_PROCESSED,
)
from kronfluence_tpu_torch.utils.dataset import BatchLoader
from kronfluence_tpu_torch.utils.exceptions import TrackedModuleNotFoundError

from tests.testable_tasks.classification import ClassificationTask, make_classification_data
from tests.testable_tasks.parity import (
    assert_bitwise,
    assert_factors_match,
    assert_scores_match,
    jax_stages,
    torch_stages,
)
from tests.testable_tasks.regression import make_mlp, make_regression_data
from tests.testable_tasks.torch_classification import TorchClassificationTask, nchw
from tests.testable_tasks.torch_regression import TorchRegressionTask, torch_mlp

NUM_TRAIN, BATCH, NUM_QUERY, QUERY_BATCH = 10, 4, 5, 2
SIZE, CLASSES = 8, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def _nested(state_dict):
    tree = {}
    for key, tensor in state_dict.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = tensor.clone()
    return tree


# ---- The functional MLP (tests/test_misc_features.py:49) ----

def jax_mlp_apply(p, x):
    h = jax.nn.relu(jnn.linear(x, p["layers_0"]["kernel"], p["layers_0"]["bias"], name="layers_0"))
    h = jax.nn.relu(jnn.linear(h, p["layers_1"]["kernel"], p["layers_1"]["bias"], name="layers_1"))
    return jnn.linear(h, p["output"]["kernel"], p["output"]["bias"], name="output")


def torch_mlp_apply(p, x):
    h = F.relu(knn.linear(x, p["layers_0"]["weight"], p["layers_0"]["bias"], name="layers_0"))
    h = F.relu(knn.linear(h, p["layers_1"]["weight"], p["layers_1"]["bias"], name="layers_1"))
    return knn.linear(h, p["output"]["weight"], p["output"]["bias"], name="output")


@pytest.fixture(scope="module")
def mlp_run():
    _, params, jtask = make_mlp()
    module = torch_mlp(params)
    task = TorchRegressionTask()
    functional = prepare_model(FunctionalModel(torch_mlp_apply, _nested(module.state_dict())),
                               task)
    train, query = make_regression_data(NUM_TRAIN, seed=0), make_regression_data(NUM_QUERY, seed=1)
    return dict(
        want=jax_stages(jax_prepare(jax_mlp_apply, jtask), params, jtask, train, query, BATCH,
                        QUERY_BATCH),
        got=torch_stages(functional, task, train, query, BATCH, QUERY_BATCH),
        module=torch_stages(prepare_model(module, task), task, train, query, BATCH, QUERY_BATCH),
    )


def test_functional_mlp_factors_match_jax(mlp_run):
    assert_factors_match(mlp_run["got"][0], mlp_run["want"][0], ("layers_0", "layers_1", "output"))


def test_functional_mlp_scores_match_jax(mlp_run):
    assert_scores_match(mlp_run["got"][1], mlp_run["want"][1], (NUM_QUERY, NUM_TRAIN))
    assert_scores_match(mlp_run["got"][2], mlp_run["want"][2], (NUM_TRAIN,))


@pytest.mark.parametrize("part", [0, 1, 2], ids=["factors", "pairwise", "self"])
def test_functional_mlp_equals_module_form_bitwise(mlp_run, part):
    assert_bitwise(mlp_run["got"][part], mlp_run["module"][part])


# ---- A functional CNN: stride 2, "SAME", groups ----

CONVS = (("conv_0", 3, 4, 1, 1), ("conv_1", 4, 6, 2, 2))  # name, in, out, stride, groups
HEAD_IN = 4 * 4 * 6  # 8x8 -> 4x4 at stride 2 ("SAME"), 6 channels


def _cnn_params(seed=0):
    """flax-layout numpy params: HWIO conv kernels, an (in, out) head."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, c_in, c_out, _, groups in CONVS:
        params[name] = {"kernel": rng.normal(size=(3, 3, c_in // groups, c_out)) / 3.0,
                        "bias": rng.normal(size=(c_out,)) * 0.1}
    params["head"] = {"kernel": rng.normal(size=(HEAD_IN, CLASSES)) / np.sqrt(HEAD_IN),
                      "bias": rng.normal(size=(CLASSES,)) * 0.1}
    return params


def jax_cnn_apply(p, x):
    for name, _, _, stride, groups in CONVS:
        x = jax.nn.relu(jnn.conv2d(x, p[name]["kernel"], p[name]["bias"], name=name,
                                   strides=stride, padding="SAME", feature_group_count=groups))
    return jnn.linear(x.reshape(x.shape[0], -1), p["head"]["kernel"], p["head"]["bias"],
                      name="head")


def torch_cnn_apply(p, x):
    for name, _, _, stride, groups in CONVS:
        x = F.relu(knn.conv2d(x, p[name]["weight"], p[name]["bias"], name=name, strides=stride,
                              padding="SAME", feature_group_count=groups))
    # flax's head reads the features in (h, w, c) order.
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return knn.linear(x, p["head"]["weight"], p["head"]["bias"], name="head")


def _torch_cnn_params(params):
    out = {}
    for name, value in params.items():
        kernel = value["kernel"]
        weight = kernel.transpose(3, 2, 0, 1) if kernel.ndim == 4 else kernel.T
        out[name] = {"weight": torch.from_numpy(np.ascontiguousarray(weight)),
                     "bias": torch.from_numpy(value["bias"].copy())}
    return out


class ModuleCNN(nn.Module):
    """The module form of `torch_cnn_apply`: models/cnn.py's Conv2d layers."""

    def __init__(self):
        super().__init__()
        for name, c_in, c_out, stride, groups in CONVS:
            self.add_module(name, Conv2d(c_in, c_out, 3, stride=stride, padding="SAME",
                                         groups=groups, dtype=torch.float64))
        self.head = nn.Linear(HEAD_IN, CLASSES, dtype=torch.float64)

    def forward(self, x):
        for name, *_ in CONVS:
            x = F.relu(getattr(self, name)(x))
        return self.head(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


@pytest.fixture(scope="module")
def cnn_run():
    params = _cnn_params()
    tparams = _torch_cnn_params(params)
    module = ModuleCNN()
    module.load_state_dict({f"{n}.{leaf}": t for n, p in tparams.items() for leaf, t in p.items()})
    task = TorchClassificationTask()
    train = make_classification_data(NUM_TRAIN, size=SIZE, classes=CLASSES, seed=0)
    query = make_classification_data(NUM_QUERY, size=SIZE, classes=CLASSES, seed=1)
    jtask = ClassificationTask()
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    functional = prepare_model(FunctionalModel(torch_cnn_apply, tparams), task)
    return dict(
        params=params, tparams=tparams, module=module,
        want=jax_stages(jax_prepare(jax_cnn_apply, jtask), jparams, jtask, train, query, BATCH,
                        QUERY_BATCH),
        got=torch_stages(functional, task, nchw(train), nchw(query), BATCH, QUERY_BATCH),
        module_form=torch_stages(prepare_model(module, task), task, nchw(train), nchw(query),
                                 BATCH, QUERY_BATCH),
    )


def test_functional_conv_factors_match_jax(cnn_run):
    assert_factors_match(cnn_run["got"][0], cnn_run["want"][0], ("conv_0", "conv_1", "head"))
    # conv_1's rows: the examples' 4 x 4 output positions at stride 2.
    assert int(cnn_run["got"][0][NUM_ACTIVATION_COVARIANCE_PROCESSED]["conv_1"][0]) == NUM_TRAIN * 16


def test_functional_conv_scores_match_jax(cnn_run):
    assert_scores_match(cnn_run["got"][1], cnn_run["want"][1], (NUM_QUERY, NUM_TRAIN))
    assert_scores_match(cnn_run["got"][2], cnn_run["want"][2], (NUM_TRAIN,))


@pytest.mark.parametrize("part", [0, 1, 2], ids=["factors", "pairwise", "self"])
def test_functional_conv_equals_module_form_bitwise(cnn_run, part):
    assert_bitwise(cnn_run["got"][part], cnn_run["module_form"][part])


def test_functional_conv_forward_and_spec(cnn_run):
    """The tagged conv's output equals flax's on the converted weights (the
    stride-2 "SAME" pads (0, 1)), and its spec equals the module form's."""
    x = make_classification_data(3, size=SIZE, classes=CLASSES, seed=2)["x"]
    want = np.asarray(jax_cnn_apply(jax.tree_util.tree_map(jnp.asarray, cnn_run["params"]), x))
    with torch.no_grad():
        got = torch_cnn_apply(cnn_run["tparams"], torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    model = prepare_model(FunctionalModel(torch_cnn_apply, cnn_run["tparams"]))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    specs = discover_specs(model, lambda: model.module(xt).sum())
    assert specs["conv_1"] == conv_spec("conv_1", cnn_run["module"].conv_1)
    assert specs["conv_1"].padding == "SAME" and specs["conv_1"].strides == (2, 2)


# ---- Hooks and taps in one forward ----

class Mixed(nn.Module):
    """fc1 and out are hooked nn.Linear layers; fc2 is a tagged linear of
    the module's own parameters. `clash` names the tagged op "fc1"."""

    def __init__(self, module, clash=False):
        super().__init__()
        self.fc1 = module.layers_0
        self.w2 = nn.Parameter(module.layers_1.weight.detach().clone())
        self.b2 = nn.Parameter(module.layers_1.bias.detach().clone())
        self.out = module.output
        self.clash = clash

    def forward(self, x):
        h = F.relu(self.fc1(x))
        h = F.relu(knn.linear(h, self.w2, self.b2, name="fc1" if self.clash else "fc2"))
        return self.out(h)


def _mixed(clash=False):
    _, params, _ = make_mlp()
    return torch_mlp(params), Mixed(torch_mlp(params), clash)


@pytest.mark.parametrize("remat", [False, True])
def test_hooks_and_taps_mix_each_name_once(remat):
    """A module forward that mixes hooked Linears and a tagged linear records
    each name once a use, with the factors of the all-module form; under
    remat (the root module one checkpointed region) the recompute re-enters
    the tap without recording."""
    module, mixed = _mixed()
    task = TorchRegressionTask()
    data = make_regression_data(NUM_TRAIN)
    args = pytest_factor_arguments("ekfac")
    args.offload_activations_to_cpu = remat
    got = fit_covariance_matrices_with_loader(prepare_model(mixed, task), task,
                                              BatchLoader(data, BATCH, device="cpu"), args)
    want = fit_covariance_matrices_with_loader(prepare_model(module, task), task,
                                               BatchLoader(data, BATCH, device="cpu"), args)
    renamed = {"fc1": "layers_0", "fc2": "layers_1", "out": "output"}
    assert list(got[ACTIVATION_COVARIANCE_MATRIX_NAME]) == list(renamed)
    for key, per_module in got.items():
        for name, tensor in per_module.items():
            assert torch.equal(tensor, want[key][renamed[name]]), f"{key}/{name}"
    assert {int(c[0]) for c in got[NUM_ACTIVATION_COVARIANCE_PROCESSED].values()} == {NUM_TRAIN}


def test_a_name_on_a_hook_and_a_tap_raises():
    _, mixed = _mixed(clash=True)
    model = prepare_model(mixed, TorchRegressionTask())
    x = torch.from_numpy(make_regression_data(3)["x"])
    with pytest.raises(ValueError, match="names both a tracked module and a tagged"):
        capture(model, lambda: model.module(x).sum())


def test_tracked_names_filter_taps():
    """get_influence_tracked_modules filters tagged ops as it filters modules."""
    _, mixed = _mixed()
    task = TorchRegressionTask(tracked=["fc2", "out"])
    model = prepare_model(mixed, task)
    x = torch.from_numpy(make_regression_data(3)["x"])
    _, result = capture(model, lambda: model.module(x).sum())
    assert list(result) == ["fc2", "out"]
    _, params, _ = make_mlp()
    functional = prepare_model(
        FunctionalModel(torch_mlp_apply, _nested(torch_mlp(params).state_dict())),
        TorchRegressionTask(tracked=["layers_1"]))
    _, result = capture(functional, lambda: functional.module(x).sum())
    assert list(result) == ["layers_1"]


def test_a_forward_that_taps_nothing_raises():
    model = prepare_model(FunctionalModel(lambda p, x: x @ p["w"], {"w": torch.ones(8, 1)}))
    x = torch.ones(2, 8, dtype=torch.float32)
    with pytest.raises(TrackedModuleNotFoundError):
        capture(model, lambda: model.module(x).sum())


def test_prepare_model_asks_for_a_bound_function():
    with pytest.raises(TypeError, match="FunctionalModel"):
        prepare_model(torch_mlp_apply)


def test_functional_model_holds_its_params():
    """The bound tensors are the module's frozen parameters (a non-floating
    one a buffer): state_dict and dtype casts act on them, and the forward
    reads them as they are now."""
    params = {"a": {"w": torch.ones(3, 2)}, "ids": torch.arange(3)}
    model = prepare_model(FunctionalModel(lambda p, x: x @ p["a"]["w"] + p["ids"][0], params))
    assert set(model.module.state_dict()) == {"params.a.w", "params.ids"}
    assert not any(p.requires_grad for p in model.module.parameters())
    model.module.to(torch.float64)
    out = model.module(torch.ones(1, 3, dtype=torch.float64))
    assert out.dtype == torch.float64 and torch.equal(out, torch.full((1, 2), 3.0, dtype=torch.float64))
    with pytest.raises(ValueError, match="without '.'"):
        FunctionalModel(lambda p: p, {"a.b": torch.ones(1)})


def test_ops_outside_a_context_are_plain():
    """Outside a capture context the tagged ops are the plain ops, and
    checkpoint_block gives the plain block's value and gradients."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 9, 8, generator=gen, dtype=torch.float64)
    conv = Conv2d(3, 4, 3, stride=2, padding="SAME", groups=1, dtype=torch.float64)
    with torch.no_grad():
        got = knn.conv2d(x, conv.weight, conv.bias, name="c", strides=2, padding="SAME")
        assert torch.equal(got, conv(x))
        w, b = torch.randn(5, 8, generator=gen, dtype=torch.float64), torch.randn(5, dtype=torch.float64)
        assert torch.equal(knn.linear(x, w, b, name="l"), F.linear(x, w, b))

    def block(h, scale):
        return torch.tanh(h * scale).sum(dim=-1)

    h1 = x.clone().requires_grad_(True)
    h2 = x.clone().requires_grad_(True)
    plain = block(h1, 2.0)
    ckpt = knn.checkpoint_block(block, h2, 2.0)
    assert torch.equal(plain, ckpt)
    plain.sum().backward()
    ckpt.sum().backward()
    assert torch.equal(h1.grad, h2.grad)


def test_functional_model_through_the_analyzer(tmp_path):
    """The public entry point takes a FunctionalModel as it takes a module:
    the artifacts saved, the model saved as its parameters, the pairwise
    scores the module form's bit for bit."""
    from kronfluence_tpu_torch import Analyzer, ScoreArguments
    from kronfluence_tpu_torch.utils.save import load_file

    _, params, _ = make_mlp()
    module = torch_mlp(params)
    task = TorchRegressionTask()
    train, query = make_regression_data(NUM_TRAIN, seed=0), make_regression_data(NUM_QUERY, seed=1)
    scores = {}
    for form, model in (("functional", FunctionalModel(torch_mlp_apply,
                                                      _nested(module.state_dict()))),
                        ("module", module)):
        analyzer = Analyzer(form, prepare_model(model, task), task, cpu=True,
                            disable_model_save=False, output_dir=str(tmp_path / form))
        analyzer.fit_all_factors("ekfac", train, per_device_batch_size=BATCH,
                                 factor_args=pytest_factor_arguments("ekfac"))
        analyzer.compute_pairwise_scores(
            "pairwise", "ekfac", query, train, per_device_query_batch_size=QUERY_BATCH,
            per_device_train_batch_size=BATCH,
            score_args=ScoreArguments(score_dtype="float64", per_sample_gradient_dtype="float64",
                                      precondition_dtype="float64"))
        scores[form] = analyzer.load_pairwise_scores("pairwise")["all_modules"]
    saved = load_file(tmp_path / "functional" / "functional" / "model.safetensors")
    assert set(saved) == {f"params.{n}" for n in module.state_dict()}
    assert scores["functional"].shape == (NUM_QUERY, NUM_TRAIN)
    assert torch.equal(scores["functional"], scores["module"])
