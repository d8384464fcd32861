"""The port's hook-and-probe capture against kronfluence_tpu.capture.engine."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from kronfluence_tpu.capture.engine import capture as jax_capture
from kronfluence_tpu.factor.covariance import train_loss_forward as jax_forward
from kronfluence_tpu.prepare import prepare_model as jax_prepare
from kronfluence_tpu_torch.capture.engine import capture, discover_specs
from kronfluence_tpu_torch.factor.covariance import train_loss_forward
from kronfluence_tpu_torch.prepare import prepare_model
from kronfluence_tpu_torch.utils.exceptions import TrackedModuleNotFoundError

from tests.testable_tasks.language_modeling import (
    LanguageModelingTask,
    MLPOnlyLanguageModelingTask,
    make_lm,
    make_lm_data,
)
from tests.testable_tasks.torch_language_modeling import make_torch_lm

# fp64 on both sides; the only differences are op orders (1e-15 relative),
# grown by the backward pass through softmax and LayerNorm.
RTOL, ATOL = 1e-9, 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread for numpy's host eigh: OpenBLAS's thread team spins
    against the suite's other workers (tests/test_torch_analyzer_release.py)."""
    with threadpool_limits(limits=1):
        yield


def _spec_fields(spec):
    return (spec.name, spec.kind, spec.has_bias, spec.in_dim, spec.out_dim)


@pytest.fixture(scope="module")
def lm():
    """One flax init (fp64 params) shared by the file's tests."""
    jmodel, params, _, config = make_lm()
    return jmodel.module, params, config


@pytest.mark.parametrize("mlp_only", [False, True])
def test_lm_capture_matches_jax(lm, mlp_only):
    module, params, config = lm
    jtask = MLPOnlyLanguageModelingTask(config.num_layers) if mlp_only else LanguageModelingTask()
    jmodel = jax_prepare(module, jtask)
    tmodel, ttask, _ = make_torch_lm(params, config, mlp_only=mlp_only)
    data = make_lm_data(4, seq_len=config.max_seq_len, vocab=config.vocab_size, seed=7)
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in data.items()}

    jloss, jcaps = jax_capture(
        jax_forward(jmodel, jtask, params, jbatch, sample=False, rng=jax.random.PRNGKey(0)),
        jmodel.tracked_names,
    )
    tloss, tcaps = capture(tmodel, train_loss_forward(tmodel, ttask, tbatch, False, None))

    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-12)
    assert list(tcaps) == list(jcaps)  # same names, same (forward) order
    for name, jcap in jcaps.items():
        tcap = tcaps[name]
        assert _spec_fields(tcap.spec) == _spec_fields(jcap.spec)
        assert len(tcap.activations) == len(jcap.activations) == 1
        for got, want in zip(tcap.activations, jcap.activations):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        for got, want in zip(tcap.output_gradients, jcap.output_gradients):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


class _FlaxShared(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        shared = fnn.Dense(4, name="shared")
        return fnn.Dense(1, name="head")(shared(jnp.tanh(shared(x))))


class _TorchShared(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.shared = torch.nn.Linear(4, 4, dtype=torch.float64)
        self.head = torch.nn.Linear(4, 1, dtype=torch.float64)

    def forward(self, x):
        return self.head(self.shared(torch.tanh(self.shared(x))))


def test_shared_layer_records_every_use_like_jax():
    x = np.random.default_rng(0).standard_normal((5, 4))
    module = _FlaxShared()
    params = jax.tree_util.tree_map(
        lambda p: p.astype(jnp.float64),
        module.init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))["params"],
    )
    jmodel = jax_prepare(module)
    _, jcaps = jax_capture(lambda: jnp.sum(jmodel.apply_fn(params, jnp.asarray(x)) ** 2))

    tmod = _TorchShared()
    with torch.no_grad():
        for name in ("shared", "head"):
            getattr(tmod, name).weight.copy_(torch.tensor(np.asarray(params[name]["kernel"]).T))
            getattr(tmod, name).bias.copy_(torch.tensor(np.asarray(params[name]["bias"])))
    tmodel = prepare_model(tmod)
    xt = torch.from_numpy(x)
    _, tcaps = capture(tmodel, lambda: (tmodel.module(xt) ** 2).sum())

    assert len(tcaps["shared"].activations) == len(jcaps["shared"].activations) == 2
    assert len(tcaps["head"].activations) == 1
    for name in ("shared", "head"):
        for got, want in zip(tcaps[name].output_gradients, jcaps[name].output_gradients):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        for got, want in zip(tcaps[name].activations, jcaps[name].activations):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_capture_leaves_parameters_without_gradients(lm):
    _, params, config = lm
    tmodel, ttask, _ = make_torch_lm(params, config)
    data = make_lm_data(2, seq_len=config.max_seq_len, vocab=config.vocab_size)
    batch = {k: torch.from_numpy(v) for k, v in data.items()}
    capture(tmodel, train_loss_forward(tmodel, ttask, batch, False, None))
    assert all(p.grad is None and not p.requires_grad for p in tmodel.module.parameters())


def test_loss_scale_unscales_gradients(lm):
    _, params, config = lm
    tmodel, ttask, _ = make_torch_lm(params, config)
    data = make_lm_data(2, seq_len=config.max_seq_len, vocab=config.vocab_size)
    batch = {k: torch.from_numpy(v) for k, v in data.items()}
    forward = train_loss_forward(tmodel, ttask, batch, False, None)
    _, plain = capture(tmodel, forward)
    _, scaled = capture(tmodel, forward, loss_scale=1024.0)
    for name in plain:
        torch.testing.assert_close(
            scaled[name].output_gradients[0], plain[name].output_gradients[0],
            rtol=1e-12, atol=1e-15,
        )


def test_untracked_model_raises(lm):
    _, params, config = lm
    tmodel, ttask, _ = make_torch_lm(params, config)
    tmodel.tracked_names = ["no/such/module"]
    data = make_lm_data(2, seq_len=config.max_seq_len, vocab=config.vocab_size)
    batch = {k: torch.from_numpy(v) for k, v in data.items()}
    forward = train_loss_forward(tmodel, ttask, batch, False, None)
    assert discover_specs(tmodel, forward) == {}
    with pytest.raises(TrackedModuleNotFoundError):
        capture(tmodel, forward)
