"""Rematerialisation (`offload_activations_to_cpu=True`, capture(remat=True))
in the port: every stage gives the results it gives without remat, within
1e-12 in fp64, and the JAX package's remat results at the reference's
tolerance; each tracked use is recorded once; the recompute replays the
stage's explicit generator and runs each region's forward again."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
from torch import nn

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
from kronfluence_tpu_torch.capture import engine
from kronfluence_tpu_torch.capture.engine import capture, remat_regions
from kronfluence_tpu_torch.factor.covariance import (
    fit_covariance_matrices_with_loader,
    train_loss_forward,
)
from kronfluence_tpu_torch.factor.eigen import (
    fit_lambda_matrices_with_loader,
    perform_eigendecomposition,
)
from kronfluence_tpu_torch.ops.attention import naive_attention
from kronfluence_tpu_torch.prepare import prepare_model
from kronfluence_tpu_torch.score.pairwise import compute_pairwise_scores_with_loaders
from kronfluence_tpu_torch.score.self_scores import compute_self_scores_with_loaders
from kronfluence_tpu_torch.task import Task
from kronfluence_tpu_torch.utils.common.factor_arguments import pytest_factor_arguments
from kronfluence_tpu_torch.utils.common.score_arguments import pytest_score_arguments
from kronfluence_tpu_torch.utils.constants import (
    ACTIVATION_COVARIANCE_MATRIX_NAME,
    ALL_MODULE_NAME,
    GRADIENT_COVARIANCE_MATRIX_NAME,
    LAMBDA_MATRIX_NAME,
)
from kronfluence_tpu_torch.utils.dataset import BatchLoader

from tests.testable_tasks.language_modeling import make_lm, make_lm_data
from tests.testable_tasks.torch_language_modeling import (
    TorchLanguageModelingTask,
    make_torch_lm,
)

# The reference's own equivalence tolerance (tests/test_reference_parity.py:61).
RTOL, ATOL = 1.3e-6, 1e-5
# Remat recomputes the same fp64 operations on the same inputs.
SAME = 1e-12
NUM_TRAIN, BATCH = 10, 4
NUM_QUERY, QUERY_BATCH = 5, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def _loader(data, batch=BATCH):
    return BatchLoader(data, batch, device="cpu")


@pytest.fixture(scope="module")
def lm():
    jmodel, params, jtask, config = make_lm()
    tmodel, ttask, _ = make_torch_lm(params, config)
    train = make_lm_data(NUM_TRAIN, seq_len=config.max_seq_len, vocab=config.vocab_size, seed=0)
    query = make_lm_data(NUM_QUERY, seq_len=config.max_seq_len, vocab=config.vocab_size, seed=1)
    targs = pytest_factor_arguments("ekfac")
    cov = fit_covariance_matrices_with_loader(tmodel, ttask, _loader(train), targs)
    eig = perform_eigendecomposition(cov, targs)
    lam = fit_lambda_matrices_with_loader(tmodel, ttask, _loader(train), targs, eigen_factors=eig)
    jargs = jax_factor_args("ekfac")
    jargs.offload_activations_to_cpu = True
    jcov = jax_fit_covariance(jmodel, params, jtask, JaxBatchLoader(train, BATCH), jargs)
    jeig = jax_eigendecomposition(jcov, jargs)
    jlam = jax_fit_lambda(jmodel, params, jtask, JaxBatchLoader(train, BATCH), jargs,
                          eigen_factors=jeig)
    return dict(jmodel=jmodel, params=params, jtask=jtask, tmodel=tmodel, ttask=ttask,
                train=train, query=query, cov=cov, eig=eig, lam=lam, jcov=jcov, jeig=jeig,
                jlam=jlam, jargs=jargs, targs=targs)


def _remat_args(make=pytest_factor_arguments):
    args = make("ekfac") if make is pytest_factor_arguments else make()
    args.offload_activations_to_cpu = True
    return args


def _same(got, want, what, tol=SAME):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(), err_msg=what)


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=what)


def test_covariance_with_remat(lm):
    got = fit_covariance_matrices_with_loader(lm["tmodel"], lm["ttask"], _loader(lm["train"]),
                                              _remat_args())
    for factor in (ACTIVATION_COVARIANCE_MATRIX_NAME, GRADIENT_COVARIANCE_MATRIX_NAME):
        for name, want in lm["cov"][factor].items():
            _same(got[factor][name], want, f"{factor}/{name}")
            _close(got[factor][name], lm["jcov"][factor][name], f"JAX remat {factor}/{name}")


@pytest.mark.parametrize("empirical", [True, False])
@pytest.mark.parametrize("iterative", [False, True])
def test_lambda_with_remat(lm, iterative, empirical):
    """Both lambda branches; sampled labels come from the stage's explicit
    generator, which the recompute must replay (JAX draws its own labels,
    so the sampled runs are held against the port without remat only)."""
    runs = []
    for remat in (False, True):
        args = pytest_factor_arguments("ekfac")
        args.use_iterative_lambda_aggregation = iterative
        args.use_empirical_fisher = empirical
        args.offload_activations_to_cpu = remat
        runs.append(fit_lambda_matrices_with_loader(
            lm["tmodel"], lm["ttask"], _loader(lm["train"]), args, eigen_factors=lm["eig"]))
    plain, remat = runs
    for name, want in plain[LAMBDA_MATRIX_NAME].items():
        _same(remat[LAMBDA_MATRIX_NAME][name], want, name)
        if empirical:
            _close(remat[LAMBDA_MATRIX_NAME][name], lm["jlam"][LAMBDA_MATRIX_NAME][name], name)


def _jax_factors(lm):
    return {**lm["jcov"], **lm["jeig"], **lm["jlam"]}


def test_pairwise_with_remat(lm):
    factors = {**lm["cov"], **lm["eig"], **lm["lam"]}
    runs = [
        compute_pairwise_scores_with_loaders(
            lm["tmodel"], lm["ttask"], _loader(lm["query"], QUERY_BATCH), _loader(lm["train"]),
            factors, lm["targs"], args)[ALL_MODULE_NAME]
        for args in (pytest_score_arguments(), _remat_args(pytest_score_arguments))
    ]
    _same(runs[1], runs[0], "pairwise")
    want = jax_pairwise(
        lm["jmodel"], lm["params"], lm["jtask"], JaxBatchLoader(lm["query"], QUERY_BATCH),
        JaxBatchLoader(lm["train"], BATCH), _jax_factors(lm), lm["jargs"],
        _remat_args(jax_score_args))[ALL_MODULE_NAME]
    _close(runs[1], want, "JAX remat pairwise")


@pytest.mark.parametrize("use_measurement", [False, True])
def test_self_scores_with_remat(lm, use_measurement):
    factors = {**lm["cov"], **lm["eig"], **lm["lam"]}
    runs = []
    for args in (pytest_score_arguments(), _remat_args(pytest_score_arguments)):
        args.use_measurement_for_self_influence = use_measurement
        runs.append(compute_self_scores_with_loaders(
            lm["tmodel"], lm["ttask"], _loader(lm["train"]), factors, lm["targs"],
            args)[ALL_MODULE_NAME])
    _same(runs[1], runs[0], "self")
    jscore = _remat_args(jax_score_args)
    jscore.use_measurement_for_self_influence = use_measurement
    want = jax_self(lm["jmodel"], lm["params"], lm["jtask"], JaxBatchLoader(lm["train"], BATCH),
                    _jax_factors(lm), lm["jargs"], jscore)[ALL_MODULE_NAME]
    _close(runs[1], want, "JAX remat self")


class _BlocksOnly(TorchLanguageModelingTask):
    """Tracks the four projections of every block, not the head: the remat
    regions are then the blocks' attention and MLP modules."""

    def get_influence_tracked_modules(self):
        return [f"h_{i}/{m}" for i in range(2)
                for m in ("attn/c_attn", "attn/c_proj", "mlp/c_fc", "mlp/c_proj")]


def _batch(lm):
    batch, _ = _loader(lm["train"]).probe()
    return batch


def test_each_use_is_recorded_once_and_regions_are_restored(lm):
    task = _BlocksOnly()
    model = prepare_model(lm["tmodel"].module, task)
    names = [type(m).__name__ for m in remat_regions(model)]
    assert names == ["Attention", "MLPBlock"] * 2
    assert [type(m).__name__ for m in remat_regions(lm["tmodel"])][-1] == "TransformerLM"
    forward = train_loss_forward(model, task, _batch(lm), False, None)
    naive_attention.calls = 0
    _, plain = capture(model, forward)
    plain_calls, naive_attention.calls = naive_attention.calls, 0
    _, remat = capture(model, forward, remat=True)
    assert plain_calls == 2
    # The recompute runs each attention's forward once more.
    assert naive_attention.calls == 2 * plain_calls
    assert all("forward" not in m.__dict__ for m in model.module.modules())
    for name, cap in plain.items():
        assert len(remat[name].activations) == len(cap.activations) == 1
        assert len(remat[name].output_gradients) == 1
        assert torch.equal(remat[name].activations[0], cap.activations[0])
        assert torch.equal(remat[name].output_gradients[0], cap.output_gradients[0])


def test_flash_form_with_remat(lm):
    """The flash autograd Function (its plain versions on the CPU) under the
    checkpoint: the same covariance as without remat."""
    _, params, _, config = make_lm(max_seq_len=128, d_model=128, num_heads=2)
    tmodel, ttask, _ = make_torch_lm(params, config, attention="flash")
    train = make_lm_data(4, seq_len=128, vocab=config.vocab_size, seed=0)
    runs = [fit_covariance_matrices_with_loader(tmodel, ttask, _loader(train, 2), args)
            for args in (pytest_factor_arguments("ekfac"), _remat_args())]
    for factor in (ACTIVATION_COVARIANCE_MATRIX_NAME, GRADIENT_COVARIANCE_MATRIX_NAME):
        for name, want in runs[0][factor].items():
            _same(runs[1][factor][name], want, f"{factor}/{name}")


# -- The explicit generator, drawn from inside a region. --
class _Noisy(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(4, 8, dtype=torch.float64)
        self.out = nn.Linear(8, 1, dtype=torch.float64)

    def forward(self, x, generator):
        h = self.fc(x)
        noise = torch.randn(h.shape, generator=generator, dtype=h.dtype)
        return self.out(torch.tanh(h + noise))


class _NoisyTask(Task):
    def compute_train_loss(self, batch, model, sample=False, generator=None):
        return torch.sum(model(batch["x"], generator) ** 2)

    def compute_measurement(self, batch, model):
        raise NotImplementedError


def test_the_recompute_replays_the_generator():
    """The noise is drawn inside the remat region (the root module holds the
    tracked Linears), so the recompute draws it again: with the generator
    restored the gradients and the generator's next draw are those without
    remat; without the restore (no generator given) they are not."""
    torch.manual_seed(0)
    task = _NoisyTask()
    model = prepare_model(_Noisy(), task)
    x = torch.randn(6, 4, dtype=torch.float64, generator=torch.Generator().manual_seed(1))

    def run(remat, give_generator):
        gen = torch.Generator().manual_seed(3)
        forward = train_loss_forward(model, task, {"x": x}, True, gen)
        _, caps = capture(model, forward, remat=remat, generator=gen if give_generator else None)
        return caps, torch.rand(1, generator=gen)

    plain, plain_next = run(False, True)
    remat, remat_next = run(True, True)
    unrestored, _ = run(True, False)
    assert torch.equal(plain_next, remat_next)
    for name in plain:
        assert torch.equal(remat[name].output_gradients[0], plain[name].output_gradients[0])
    assert not torch.equal(unrestored["fc"].output_gradients[0], plain["fc"].output_gradients[0])


def test_recompute_contexts_leave_no_hooks():
    task = _NoisyTask()
    model = prepare_model(_Noisy(), task)
    gen = torch.Generator().manual_seed(0)
    forward = train_loss_forward(model, task, {"x": torch.ones(2, 4, dtype=torch.float64)},
                                 True, gen)
    capture(model, forward, remat=True, generator=gen)
    assert not any(m._forward_hooks for m in model.module.modules())
    assert "forward" not in model.module.__dict__
    assert engine.remat_regions(model) == [model.module]
