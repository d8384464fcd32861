"""The port's memory model (utils/memory.py) against kronfluence_tpu's: the
same probes, per-example and static bytes, and the same batch-size
estimates on the tiny GPT-2, over stage x remat x iterative lambda x amp
dtype; the JAX package's behaviour tests (tests/test_memory_estimate.py) on
the port; and the port's own `autograd_bytes` term."""

import gc

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
from torch import nn

from kronfluence_tpu.arguments import FactorArguments as JaxFactorArguments
from kronfluence_tpu.arguments import ScoreArguments as JaxScoreArguments
from kronfluence_tpu.utils import memory as jax_memory
from kronfluence_tpu.utils.dataset import BatchLoader as JaxBatchLoader
from kronfluence_tpu_torch.arguments import FactorArguments, ScoreArguments
from kronfluence_tpu_torch.prepare import prepare_model
from kronfluence_tpu_torch.task import Task
from kronfluence_tpu_torch.utils import memory
from kronfluence_tpu_torch.utils.dataset import BatchLoader

from tests.testable_tasks.language_modeling import make_lm, make_lm_data
from tests.testable_tasks.torch_language_modeling import make_torch_lm

STAGES = ("covariance", "lambda", "pairwise", "self")
BATCH = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lm():
    jmodel, params, jtask, config = make_lm()
    tmodel, ttask, _ = make_torch_lm(params, config)
    data = make_lm_data(BATCH, seq_len=config.max_seq_len, vocab=config.vocab_size, seed=0)
    jbatch, _ = JaxBatchLoader(data, BATCH).probe()
    tbatch, _ = BatchLoader(data, BATCH, device="cpu").probe()
    return dict(
        jprobes=jax_memory.probe_modules(jmodel, jtask, params, jbatch, BATCH),
        tprobes=memory.probe_modules(tmodel, ttask, tbatch, BATCH),
        params=params, tmodel=tmodel, ttask=ttask, tbatch=tbatch,
    )


def _facts(probes):
    return {n: (p.tokens, p.uses, p.spec.kind, p.spec.has_bias, p.spec.in_dim, p.spec.out_dim,
                p.spec.activation_dim, p.spec.gradient_dim) for n, p in probes.items()}


def test_probes_match_jax(lm):
    assert _facts(lm["tprobes"]) == _facts(lm["jprobes"])
    assert len(lm["tprobes"]) == 9  # 2 blocks x 4 projections, and the head


def _arguments(stage, remat, iterative, amp):
    """(JAX arguments, port arguments) of one stage, with its flags and dtypes."""
    low = "bfloat16" if amp is None else amp
    if stage in ("covariance", "lambda"):
        fields = dict(offload_activations_to_cpu=remat, use_iterative_lambda_aggregation=iterative,
                      amp_dtype=amp, activation_covariance_dtype=low, per_sample_gradient_dtype=low)
        return dict(factor_args=JaxFactorArguments(**fields)), dict(
            factor_args=FactorArguments(**fields))
    fields = dict(offload_activations_to_cpu=remat, amp_dtype=amp, per_sample_gradient_dtype=low)
    return dict(score_args=JaxScoreArguments(**fields)), dict(score_args=ScoreArguments(**fields))


@pytest.mark.parametrize("amp", [None, "bfloat16", "float16"])
@pytest.mark.parametrize("iterative", [False, True])
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("stage", STAGES)
def test_bytes_and_estimates_match_jax(lm, stage, remat, iterative, amp):
    width = 4 if amp is None else 2
    kw = dict(capture_bytes=width, stage_bytes=2, psg_bytes=2, remat=remat,
              iterative_lambda=iterative)
    want = jax_memory.per_example_bytes(lm["jprobes"], stage, **kw)
    assert memory.per_example_bytes(lm["tprobes"], stage, **kw) == want
    jargs, targs = _arguments(stage, remat, iterative, amp)
    assert memory.stage_per_example_bytes(lm["tprobes"], stage, **targs) > 0
    assert memory.static_bytes(lm["tprobes"], stage, lm["tmodel"].module) == (
        jax_memory.static_bytes(lm["jprobes"], stage, lm["params"]))
    for budget in (2e5, 1e6, 4e6, 1e8, 1e12):
        got = memory.estimate_batch_size(
            lm["tprobes"], stage, params=lm["tmodel"].module, budget_bytes=budget, **targs)
        expect = jax_memory.estimate_batch_size(
            lm["jprobes"], stage, params=lm["params"], budget_bytes=budget, **jargs)
        assert got == expect and 1 <= got <= 4096, budget


def test_budget_and_limit_on_the_cpu():
    """15 GiB, as the JAX package assumes without device stats, nothing in
    use: half of it to plan against."""
    assert memory.device_memory_limit("cpu") == 15 * 2**30
    assert memory.device_memory_in_use("cpu") == 0.0
    assert memory.device_memory_budget("cpu") == 7.5 * 2**30
    assert memory.device_memory_budget("cpu", 0.25) == 3.75 * 2**30


def test_estimate_needs_a_budget_or_a_device(lm):
    with pytest.raises(ValueError, match="budget_bytes or the device"):
        memory.estimate_batch_size(lm["tprobes"], "covariance")
    on_cpu = memory.estimate_batch_size(lm["tprobes"], "covariance", device="cpu")
    assert on_cpu == memory.estimate_batch_size(
        lm["tprobes"], "covariance", budget_bytes=7.5 * 2**30)


# -- The JAX package's behaviour tests, on the port. --
class _SeqTask(Task):
    def compute_train_loss(self, batch, model, sample=False, generator=None):
        return torch.sum(model(batch["x"]) ** 2)

    def compute_measurement(self, batch, model):
        return torch.sum(model(batch["x"]))


class _Dense(nn.Module):
    def __init__(self, d_in, d_out):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out, dtype=torch.float32)
        nn.init.ones_(self.dense.weight)
        nn.init.zeros_(self.dense.bias)

    def forward(self, x):
        return self.dense(x)


def _probe_seq(seq_len, batch=2, d_in=8, d_out=4):
    task = _SeqTask()
    model = prepare_model(_Dense(d_in, d_out), task)
    x = torch.ones(batch, seq_len, d_in)
    return memory.probe_modules(model, task, {"x": x}, batch), model


def test_probe_measures_true_token_counts():
    probes, _ = _probe_seq(seq_len=37)
    assert probes["dense"].tokens == 37 and probes["dense"].uses == 1


def test_per_example_bytes_scales_with_sequence_length():
    short, _ = _probe_seq(seq_len=128)
    long, _ = _probe_seq(seq_len=1024)
    assert memory.per_example_bytes(long, "covariance") == pytest.approx(
        8 * memory.per_example_bytes(short, "covariance"), rel=0.01)


def test_batch_size_halves_when_sequence_doubles():
    probes_1k, model = _probe_seq(seq_len=1024)
    probes_2k, _ = _probe_seq(seq_len=2048)
    budget = 1 << 27
    fit_1k = memory.estimate_batch_size(probes_1k, "covariance", params=model.module,
                                        budget_bytes=budget)
    fit_2k = memory.estimate_batch_size(probes_2k, "covariance", params=model.module,
                                        budget_bytes=budget)
    assert fit_2k == pytest.approx(fit_1k / 2, rel=0.05)
    assert fit_1k >= 2


def test_remat_increases_batch_size():
    probes, _ = _probe_seq(seq_len=512)
    budget = 1 << 26
    no_remat = memory.estimate_batch_size(probes, "covariance", budget_bytes=budget,
                                          factor_args=FactorArguments())
    with_remat = memory.estimate_batch_size(
        probes, "covariance", budget_bytes=budget,
        factor_args=FactorArguments(offload_activations_to_cpu=True))
    assert with_remat > no_remat


def test_iterative_lambda_increases_batch_size():
    probes, _ = _probe_seq(seq_len=4, d_in=512, d_out=512)
    budget = 1 << 24
    batched = memory.estimate_batch_size(probes, "lambda", budget_bytes=budget,
                                         factor_args=FactorArguments())
    iterative = memory.estimate_batch_size(
        probes, "lambda", budget_bytes=budget,
        factor_args=FactorArguments(use_iterative_lambda_aggregation=True))
    assert iterative > batched


def test_static_bytes_counts_params_and_factor_state():
    probes, model = _probe_seq(seq_len=16)
    d_in, d_out = 9, 4  # 8 + bias, 4
    assert memory.static_bytes(probes, "covariance", model.module) == pytest.approx(
        (d_in * d_in + d_out * d_out) * 4 + (8 * 4 + 4) * 4)


def test_estimate_is_clamped_and_positive():
    probes, _ = _probe_seq(seq_len=64)
    assert memory.estimate_batch_size(probes, "covariance", budget_bytes=0) == 1
    assert memory.estimate_batch_size(probes, "covariance", budget_bytes=1 << 40,
                                      max_batch_size=128) == 128


def test_untracked_bytes_lower_the_estimate():
    probes, _ = _probe_seq(seq_len=64)
    per_example = memory.per_example_bytes(probes, "covariance")
    plain = memory.estimate_batch_size(probes, "covariance", budget_bytes=1 << 24)
    extra = memory.estimate_batch_size(probes, "covariance", budget_bytes=1 << 24,
                                       untracked_bytes=per_example)
    assert extra == plain // 2


# -- autograd_bytes: what torch's autograd keeps for the backward pass. --
def test_autograd_bytes_of_a_linear_chain():
    """A frozen Linear saves nothing for the gradient of its input; the
    square saves its input, the (2, 16, 4) output: 512 bytes of fp32, per
    example 256, plus twice the largest saved tensor."""
    _, model = _probe_seq(seq_len=16)
    got = memory.autograd_bytes(model, _SeqTask(), {"x": torch.ones(2, 16, 8)}, 2)
    assert got == (512 + 2 * 512) / 2


def test_autograd_bytes_of_the_tiny_lm(lm):
    """Per example, what the tiny GPT-2's backward keeps: less under remat,
    where each attention and MLP is recomputed."""
    plain = memory.autograd_bytes(lm["tmodel"], lm["ttask"], lm["tbatch"], BATCH)
    remat = memory.autograd_bytes(lm["tmodel"], lm["ttask"], lm["tbatch"], BATCH, remat=True)
    assert 0 < remat < plain
    # The log-probabilities over the vocabulary, the largest saved tensor:
    # (3, 31, 128) fp64 a batch, three times (saved, gradient, input gradient).
    assert plain >= 3 * 31 * 128 * 8


def test_autograd_bytes_leaves_no_tensor_behind(lm):
    """The measuring forward's graph is freed when the call returns: no
    tensor of it stays reachable, not even through a cycle (an op's saved
    output referring back to its own node) that no collector frees."""
    gc.collect()
    gc.disable()
    try:
        before = {id(o) for o in gc.get_objects() if isinstance(o, torch.Tensor)}
        memory.autograd_bytes(lm["tmodel"], lm["ttask"], lm["tbatch"], BATCH)
        left = [o for o in gc.get_objects() if isinstance(o, torch.Tensor) and id(o) not in before]
    finally:
        gc.enable()
    assert left == []


def test_query_block_bytes_match_jax(lm):
    for storage in (None, "float8_e4m3fn"):
        got = memory.query_block_bytes(
            lm["tprobes"], ScoreArguments(query_gradient_storage_dtype=storage), 5)
        want = jax_memory.query_block_bytes(
            lm["jprobes"], JaxScoreArguments(query_gradient_storage_dtype=storage), 5)
        assert got == want > 0


def test_log_hbm_is_off_unless_asked(monkeypatch, capsys):
    monkeypatch.delenv("KF_MEM_LOG", raising=False)
    memory.log_hbm("off", "cpu")
    assert capsys.readouterr().err == ""
    monkeypatch.setenv("KF_MEM_LOG", "1")
    memory.log_hbm("stage", "cpu")
    assert "HBM[stage]: in_use 0.00 GB, peak 0.00 GB, limit 15.00 GB" in capsys.readouterr().err


def test_probe_batch_of_rows_matches_columns(lm):
    """Probes from a dataset of rows equal the column store's."""
    data = make_lm_data(BATCH, seq_len=32, vocab=128, seed=0)
    rows = [{k: v[i] for k, v in data.items()} for i in range(BATCH)]
    batch, _ = BatchLoader(rows, BATCH, device="cpu").probe()
    probes = memory.probe_modules(lm["tmodel"], lm["ttask"], batch, BATCH)
    assert _facts(probes) == _facts(lm["tprobes"])
    assert np.array_equal(batch["input_ids"].numpy(), lm["tbatch"]["input_ids"].numpy())


# -- The eager preconditioning's arrays, the port's own terms (card only). --
def _largest_oi(probes):
    return max(p.spec.activation_dim * p.spec.gradient_dim for p in probes.values())


@pytest.mark.parametrize("psg,precond,per_entry", [
    ("bfloat16", "float32", 4 + 3 * 4),
    ("float16", "float32", 4 + 3 * 4),
    ("float32", "float32", 3 * 4),
    ("bfloat16", "float64", 8 + 3 * 8),
])
def test_precondition_bytes_per_entry(lm, psg, precond, per_entry):
    """The cast of the per-sample gradient to the precondition dtype (none
    where the dtypes agree) and the sandwich's three arrays, per (o, i)
    entry of the largest module."""
    args = ScoreArguments(per_sample_gradient_dtype=psg, precondition_dtype=precond)
    got = memory.precondition_bytes(lm["tprobes"], args)
    assert got == _largest_oi(lm["tprobes"]) * per_entry


@pytest.mark.parametrize("query_batch", [1, 4096])
def test_pairwise_plan_holds_the_query_step_on_the_card(lm, query_batch):
    """On the card the plan holds the larger of the train pass and the
    query step's preconditioning (they never run together); on the CPU the
    train pass alone."""
    args = ScoreArguments(per_sample_gradient_dtype="bfloat16")
    probes = lm["tprobes"]

    def plan(device, train_batch=2):
        return memory.pairwise_plan_bytes(probes, args, 4, train_batch_size=train_batch,
                                          num_train=10, query_batch_size=query_batch,
                                          device=device)

    cpu = plan("cpu")
    train_pass = cpu - plan("cpu", train_batch=0)
    query_step = query_batch * (memory.precondition_bytes(probes, args)
                                + _largest_oi(probes) * 2)
    assert plan("cuda") == cpu - train_pass + max(train_pass, query_step)
    assert (plan("cuda") > cpu) is (query_step > train_pass)
