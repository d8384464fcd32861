"""The port's Llama path against the JAX package's: `models/llama.py` (RMSNorm,
interleaved RoPE, GQA, SwiGLU) on flax weights converted by
`models/convert.py`, the openwebtext task's loss and margin, MLP-only capture
and covariance factors, and both Analyzers with the extreme-reduce-memory
recipe (module and data partitions, iterative lambda, remat) in fp64."""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from threadpoolctl import threadpool_limits
import torch.nn.functional as F

from kronfluence_tpu.analyzer import Analyzer as JaxAnalyzer
from kronfluence_tpu.capture.engine import capture as jax_capture
from kronfluence_tpu.factor.covariance import (
    fit_covariance_matrices_with_loader as jax_fit_covariance,
    train_loss_forward as jax_forward,
)
from kronfluence_tpu.models import llama as jax_llama
from kronfluence_tpu.prepare import prepare_model as jax_prepare
from kronfluence_tpu.score.common import module_per_sample_gradients as jax_psg
from kronfluence_tpu.utils.common.factor_arguments import (
    extreme_reduce_memory_factor_arguments as jax_extreme_factor_args,
)
from kronfluence_tpu.utils.common.score_arguments import (
    extreme_reduce_memory_score_arguments as jax_extreme_score_args,
)
from kronfluence_tpu.utils.dataset import BatchLoader as JaxBatchLoader
from kronfluence_tpu_torch import Analyzer
from kronfluence_tpu_torch.capture.engine import capture
from kronfluence_tpu_torch.factor.covariance import (
    fit_covariance_matrices_with_loader,
    train_loss_forward,
)
from kronfluence_tpu_torch.models import llama
from kronfluence_tpu_torch.models.convert import state_dict_from_flax
from kronfluence_tpu_torch.prepare import prepare_model
from kronfluence_tpu_torch.score.common import module_per_sample_gradients
from kronfluence_tpu_torch.task import Task
from kronfluence_tpu_torch.utils.common.factor_arguments import (
    extreme_reduce_memory_factor_arguments,
)
from kronfluence_tpu_torch.utils.common.score_arguments import (
    extreme_reduce_memory_score_arguments,
)
from kronfluence_tpu_torch.utils.constants import (
    ALL_MODULE_NAME,
    COVARIANCE_FACTOR_NAMES,
    LAMBDA_FACTOR_NAMES,
)
from kronfluence_tpu_torch.utils.dataset import BatchLoader

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from examples.openwebtext.task import LlamaMLPOnlyTask  # noqa: E402

# The reference's own equivalence tolerance (tests/test_reference_parity.py:61).
RTOL, ATOL = 1.3e-6, 1e-5
NUM_TRAIN, NUM_QUERY, BATCH = 12, 4, 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


class OpenWebTextTask(Task):
    """Port of examples/openwebtext/task.py:LlamaMLPOnlyTask: the summed fp32
    token cross-entropy over the shifted mask (labels sampled from the
    explicit generator by Gumbel-max, as `jax.random.categorical` draws
    them), the margin measurement (the label's logit against the logsumexp
    of the others), and MLP-only tracking."""

    def __init__(self, num_layers: int, logits_dtype=torch.float32):
        self.num_layers = num_layers
        self.logits_dtype = logits_dtype

    def compute_train_loss(self, batch, model, sample=False, generator=None):
        logits = model(batch["input_ids"], batch["attention_mask"])[:, :-1].to(self.logits_dtype)
        mask = batch["attention_mask"][:, 1:].to(logits.dtype)
        if sample:
            noise = torch.empty_like(logits).exponential_(generator=generator)
            labels = noise.log_().neg_().add_(logits.detach()).argmax(dim=-1)
        else:
            labels = batch["input_ids"][:, 1:].long()
        losses = F.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), labels.reshape(-1), reduction="none"
        ).reshape(mask.shape)
        return torch.sum(losses * mask)

    def compute_measurement(self, batch, model):
        logits = model(batch["input_ids"], batch["attention_mask"])[:, :-1].to(self.logits_dtype)
        labels = batch["input_ids"][:, 1:].long()[..., None]
        mask = batch["attention_mask"][:, 1:].to(logits.dtype)
        correct = logits.gather(-1, labels)[..., 0]
        others = logits.scatter(-1, labels, float("-inf"))
        return -torch.sum((correct - torch.logsumexp(others, dim=-1)) * mask)

    def get_influence_tracked_modules(self):
        return llama.mlp_tracked_modules(self.num_layers)

    def get_attention_mask(self, batch):
        return batch["attention_mask"]


class Fp64LlamaMLPOnlyTask(LlamaMLPOnlyTask):
    """The flax task with the logits left in the model's dtype (it casts
    them to fp32), so that both packages run the recipe in fp64 throughout."""

    def compute_train_loss(self, batch, model, sample=False, rng=None):
        assert not sample
        logits = model(batch["input_ids"], batch["attention_mask"])[:, :-1]
        mask = batch["attention_mask"][:, 1:].astype(logits.dtype)
        losses = optax.softmax_cross_entropy_with_integer_labels(logits, batch["input_ids"][:, 1:])
        return jnp.sum(losses * mask)

    def compute_measurement(self, batch, model):
        logits = model(batch["input_ids"], batch["attention_mask"])[:, :-1]
        labels = batch["input_ids"][:, 1:]
        correct = jnp.take_along_axis(logits, labels[..., None], axis=-1)[..., 0]
        others = jnp.where(jax.nn.one_hot(labels, logits.shape[-1], dtype=bool), -jnp.inf, logits)
        margins = correct - jax.nn.logsumexp(others, axis=-1)
        return -jnp.sum(margins * batch["attention_mask"][:, 1:].astype(logits.dtype))


def _pair(num_kv_heads=2, attention="naive", **overrides):
    """(flax module, fp64 params, flax config, torch LlamaLM on the same
    weights) at the tiny config."""
    jconfig = jax_llama.tiny_llama_config(
        num_kv_heads=num_kv_heads, dtype=jnp.float64, param_dtype=jnp.float64, **overrides
    )
    module = jax_llama.LlamaLM(jconfig)
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((1, jconfig.max_seq_len), jnp.int32))
    params = params["params"]
    tconfig = llama.tiny_llama_config(
        num_kv_heads=num_kv_heads, dtype=torch.float64, attention=attention, **overrides
    )
    tmodel = llama.LlamaLM(tconfig)
    tmodel.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), tconfig))
    return module, params, jconfig, tmodel


def _data(n, seq, vocab, seed):
    """Tokens from a numpy seed, every other example padded at its tail."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, size=(n, seq)).astype(np.int32)
    mask = np.ones((n, seq), dtype=np.int32)
    for i in range(1, n, 2):
        keep = int(rng.integers(seq // 2, seq))
        ids[i, keep:] = 0
        mask[i, keep:] = 0
    return {"input_ids": ids, "attention_mask": mask}


def _torch(data):
    return {k: torch.from_numpy(v) for k, v in data.items()}


@pytest.fixture(scope="module")
def gqa2():
    return _pair(num_kv_heads=2)


@pytest.mark.parametrize("num_kv_heads", [4, 2, 1])
def test_logits_match_flax(num_kv_heads):
    """Every position, padded ones included (the naive form on both sides).
    num_kv_heads 2 of 4 query heads catches a tiled GQA repeat."""
    module, params, jconfig, tmodel = _pair(num_kv_heads)
    data = _data(4, jconfig.max_seq_len, jconfig.vocab_size, seed=num_kv_heads)
    want = np.asarray(module.apply({"params": params}, *map(jnp.asarray, data.values())))
    with torch.no_grad():
        got = tmodel(**_torch(data)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_tiled_kv_heads_would_not_match(gqa2):
    """The GQA check has teeth: the same model with the KV heads tiled
    (`repeat` in place of `repeat_interleave`) reads off the flax logits."""
    module, params, jconfig, tmodel = gqa2
    data = _data(2, jconfig.max_seq_len, jconfig.vocab_size, seed=9)
    want = np.asarray(module.apply({"params": params}, *map(jnp.asarray, data.values())))
    real = torch.Tensor.repeat_interleave
    try:
        torch.Tensor.repeat_interleave = lambda t, g, dim: t.repeat(1, g, 1, 1)
        with torch.no_grad():
            got = tmodel(**_torch(data)).numpy()
    finally:
        torch.Tensor.repeat_interleave = real
    assert np.abs(got - want).max() > 1e-3


def test_rope_matches_flax():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 4, 16, 8))
    k = rng.standard_normal((2, 2, 16, 8))
    want = jax_llama._rope(jnp.asarray(q), jnp.asarray(k), 500_000.0)
    got = llama._rope(torch.from_numpy(q), torch.from_numpy(k), 500_000.0)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)
    # Interleaved pairs, not halves: position 1 rotates (x0, x1) by one radian.
    x = torch.zeros(1, 1, 2, 4, dtype=torch.float64)
    x[0, 0, 1, 0] = 1.0
    out, _ = llama._rope(x, x, 10_000.0)
    np.testing.assert_allclose(out[0, 0, 1, :2].numpy(), [np.cos(1.0), np.sin(1.0)], atol=1e-15)


def test_rmsnorm_stat_and_output_dtypes():
    norm = llama.RMSNorm(8, 1e-5, torch.bfloat16)
    x = torch.randn(3, 8, dtype=torch.bfloat16)
    out = norm(x)
    want = x.float() * torch.rsqrt(x.float().square().mean(-1, keepdim=True) + 1e-5)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, want.to(torch.bfloat16))


def test_flash_at_head_dim_128_matches_flax_naive():
    """attention="flash" (the CPU runs F1's and F2 + F3's plain versions) at
    head_dim 128 against the flax model's naive form, at valid positions:
    padded query rows attend differently in the two forms."""
    overrides = dict(d_model=256, num_heads=2, max_seq_len=128, d_mlp=320)
    module, params, jconfig, tmodel = _pair(num_kv_heads=1, attention="flash", **overrides)
    assert tmodel.config.head_dim == 128
    data = _data(2, 128, jconfig.vocab_size, seed=4)
    want = np.asarray(module.apply({"params": params}, *map(jnp.asarray, data.values())))
    with torch.no_grad():
        got = tmodel(**_torch(data)).numpy()
    valid = data["attention_mask"].astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], rtol=RTOL, atol=ATOL)


def test_task_loss_and_margin_match_flax(gqa2):
    """Both tasks take fp32 logits (the flax task casts them, whatever the
    model's dtype), so the fp64 models' losses agree to fp32 sums in another
    order."""
    module, params, jconfig, tmodel = gqa2
    data = _data(4, jconfig.max_seq_len, jconfig.vocab_size, seed=5)
    jtask, ttask = LlamaMLPOnlyTask(jconfig.num_layers), OpenWebTextTask(jconfig.num_layers)
    bound = module.bind({"params": params})
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    with torch.no_grad():
        for name in ("compute_train_loss", "compute_measurement"):
            want = float(getattr(jtask, name)(jbatch, bound))
            got = float(getattr(ttask, name)(_torch(data), tmodel))
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
    assert ttask.get_influence_tracked_modules() == jtask.get_influence_tracked_modules()


def test_sampled_labels_follow_the_generator(gqa2):
    _, _, jconfig, tmodel = gqa2
    task, batch = OpenWebTextTask(2), _torch(_data(2, jconfig.max_seq_len, jconfig.vocab_size, 6))
    with torch.no_grad():
        a, b, c = (task.compute_train_loss(batch, tmodel, True, torch.Generator().manual_seed(s))
                   for s in (1, 1, 2))
    assert float(a) == float(b) != float(c)


def test_mlp_capture_and_covariance_match_jax(gqa2):
    """Per-sample gradients of the MLP projections (gate and up read the same
    input, down their product) and the covariance factors, both packages."""
    module, params, jconfig, tmodel = gqa2
    jtask, ttask = LlamaMLPOnlyTask(jconfig.num_layers), OpenWebTextTask(jconfig.num_layers)
    jmodel, pmodel = jax_prepare(module, jtask), prepare_model(tmodel, ttask)
    data = _data(4, jconfig.max_seq_len, jconfig.vocab_size, seed=7)
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    _, jcaps = jax_capture(
        jax_forward(jmodel, jtask, params, jbatch, sample=False, rng=jax.random.PRNGKey(0)),
        jmodel.tracked_names,
    )
    _, tcaps = capture(pmodel, train_loss_forward(pmodel, ttask, _torch(data), False, None))
    assert list(tcaps) == list(jcaps) == llama.mlp_tracked_modules(2)
    for name in jcaps:
        want = np.asarray(jax_psg(jcaps[name], None, jnp.float64))
        got = module_per_sample_gradients(tcaps[name], None, torch.float64).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)

    args = dict(use_empirical_fisher=True)
    from kronfluence_tpu.arguments import FactorArguments as JaxFactorArguments
    from kronfluence_tpu_torch.arguments import FactorArguments

    dtypes = dict(activation_covariance_dtype="float64", gradient_covariance_dtype="float64")
    want = jax_fit_covariance(
        jmodel, params, jtask, JaxBatchLoader(data, 2), JaxFactorArguments(**args, **dtypes)
    )
    got = fit_covariance_matrices_with_loader(
        pmodel, ttask, BatchLoader(_torch(data), 2, device="cpu"), FactorArguments(**args, **dtypes)
    )
    for factor_name in COVARIANCE_FACTOR_NAMES:
        for name, w in want[factor_name].items():
            np.testing.assert_allclose(
                got[factor_name][name].numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                err_msg=f"{factor_name} {name}",
            )


def _fp64(args, fields):
    for field in fields:
        setattr(args, field, "float64")
    args.amp_dtype = None
    return args


@pytest.fixture(scope="module")
def extreme_runs(tmp_path_factory, gqa2):
    """Both packages' Analyzers with the openwebtext recipe in fp64: module
    partitions 2 and data partitions 2 in covariance and lambda, iterative
    lambda, remat, module partitions 4 in scores; the tasks keep fp64 logits
    (with the tasks' fp32 logits the scores agree to 4.4e-6 relative, the
    fp32 losses' rounding through the 1e-8 damping)."""
    module, params, jconfig, tmodel = gqa2
    train = _data(NUM_TRAIN, jconfig.max_seq_len, jconfig.vocab_size, seed=0)
    query = _data(NUM_QUERY, jconfig.max_seq_len, jconfig.vocab_size, seed=1)
    factor_fields = ("activation_covariance_dtype", "gradient_covariance_dtype",
                     "per_sample_gradient_dtype", "lambda_dtype", "eigendecomposition_dtype")
    score_fields = ("score_dtype", "per_sample_gradient_dtype", "precondition_dtype",
                    "query_gradient_svd_dtype")
    runs = {}
    for side, factor_args, score_args in (
        ("jax", jax_extreme_factor_args("ekfac", module_partitions=2),
         jax_extreme_score_args()),
        ("port", extreme_reduce_memory_factor_arguments("ekfac", module_partitions=2),
         extreme_reduce_memory_score_arguments()),
    ):
        factor_args = _fp64(factor_args, factor_fields)
        factor_args.use_empirical_fisher = True
        factor_args.covariance_data_partitions = factor_args.lambda_data_partitions = 2
        assert factor_args.use_iterative_lambda_aggregation
        assert factor_args.offload_activations_to_cpu
        score_args = _fp64(score_args, score_fields)
        out = tmp_path_factory.mktemp(side)
        if side == "jax":
            task = Fp64LlamaMLPOnlyTask(2)
            analyzer = JaxAnalyzer("llama", jax_prepare(module, task), task, params=params,
                                   cpu=True, output_dir=str(out))
        else:
            task = OpenWebTextTask(2, logits_dtype=torch.float64)
            analyzer = Analyzer("llama", prepare_model(tmodel, task), task, cpu=True,
                                output_dir=str(out))
        analyzer.fit_all_factors("ekfac", train, per_device_batch_size=BATCH,
                                 factor_args=factor_args)
        analyzer.compute_pairwise_scores(
            "pairwise", "ekfac", query, train, per_device_query_batch_size=2,
            per_device_train_batch_size=BATCH, score_args=score_args,
        )
        runs[side] = analyzer
    return runs


def _as_numpy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("what", ["covariance", "lambda"])
def test_extreme_recipe_factors_match_jax(extreme_runs, what):
    load, names = {
        "covariance": ("load_covariance_matrices", COVARIANCE_FACTOR_NAMES),
        "lambda": ("load_lambda_matrices", LAMBDA_FACTOR_NAMES),
    }[what]
    want = getattr(extreme_runs["jax"], load)("ekfac")
    got = getattr(extreme_runs["port"], load)("ekfac")
    for factor_name in names:
        assert set(got[factor_name]) == set(want[factor_name]) == set(llama.mlp_tracked_modules(2))
        for name, w in want[factor_name].items():
            np.testing.assert_allclose(_as_numpy(got[factor_name][name]), _as_numpy(w),
                                       rtol=RTOL, atol=ATOL, err_msg=f"{factor_name} {name}")


def test_extreme_recipe_scores_match_jax(extreme_runs):
    want = _as_numpy(extreme_runs["jax"].load_pairwise_scores("pairwise")[ALL_MODULE_NAME])
    got = _as_numpy(extreme_runs["port"].load_pairwise_scores("pairwise")[ALL_MODULE_NAME])
    assert got.shape == (NUM_QUERY, NUM_TRAIN)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_converter_rejects_a_mismatched_tree(gqa2):
    _, params, _, tmodel = gqa2
    host = jax.tree_util.tree_map(np.asarray, params)
    config = tmodel.config
    with pytest.raises(ValueError, match="missing"):
        state_dict_from_flax(host, dataclasses.replace(config, num_layers=3))
    with pytest.raises(ValueError, match="shape"):
        state_dict_from_flax(host, dataclasses.replace(config, d_mlp=64))
    extra = dict(host, extra_head={"kernel": np.zeros((2, 2))})
    with pytest.raises(ValueError, match="extra"):
        state_dict_from_flax(extra, config)


def test_names_are_flax_paths(gqa2):
    _, params, _, tmodel = gqa2
    names = set(prepare_model(tmodel).tracked_modules())
    flax_dense = {
        "/".join(str(k.key) for k in path[:-1])
        for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]
        if str(path[-1].key) == "kernel"
    }
    assert names == flax_dense and "layers_0/mlp/gate_proj" in names
    assert all(m.bias is None for m in tmodel.modules() if isinstance(m, torch.nn.Linear))


def test_llama3_8b_shapes_and_seeded_init():
    model = llama.LlamaLM(llama.llama3_8b_config(num_layers=2, max_seq_len=512), device="meta")
    assert model.config.head_dim == 128
    assert model.embed.weight.shape == (128256, 4096)
    assert model.layers_1.attn.k_proj.weight.shape == (1024, 4096)
    assert model.layers_1.mlp.down_proj.weight.shape == (4096, 14336)
    assert model.lm_head.weight.shape == (128256, 4096)
    assert sum(p.numel() for p in model.parameters()) == 1_486_901_248
    config = llama.tiny_llama_config()
    a = llama.init_llama(config, seed=0, device="cpu").state_dict()
    b = llama.init_llama(config, seed=0, device="cpu").state_dict()
    c = llama.init_llama(config, seed=1, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers_0.mlp.up_proj.weight"], c["layers_0.mlp.up_proj.weight"])
    with pytest.raises(ValueError, match="attention"):
        llama.tiny_llama_config(attention="sdpa")
