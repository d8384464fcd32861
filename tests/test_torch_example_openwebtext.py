"""The port's openwebtext example (`kronfluence_tpu_torch/examples/openwebtext/`)
against the JAX package's `examples/openwebtext/`: the tasks' loss, sampled
loss and measurement on flax weights carried over by `models/convert.py`, in
fp64 at the parity harness's tolerances (both cast the logits to fp32), and
each script's `main()` at tiny widths on the CPU."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from threadpoolctl import threadpool_limits

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from examples.openwebtext.generate import CompletionTask as JaxCompletionTask  # noqa: E402
from examples.openwebtext.task import LlamaMLPOnlyTask as JaxLlamaTask  # noqa: E402
from examples.openwebtext.task import MLPOnlyLMTask as JaxMLPOnlyTask  # noqa: E402
from kronfluence_tpu.models import llama as jax_llama  # noqa: E402
from kronfluence_tpu.models.transformer import TransformerLM  # noqa: E402
from kronfluence_tpu_torch.examples.common import sample_labels  # noqa: E402
from kronfluence_tpu_torch.examples.openwebtext import (  # noqa: E402
    compute_scores,
    fit_factors,
    generate,
)
from kronfluence_tpu_torch.examples.openwebtext.task import (  # noqa: E402
    LlamaMLPOnlyTask,
    MLPOnlyLMTask,
)
from kronfluence_tpu_torch.models import llama  # noqa: E402
from kronfluence_tpu_torch.models.convert import state_dict_from_flax  # noqa: E402
from tests.testable_tasks.language_modeling import make_lm, make_lm_data  # noqa: E402
from tests.testable_tasks.torch_language_modeling import make_torch_lm  # noqa: E402

# The reference's own equivalence tolerance (tests/test_reference_parity.py:61).
RTOL, ATOL = 1.3e-6, 1e-5
TINY = ["--num_layers", "2", "--d_model", "32", "--num_heads", "2", "--seq_len", "16",
        "--vocab", "128", "--num_train", "16", "--per_device_batch_size", "4", "--cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread and one BLAS thread: these tests run many small ops
    and host eighs beside the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def _jitted(module, params):
    """The flax model as a jitted callable of (input_ids, attention_mask)."""
    apply = jax.jit(lambda p, ids, mask: module.apply({"params": p}, ids, mask))
    return lambda ids, mask: apply(params, ids, mask)


def _gpt2():
    """(flax GPT-2 as a jitted callable, port GPT-2 on the same fp64 weights,
    data, config)."""
    _, params, _, config = make_lm()
    bound = _jitted(TransformerLM(config), params)
    tmodel = make_torch_lm(params, config)[0].module
    data = make_lm_data(4, seq_len=config.max_seq_len, vocab=config.vocab_size, seed=3)
    return bound, tmodel, data, config


def _llama():
    jconfig = jax_llama.tiny_llama_config(dtype=jnp.float64, param_dtype=jnp.float64)
    module = jax_llama.LlamaLM(jconfig)
    params = module.init(jax.random.PRNGKey(1), jnp.zeros((1, jconfig.max_seq_len), jnp.int32))
    params = params["params"]
    tconfig = llama.tiny_llama_config(dtype=torch.float64)
    tmodel = llama.LlamaLM(tconfig)
    tmodel.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                                tconfig))
    rng = np.random.default_rng(4)
    ids = rng.integers(1, jconfig.vocab_size, size=(4, jconfig.max_seq_len)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 20:] = 0
    data = {"input_ids": ids, "attention_mask": mask}
    return _jitted(module, params), tmodel, data, jconfig


def _check_task(jtask, ttask, bound, tmodel, data):
    """Loss and measurement to the parity tolerances; the sampled loss on the
    port's draw against the JAX cross-entropy of the same labels."""
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in data.items()}
    with torch.no_grad():
        for name in ("compute_train_loss", "compute_measurement"):
            want = float(getattr(jtask, name)(jbatch, bound))
            got = float(getattr(ttask, name)(tbatch, tmodel))
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)
        got = float(ttask.compute_train_loss(tbatch, tmodel, True, torch.Generator().manual_seed(7)))
        logits = tmodel(tbatch["input_ids"], tbatch["attention_mask"])[:, :-1].float()
        labels = sample_labels(logits, torch.Generator().manual_seed(7)).numpy()
        jlogits = bound(jbatch["input_ids"], jbatch["attention_mask"])[:, :-1].astype(jnp.float32)
        losses = optax.softmax_cross_entropy_with_integer_labels(jlogits, jnp.asarray(labels))
        want = float(jnp.sum(losses * jbatch["attention_mask"][:, 1:].astype(jnp.float32)))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg="sampled loss")
        again = float(ttask.compute_train_loss(tbatch, tmodel, True,
                                               torch.Generator().manual_seed(7)))
        assert again == got
    assert ttask.get_influence_tracked_modules() == jtask.get_influence_tracked_modules()


def test_mlp_only_task_matches_jax():
    bound, tmodel, data, config = _gpt2()
    _check_task(JaxMLPOnlyTask(config.num_layers), MLPOnlyLMTask(config.num_layers),
                bound, tmodel, data)


def test_llama_mlp_only_task_matches_jax():
    bound, tmodel, data, config = _llama()
    _check_task(JaxLlamaTask(config.num_layers), LlamaMLPOnlyTask(config.num_layers),
                bound, tmodel, data)


def test_completion_measurement_matches_jax():
    bound, tmodel, data, config = _gpt2()
    jtask = JaxCompletionTask(config.num_layers, prompt_len=5)
    ttask = generate.CompletionTask(config.num_layers, prompt_len=5)
    with torch.no_grad():
        got = float(ttask.compute_measurement({k: torch.from_numpy(v) for k, v in data.items()},
                                              tmodel))
    want = float(jtask.compute_measurement({k: jnp.asarray(v) for k, v in data.items()}, bound))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_greedy_decode_matches_flax():
    bound, tmodel, _, config = _gpt2()
    prompt = np.random.default_rng(0).integers(1, config.vocab_size, size=(2, 6)).astype(np.int32)
    got = generate.greedy_generate(tmodel, prompt, 5)
    tokens = prompt
    for _ in range(5):
        logits = bound(jnp.asarray(tokens), jnp.ones_like(jnp.asarray(tokens)))
        nxt = np.asarray(jnp.argmax(logits[:, -1], axis=-1))[:, None]
        tokens = np.concatenate([tokens, nxt.astype(tokens.dtype)], axis=1)
    np.testing.assert_array_equal(got, tokens)


def test_fit_factors_then_compute_scores(tmp_path):
    """fit_factors' recipe (extreme reduce memory, fp32 "jacobi", module and
    data partitions), then compute_scores' rank-4 query blocks on those
    factors: finite scores of the expected shape."""
    out = ["--output_dir", str(tmp_path)]
    analyzer = fit_factors.main(TINY + ["--module_partitions", "2", "--data_partitions", "2"]
                                + out)
    args = analyzer.load_factor_args("ekfac")
    assert args.eigendecomposition_solver == "jacobi"
    assert args.covariance_module_partitions == 2 and args.lambda_data_partitions == 2
    scores = compute_scores.main(TINY + ["--num_query", "4", "--query_gradient_low_rank", "4"]
                                 + out)
    assert tuple(scores.shape) == (4, 16) and bool(torch.isfinite(scores).all())


def test_one_llama_layer_fits_and_scores(tmp_path):
    """One Llama layer tracks 3 modules, fewer than the score recipe's 4
    module partitions: the JAX example fails there (a partition with no
    tracked module); the port's scores every module once."""
    llama_args = ["--arch", "llama", "--num_layers", "1", "--d_model", "32", "--num_heads", "4",
                  "--num_kv_heads", "2", "--d_mlp", "48", "--seq_len", "16", "--vocab", "64",
                  "--num_train", "8", "--per_device_batch_size", "4", "--cpu",
                  "--output_dir", str(tmp_path)]
    analyzer = fit_factors.main(llama_args + ["--module_partitions", "1", "--data_partitions", "1"])
    eigen = analyzer.load_eigendecomposition("ekfac")
    assert sorted(next(iter(eigen.values()))) == sorted(llama.mlp_tracked_modules(1))
    scores = compute_scores.main(llama_args + ["--num_query", "2", "--query_gradient_low_rank", "4"])
    assert tuple(scores.shape) == (2, 8) and bool(torch.isfinite(scores).all())
    args = analyzer.load_score_args("prompt_scores")
    assert args.module_partitions == 3


def test_generate_attributes_the_completion(tmp_path):
    completion, scores = generate.main(
        ["--num_layers", "1", "--d_model", "32", "--num_heads", "2", "--vocab", "64",
         "--prompt_len", "8", "--gen_len", "4", "--num_train", "16",
         "--per_device_batch_size", "8", "--cpu", "--output_dir", str(tmp_path)])
    assert completion.shape == (1, 12) and scores.shape == (16,)
    assert np.isfinite(scores).all()


def test_model_parallel_raises_through_make_mesh(tmp_path):
    with pytest.raises(NotImplementedError, match="model axis"):
        fit_factors.main(TINY + ["--model_parallel", "2", "--output_dir", str(tmp_path)])


def test_scores_need_the_factors(tmp_path):
    with pytest.raises(SystemExit, match="fit_factors"):
        compute_scores.main(TINY + ["--output_dir", str(tmp_path)])


def test_llama_task_is_the_copy_it_replaced_bit_for_bit():
    """chip_smoke.py's phases 15 and 16 take their task from this example in
    place of a copy of their own (the code of tests/test_torch_llama.py's
    OpenWebTextTask): loss, sampled loss from one generator seed and
    measurement equal bit for bit on an fp32 and a bf16 model."""
    from tests.test_torch_llama import OpenWebTextTask

    for dtype in (torch.float32, torch.bfloat16):
        config = llama.tiny_llama_config(dtype=dtype)
        model = llama.init_llama(config, seed=0, device="cpu")
        rng = np.random.default_rng(8)
        ids = rng.integers(1, config.vocab_size, size=(3, config.max_seq_len)).astype(np.int32)
        mask = np.ones_like(ids)
        mask[2, 10:] = 0
        batch = {"input_ids": torch.from_numpy(ids), "attention_mask": torch.from_numpy(mask)}
        ours, copy = LlamaMLPOnlyTask(config.num_layers), OpenWebTextTask(config.num_layers)
        with torch.no_grad():
            for sample in (False, True):
                got = ours.compute_train_loss(batch, model, sample, torch.Generator().manual_seed(4))
                want = copy.compute_train_loss(batch, model, sample,
                                               torch.Generator().manual_seed(4))
                assert torch.equal(got, want), (dtype, sample)
            assert torch.equal(ours.compute_measurement(batch, model),
                               copy.compute_measurement(batch, model))
        assert ours.get_influence_tracked_modules() == copy.get_influence_tracked_modules()
