"""The port's glue example (`kronfluence_tpu_torch/examples/glue/`) against the
JAX package's `examples/glue/`: the task's loss, sampled loss and margin
measurement on flax weights carried over by `models/convert.py`, in fp64 at
the parity harness's tolerances (rtol 1.3e-6, atol 1e-5,
tests/test_reference_parity.py:61); the synthetic data, bit for bit; one
AdamW step of the examples' training loop against the JAX loop's; one EK-FAC
fit (covariances, eigenpairs, lambda) and its pairwise and self scores
against the JAX stages on padded sequences and a padded last batch; and each
script's `main()` on the CPU at the JAX smoke test's arguments
(tests/test_examples.py), which fix the model at d 128 (2 layers)."""

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

from examples.common import train_model as jax_train_model  # noqa: E402
from examples.glue import pipeline as jax_pipeline  # noqa: E402
from kronfluence_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402
from kronfluence_tpu.prepare import prepare_model as jax_prepare  # noqa: E402
from kronfluence_tpu_torch.examples.common import sample_labels, train_model  # noqa: E402
from kronfluence_tpu_torch.examples.glue import (  # noqa: E402
    analyze,
    evaluate_lds,
    half_precision_analysis,
    pipeline,
    run_counterfactual,
    train,
)
from kronfluence_tpu_torch.models.convert import state_dict_from_flax  # noqa: E402
from kronfluence_tpu_torch.models.transformer import TransformerConfig  # noqa: E402
from kronfluence_tpu_torch.prepare import prepare_model  # noqa: E402
from kronfluence_tpu_torch.utils.constants import (  # noqa: E402
    ACTIVATION_COVARIANCE_MATRIX_NAME,
    NUM_ACTIVATION_COVARIANCE_PROCESSED,
)
from kronfluence_tpu_torch.utils.save import load_file  # noqa: E402
from tests.testable_tasks.parity import (  # noqa: E402
    assert_factors_match,
    assert_scores_match,
    jax_stages,
    torch_stages,
)

RTOL, ATOL = 1.3e-6, 1e-5
TINY = dict(vocab_size=64, max_seq_len=16, num_layers=1, num_heads=2, d_model=32)
NUM_TRAIN, BATCH, NUM_QUERY, QUERY_BATCH = 10, 4, 4, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread and one BLAS thread: these tests run many small ops
    and host eighs beside the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def models(seed=0):
    """The JAX pipeline's EncoderClassifier at TINY widths with its init
    weights in fp64, and the port's holding them."""
    flax_module = jax_pipeline.EncoderClassifier(
        JaxConfig(**TINY, dtype=jnp.float64, param_dtype=jnp.float64))
    t = TINY["max_seq_len"]
    params = flax_module.init(jax.random.PRNGKey(seed), jnp.zeros((1, t), jnp.int32),
                              jnp.ones((1, t), jnp.int32))["params"]
    params = jax.tree_util.tree_map(lambda p: np.asarray(p, np.float64), jax.device_get(params))
    module = pipeline.EncoderClassifier(TransformerConfig(**TINY, dtype=torch.float64),
                                        device="cpu")
    module.load_state_dict(state_dict_from_flax(params, module))
    return flax_module, params, module


def data(num, seed):
    return pipeline.synthetic_sst2(num, seq_len=TINY["max_seq_len"], vocab=TINY["vocab_size"],
                                   seed=seed)


def test_task_matches_jax():
    """Loss and margin measurement to the parity tolerances, the sampled loss
    on the port's draw against JAX's cross-entropy of the same labels, the
    same tracked modules (every one) and the mask."""
    flax_module, params, module = models()
    batch = data(6, seed=5)

    def bound(ids, mask):
        return flax_module.apply({"params": params}, ids, mask)

    jtask, ttask = jax_pipeline.TextClassificationTask(), pipeline.TextClassificationTask()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        np.testing.assert_allclose(module(tbatch["input_ids"], tbatch["attention_mask"]).numpy(),
                                   np.asarray(bound(jbatch["input_ids"], jbatch["attention_mask"])),
                                   rtol=RTOL, atol=ATOL, err_msg="logits")
        for name in ("compute_train_loss", "compute_measurement"):
            want = float(getattr(jtask, name)(jbatch, bound))
            got = float(getattr(ttask, name)(tbatch, module))
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)
        got = float(ttask.compute_train_loss(tbatch, module, True,
                                             torch.Generator().manual_seed(3)))
        labels = sample_labels(module(tbatch["input_ids"], tbatch["attention_mask"]),
                               torch.Generator().manual_seed(3)).numpy()
    want = float(jnp.sum(optax.softmax_cross_entropy_with_integer_labels(
        bound(jbatch["input_ids"], jbatch["attention_mask"]), jnp.asarray(labels))))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg="sampled loss")
    assert ttask.get_influence_tracked_modules() is jtask.get_influence_tracked_modules() is None
    assert ttask.get_attention_mask(tbatch) is tbatch["attention_mask"]


@pytest.mark.parametrize("num,seq_len,vocab,seed", [(7, 16, 64, 2), (5, 64, 4096, 0),
                                                    (9, 8, 30, 1)])
def test_synthetic_data_matches_jax(num, seq_len, vocab, seed):
    """Bit for bit, and every row keeps at least 8 tokens (the mean pool's
    divisor)."""
    got = pipeline.get_sst2_dataset("train", num, seq_len=seq_len, vocab=vocab, seed=seed)
    want = jax_pipeline.get_sst2_dataset("eval", num, seq_len=seq_len, vocab=vocab, seed=seed)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], want[key])
    assert got["attention_mask"].sum(axis=1).min() >= 8


def test_train_step_matches_jax():
    """One AdamW step of the examples' loop on the mean cross-entropy (one
    epoch of one batch), from the same fp64 weights: every parameter."""
    flax_module, params, module = models(seed=1)
    batch = data(4, seed=3)
    jtask, ttask = jax_pipeline.TextClassificationTask(), pipeline.TextClassificationTask()

    def jax_loss(p, b, key):
        return jtask.compute_train_loss(
            b, lambda *a: flax_module.apply({"params": p}, *a)) / len(b["label"])

    want = jax_train_model(jax_loss, jax.tree_util.tree_map(jnp.asarray, params), batch,
                           batch_size=4, num_epochs=1, learning_rate=3e-4, seed=0)
    train_model(lambda m, b, g: ttask.compute_train_loss(b, m) / len(b["label"]), module, batch,
                batch_size=4, num_epochs=1, learning_rate=3e-4, seed=0)
    expected = state_dict_from_flax(jax.device_get(want), module)
    for key, tensor in module.state_dict().items():
        np.testing.assert_allclose(tensor.numpy(), expected[key].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=key)


@pytest.fixture(scope="module")
def fit():
    """Both packages' stages on the same fp64 classifier and padded data:
    10 train examples in batches of 4 (the last padded), 4 queries."""
    flax_module, params, module = models()
    train_data, query_data = data(NUM_TRAIN, seed=0), data(NUM_QUERY, seed=1)
    jtask, task = jax_pipeline.TextClassificationTask(), pipeline.TextClassificationTask()
    want = jax_stages(jax_prepare(flax_module, jtask), params, jtask, train_data, query_data,
                      BATCH, QUERY_BATCH)
    got = torch_stages(prepare_model(module, task), task, train_data, query_data, BATCH,
                       QUERY_BATCH)
    return dict(want=want, got=got, train=train_data)


def test_factors_match(fit):
    names = sorted(fit["want"][0][ACTIVATION_COVARIANCE_MATRIX_NAME])
    assert names == ["classifier", "h_0/attn/c_attn", "h_0/attn/c_proj", "h_0/mlp/c_fc",
                     "h_0/mlp/c_proj"]
    assert_factors_match(fit["got"][0], fit["want"][0], names)
    # The block's modules count the kept tokens; the classifier one row an example.
    counts = {n: int(c.reshape(-1)[0]) for n, c in
              fit["got"][0][NUM_ACTIVATION_COVARIANCE_PROCESSED].items()}
    assert counts["h_0/mlp/c_fc"] == int(fit["train"]["attention_mask"].sum())
    assert counts["classifier"] == NUM_TRAIN


@pytest.mark.parametrize("kind", ["pairwise", "self"])
def test_scores_match(fit, kind):
    index, shape = (1, (NUM_QUERY, NUM_TRAIN)) if kind == "pairwise" else (2, (NUM_TRAIN,))
    assert_scores_match(fit["got"][index], fit["want"][index], shape)


SMOKE = ["--num_train", "24", "--num_query", "4", "--batch_size", "8", "--cpu"]


def test_train_writes_the_checkpoint(tmp_path):
    module, acc = train.main(["--num_train", "24", "--epochs", "1", "--batch_size", "8",
                              "--cpu", "--checkpoint_dir", str(tmp_path)])
    saved = load_file(tmp_path / "model.safetensors")
    assert saved.keys() == module.state_dict().keys()
    assert all(torch.equal(saved[k], v) for k, v in module.state_dict().items())
    assert 0.0 <= acc <= 1.0


def test_analyze(tmp_path):
    analyzer, scores = analyze.main(SMOKE + ["--output_dir", str(tmp_path)])
    assert tuple(scores.shape) == (4, 24) and bool(torch.isfinite(scores).all())
    assert (tmp_path / "glue" / "factors_ekfac").is_dir()
    assert analyzer.profiler.summary()


def test_half_precision_analysis(tmp_path):
    results = half_precision_analysis.main(SMOKE + ["--output_dir", str(tmp_path)])
    assert set(results) == {"pearson", "spearman"}
    assert results["pearson"] > 0.5 and results["spearman"] > 0.5
    assert sorted(p.name for p in (tmp_path / "glue_half").iterdir()) == [
        "factors_bf16", "factors_fp32", "scores_bf16", "scores_fp32"]


def test_run_counterfactual(tmp_path):
    results = run_counterfactual.main(SMOKE + ["--remove", "4", "--epochs", "1", "--seeds", "1",
                                               "--output_dir", str(tmp_path)])
    assert set(results) == {"full", "random", "top-influence"}
    assert all(np.isfinite(v) for v in results.values())


def test_evaluate_lds(tmp_path):
    results = evaluate_lds.main(["--num_train", "24", "--num_query", "4", "--num_subsets", "3",
                                 "--epochs", "1", "--batch_size", "8", "--strategies",
                                 "identity", "ekfac", "--cpu", "--output_dir", str(tmp_path)])
    assert set(results) == {"identity", "ekfac"}
    assert all(-1.0 <= v <= 1.0 for v in results.values())
