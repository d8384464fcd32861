"""The port's dailymail example (`kronfluence_tpu_torch/examples/dailymail/`)
against the JAX package's `examples/dailymail/`: the summarization task's
loss, sampled loss and measurement on flax EncDecLM weights carried over by
`models/convert.py`, in fp64 at the parity harness's tolerances (rtol
1.3e-6, atol 1e-5, tests/test_reference_parity.py:61; both cast the logits
to fp32); the dict
attention masks, key for key the JAX task's and one for every tracked
module; the synthetic pairs, bit for bit; one AdamW step; one EK-FAC fit and
its pairwise and self scores against the JAX stages on pairs padded on both
sides (the pairwise scores within 1e-5 of max|score|, see
test_pairwise_scores_match), with each module's token counts from its own
mask; and the scripts' `main()` on the CPU at the JAX smoke test's arguments
(tests/test_examples.py), `inspect_examples` reading `analyze`'s scores."""

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
from examples.dailymail import pipeline as jax_pipeline  # noqa: E402
from kronfluence_tpu.models.encoder_decoder import EncDecConfig as JaxConfig  # noqa: E402
from kronfluence_tpu.models.encoder_decoder import EncDecLM as JaxEncDecLM  # noqa: E402
from kronfluence_tpu.prepare import prepare_model as jax_prepare  # noqa: E402
from kronfluence_tpu_torch.examples.common import sample_labels, train_model  # noqa: E402
from kronfluence_tpu_torch.examples.dailymail import (  # noqa: E402
    analyze,
    inspect_examples,
    pipeline,
    train,
)
from kronfluence_tpu_torch.models.convert import state_dict_from_flax  # noqa: E402
from kronfluence_tpu_torch.models.encoder_decoder import EncDecConfig, EncDecLM  # noqa: E402
from kronfluence_tpu_torch.prepare import prepare_model  # noqa: E402
from kronfluence_tpu_torch.utils.constants import (  # noqa: E402
    ACTIVATION_COVARIANCE_MATRIX_NAME,
    NUM_ACTIVATION_COVARIANCE_PROCESSED,
    NUM_GRADIENT_COVARIANCE_PROCESSED,
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
NUM_TRAIN, BATCH, NUM_QUERY, QUERY_BATCH = 6, 4, 4, 2
SCORES_OF_MAX = 1e-5


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
    """The JAX EncDecLM at TINY widths with its init weights in fp64, and the
    port's holding them."""
    flax_module = JaxEncDecLM(JaxConfig(**TINY, dtype=jnp.float64, param_dtype=jnp.float64))
    ids = jnp.zeros((1, TINY["max_seq_len"]), jnp.int32)
    params = flax_module.init(jax.random.PRNGKey(seed), ids, ids)["params"]
    params = jax.tree_util.tree_map(lambda p: np.asarray(p, np.float64), jax.device_get(params))
    module = EncDecLM(EncDecConfig(**TINY, dtype=torch.float64), device="cpu")
    module.load_state_dict(state_dict_from_flax(params, module))
    return flax_module, params, module


def data(num, seed):
    return pipeline.synthetic_pairs(num, seq_len=TINY["max_seq_len"], vocab=TINY["vocab_size"],
                                    seed=seed)


def test_task_matches_jax():
    """Loss and measurement to the parity tolerances, and the sampled loss on
    the port's draw against JAX's cross-entropy of the same labels."""
    flax_module, params, module = models()
    batch = data(3, seed=5)

    def bound(*args):
        return flax_module.apply({"params": params}, *args)

    jtask = jax_pipeline.SummarizationTask(TINY["num_layers"])
    ttask = pipeline.SummarizationTask(TINY["num_layers"])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        for name in ("compute_train_loss", "compute_measurement"):
            want = float(getattr(jtask, name)(jbatch, bound))
            got = float(getattr(ttask, name)(tbatch, module))
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)
        got = float(ttask.compute_train_loss(tbatch, module, True,
                                             torch.Generator().manual_seed(3)))
        logits = module(tbatch["input_ids"], tbatch["decoder_input_ids"],
                        tbatch["attention_mask"], tbatch["decoder_attention_mask"])
        labels = sample_labels(logits[:, :-1].float(), torch.Generator().manual_seed(3)).numpy()
    jlogits = bound(jbatch["input_ids"], jbatch["decoder_input_ids"], jbatch["attention_mask"],
                    jbatch["decoder_attention_mask"])[:, :-1].astype(jnp.float32)
    losses = optax.softmax_cross_entropy_with_integer_labels(jlogits, jnp.asarray(labels))
    want = float(jnp.sum(losses * jbatch["decoder_attention_mask"][:, 1:].astype(jnp.float32)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg="sampled loss")


def test_every_tracked_module_gets_its_mask():
    """The dict masks' keys are the tracked modules' names, none missing and
    none left over, and the JAX task's keys, each mask the same stream."""
    num_layers = 2
    module = EncDecLM(EncDecConfig(**dict(TINY, num_layers=num_layers)), device="cpu")
    task = pipeline.SummarizationTask(num_layers)
    batch = {k: torch.from_numpy(v) for k, v in data(2, seed=1).items()}
    masks = task.get_attention_mask(batch)
    tracked = prepare_model(module, task).tracked_modules()
    assert sorted(masks) == sorted(tracked)
    assert len(tracked) == num_layers * (6 + 10) + 1
    streams = {"attention_mask": batch["attention_mask"],
               "decoder_attention_mask": batch["decoder_attention_mask"]}
    want = jax_pipeline.SummarizationTask(num_layers).get_attention_mask(streams)
    assert masks.keys() == want.keys()
    for name, mask in masks.items():
        assert mask is want[name], name
    assert masks["lm_head"] is batch["decoder_attention_mask"]
    assert masks["decoder_1/cross_attn/k"] is batch["attention_mask"]
    assert masks["decoder_0/cross_attn/q"] is batch["decoder_attention_mask"]
    assert masks["encoder_1/mlp/wo"] is batch["attention_mask"]


@pytest.mark.parametrize("num,seq_len,vocab,seed", [(5, 16, 64, 2), (3, 32, 1024, 0)])
def test_synthetic_data_matches_jax(num, seq_len, vocab, seed):
    got = pipeline.get_dailymail_dataset("train", num, enc_len=seq_len, vocab=vocab, seed=seed)
    want = jax_pipeline.get_dailymail_dataset("valid", num, enc_len=seq_len, vocab=vocab,
                                              seed=seed)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_train_step_matches_jax():
    """One AdamW step of the examples' loop on the loss a pair (one epoch of
    one batch), from the same fp64 weights: every parameter."""
    flax_module, params, module = models(seed=1)
    batch = data(4, seed=3)
    jtask = jax_pipeline.SummarizationTask(TINY["num_layers"])
    ttask = pipeline.SummarizationTask(TINY["num_layers"])

    def jax_loss(p, b, key):
        return jtask.compute_train_loss(
            b, lambda *a: flax_module.apply({"params": p}, *a)) / len(b["input_ids"])

    want = jax_train_model(jax_loss, jax.tree_util.tree_map(jnp.asarray, params), batch,
                           batch_size=4, num_epochs=1, learning_rate=5e-4, seed=0)
    train_model(lambda m, b, g: ttask.compute_train_loss(b, m) / len(b["input_ids"]), module,
                batch, batch_size=4, num_epochs=1, learning_rate=5e-4, seed=0)
    expected = state_dict_from_flax(jax.device_get(want), module)
    for key, tensor in module.state_dict().items():
        np.testing.assert_allclose(tensor.numpy(), expected[key].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=key)


@pytest.fixture(scope="module")
def fit():
    """Both packages' stages on the same fp64 encoder-decoder and padded
    pairs: 6 train pairs in batches of 4 (the last padded), 4 queries."""
    flax_module, params, module = models()
    train_data, query_data = data(NUM_TRAIN, seed=0), data(NUM_QUERY, seed=1)
    jtask = jax_pipeline.SummarizationTask(TINY["num_layers"])
    task = pipeline.SummarizationTask(TINY["num_layers"])
    want = jax_stages(jax_prepare(flax_module, jtask), params, jtask, train_data, query_data,
                      BATCH, QUERY_BATCH)
    got = torch_stages(prepare_model(module, task), task, train_data, query_data, BATCH,
                       QUERY_BATCH)
    return dict(want=want, got=got, train=train_data)


def test_factors_match(fit):
    names = sorted(fit["want"][0][ACTIVATION_COVARIANCE_MATRIX_NAME])
    assert len(names) == 6 + 10 + 1
    assert_factors_match(fit["got"][0], fit["want"][0], names)


@pytest.mark.parametrize("count", [NUM_ACTIVATION_COVARIANCE_PROCESSED,
                                   NUM_GRADIENT_COVARIANCE_PROCESSED])
def test_token_counts_follow_the_dict_masks(fit, count):
    """Encoder modules and the cross-attention's keys and values count the
    kept article tokens, the rest the kept summary tokens."""
    enc = int(fit["train"]["attention_mask"].sum())
    dec = int(fit["train"]["decoder_attention_mask"].sum())
    assert enc != dec
    for name, got in fit["got"][0][count].items():
        reads_articles = name.startswith("encoder_") or name.endswith(("cross_attn/k",
                                                                       "cross_attn/v"))
        assert int(got.reshape(-1)[0]) == (enc if reads_articles else dec), name


def test_self_scores_match(fit):
    assert_scores_match(fit["got"][2], fit["want"][2], (NUM_TRAIN,))


def test_pairwise_scores_match(fit):
    """Within SCORES_OF_MAX of max|score|: both packages take the loss on
    fp32 logits (the JAX task casts them), so each gradient carries fp32
    rounding, which the pairwise products' cancellation lifts above the
    harness's elementwise rtol at scores far below the largest (1.7e-6 of
    max|score| measured on the CPU)."""
    got, want = fit["got"][1], fit["want"][1]
    assert tuple(got.shape) == (NUM_QUERY, NUM_TRAIN) and got.dtype == torch.float64
    gap = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert gap <= SCORES_OF_MAX, gap


def test_train_analyze_inspect(tmp_path, capsys):
    """train writes a checkpoint, analyze loads it, fits and scores, and
    inspect_examples reads analyze's scores."""
    module, loss = train.main(["--num_train", "16", "--epochs", "1", "--batch_size", "4",
                               "--cpu", "--checkpoint_dir", str(tmp_path / "ckpt")])
    saved = load_file(tmp_path / "ckpt" / "model.safetensors")
    assert all(torch.equal(saved[k], v) for k, v in module.state_dict().items())
    assert np.isfinite(loss)
    analyzer, scores = analyze.main(["--num_train", "16", "--num_query", "4", "--batch_size",
                                     "4", "--cpu", "--checkpoint_dir", str(tmp_path / "ckpt"),
                                     "--output_dir", str(tmp_path)])
    assert f"loaded checkpoint {tmp_path / 'ckpt' / 'model.safetensors'}" in capsys.readouterr().out
    assert tuple(scores.shape) == (4, 16) and bool(torch.isfinite(scores).all())
    top_idx, top_score = inspect_examples.main(["--num_train", "16", "--num_query", "4",
                                                "--eval_idx", "1", "--output_dir", str(tmp_path)])
    assert top_idx == int(torch.argmax(scores[1].float()))
    assert top_score == float(scores[1].float().max())
    assert f"Top Influential Example (train idx {top_idx}" in capsys.readouterr().out
