"""The port's wikitext example (`kronfluence_tpu_torch/examples/wikitext/`)
against the JAX package's `examples/wikitext/`: the task's loss, sampled loss
and measurement and its tracked modules on flax weights carried over by
`models/convert.py`, in fp64 at the parity harness's tolerances (both cast the
logits to fp32), the synthetic data, and each script's `main()` at tiny
widths on the CPU."""

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

from examples.wikitext.pipeline import LanguageModelingTask as JaxTask  # noqa: E402
from examples.wikitext.pipeline import get_wikitext_dataset as jax_dataset  # noqa: E402
from kronfluence_tpu.models.transformer import TransformerLM  # noqa: E402
from kronfluence_tpu_torch.examples.common import sample_labels  # noqa: E402
from kronfluence_tpu_torch.examples.wikitext import (  # noqa: E402
    analyze,
    evaluate_lds,
    half_precision_analysis,
    inspect_factors,
    run_counterfactual,
    tokenwise_analysis,
    train,
)
from kronfluence_tpu_torch.examples.wikitext.pipeline import (  # noqa: E402
    LanguageModelingTask,
    get_wikitext_dataset,
)
from tests.testable_tasks.language_modeling import make_lm, make_lm_data  # noqa: E402
from tests.testable_tasks.torch_language_modeling import make_torch_lm  # noqa: E402

RTOL, ATOL = 1.3e-6, 1e-5
TINY = ["--num_layers", "1", "--d_model", "32", "--num_heads", "2", "--seq_len", "16",
        "--vocab", "64", "--cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread and one BLAS thread: these tests run many small ops
    and host eighs beside the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("track", ["all", "mlp"])
def test_task_matches_jax(track):
    """Loss and measurement to the parity tolerances, the sampled loss on the
    port's draw against the JAX cross-entropy of the same labels, the same
    tracked modules."""
    _, params, _, config = make_lm()
    apply = jax.jit(lambda p, ids, mask: TransformerLM(config).apply({"params": p}, ids, mask))

    def bound(ids, mask):
        return apply(params, ids, mask)

    tmodel = make_torch_lm(params, config)[0].module
    data = make_lm_data(4, seq_len=config.max_seq_len, vocab=config.vocab_size, seed=5)
    jtask, ttask = JaxTask(config.num_layers, track), LanguageModelingTask(config.num_layers, track)
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in data.items()}
    with torch.no_grad():
        for name in ("compute_train_loss", "compute_measurement"):
            want = float(getattr(jtask, name)(jbatch, bound))
            got = float(getattr(ttask, name)(tbatch, tmodel))
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)
        got = float(ttask.compute_train_loss(tbatch, tmodel, True, torch.Generator().manual_seed(3)))
        logits = tmodel(tbatch["input_ids"], tbatch["attention_mask"])[:, :-1].float()
        labels = sample_labels(logits, torch.Generator().manual_seed(3)).numpy()
    jlogits = bound(jbatch["input_ids"], jbatch["attention_mask"])[:, :-1].astype(jnp.float32)
    losses = optax.softmax_cross_entropy_with_integer_labels(jlogits, jnp.asarray(labels))
    want = float(jnp.sum(losses * jbatch["attention_mask"][:, 1:].astype(jnp.float32)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg="sampled loss")
    assert ttask.get_influence_tracked_modules() == jtask.get_influence_tracked_modules()


@pytest.mark.parametrize("split", ["train", "validation"])
def test_synthetic_data_matches_jax(split):
    got = get_wikitext_dataset(split, 5, seq_len=16, vocab=64, seed=2)
    want = jax_dataset(split, 5, seq_len=16, vocab=64, seed=2)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_train_then_analyze_then_inspect(tmp_path):
    """train writes a checkpoint the model loads back; analyze fits and
    scores; inspect_factors reads analyze's factors."""
    model, train_loss, eval_loss = train.main(
        TINY + ["--num_train", "24", "--num_eval", "8", "--epochs", "1", "--batch_size", "8",
                "--checkpoint_dir", str(tmp_path / "ckpt")])
    assert np.isfinite(train_loss) and np.isfinite(eval_loss)
    from kronfluence_tpu_torch.utils.save import load_file

    saved = load_file(tmp_path / "ckpt" / "model.safetensors")
    assert all(torch.equal(saved[k], v) for k, v in model.state_dict().items())
    analyzer, scores = analyze.main(
        TINY + ["--num_train", "16", "--num_query", "4", "--train_batch_size", "8",
                "--output_dir", str(tmp_path)])
    assert tuple(scores.shape) == (4, 16) and bool(torch.isfinite(scores).all())
    rows = inspect_factors.main(["--factors_dir", str(tmp_path / "wikitext" / "factors_ekfac"),
                                 "--dump_spectra", str(tmp_path / "spectra")])
    assert sorted(rows) == sorted(LanguageModelingTask(1).get_influence_tracked_modules())
    assert len(list((tmp_path / "spectra").glob("*.npy"))) == 2 * len(rows)


def test_analyze_low_precision_per_token(tmp_path):
    _, scores = analyze.main(
        TINY + ["--num_train", "16", "--num_query", "2", "--train_batch_size", "8",
                "--low_precision", "--per_token", "--output_dir", str(tmp_path)])
    assert tuple(scores.shape) == (2, 16, 16)


def test_half_precision_analysis(tmp_path):
    results = half_precision_analysis.main(
        TINY + ["--num_train", "16", "--num_query", "4", "--train_batch_size", "8",
                "--fp8_storage", "--output_dir", str(tmp_path)])
    assert set(results) == {"bf16", "bf16+fp8qs"}
    assert results["bf16"][0] > 0.5


def test_tokenwise_scores_sum_to_the_sequence_scores(tmp_path):
    seq, tok, delta = tokenwise_analysis.main(
        TINY + ["--num_train", "16", "--num_query", "2", "--train_batch_size", "8",
                "--output_dir", str(tmp_path)])
    assert tok.shape == seq.shape + (16,)
    assert delta < 1e-4


def test_evaluate_lds(tmp_path):
    results = evaluate_lds.main(
        TINY + ["--num_train", "24", "--num_query", "4", "--num_subsets", "3", "--epochs", "1",
                "--batch_size", "8", "--strategies", "identity", "ekfac",
                "--output_dir", str(tmp_path)])
    assert set(results) == {"identity", "ekfac"}
    assert all(-1.0 <= v <= 1.0 for v in results.values())


def test_run_counterfactual(tmp_path):
    results = run_counterfactual.main(
        TINY + ["--num_train", "24", "--num_query", "4", "--remove", "4", "--epochs", "1",
                "--seeds", "1", "--batch_size", "8", "--output_dir", str(tmp_path)])
    assert set(results) == {"full dataset", "remove most-positive", "remove random"}
    assert all(np.isfinite(m) for m, _ in results.values())
