"""The port's swag example (`kronfluence_tpu_torch/examples/swag/`) against the
JAX package's `examples/swag/`: the choice scorer's logits and the task's
loss, sampled loss and margin measurement on flax weights carried over by
`models/convert.py`, in fp64 at the parity harness's tolerances (rtol 1.3e-6,
atol 1e-5, tests/test_reference_parity.py:61); the per-example sum of each
example's 4 per-sample gradient rows against the JAX task's
`post_process_per_sample_gradient`; the synthetic data, bit for bit; one
AdamW step; one EK-FAC fit and its pairwise and self scores against the JAX
stages (the post-processed per-sample gradients in lambda and both scores);
the low-rank query path; and each script's `main()` on the CPU at the JAX
smoke test's arguments (tests/test_examples.py).

The low-rank query gradients come from a randomized SVD whose sketch is
torch's draw in the port and JAX's in the JAX package, so the two are never
compared draw against draw: at a rank at or above the query gradients' rank
the randomized SVD is exact up to rounding, and both packages' low-rank
scores are held to the JAX dense scores. That needs a preconditioner that
keeps the gradients' rank (the identity; EK-FAC's eigenbasis division does
not) and sequences of 2 tokens (4 choices x 2 tokens: rank 8 a module)."""

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
from examples.swag import pipeline as jax_pipeline  # noqa: E402
from kronfluence_tpu.factor.covariance import (  # noqa: E402
    fit_covariance_matrices_with_loader as jax_fit_covariance,
)
from kronfluence_tpu.factor.eigen import (  # noqa: E402
    fit_lambda_matrices_with_loader as jax_fit_lambda,
    perform_eigendecomposition as jax_eigendecomposition,
)
from kronfluence_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402
from kronfluence_tpu.prepare import prepare_model as jax_prepare  # noqa: E402
from kronfluence_tpu.score.pairwise import (  # noqa: E402
    compute_pairwise_scores_with_loaders as jax_pairwise,
)
from kronfluence_tpu.utils.common.factor_arguments import (  # noqa: E402
    pytest_factor_arguments as jax_factor_args,
)
from kronfluence_tpu.utils.common.score_arguments import (  # noqa: E402
    pytest_score_arguments as jax_score_args,
)
from kronfluence_tpu.utils.dataset import BatchLoader as JaxBatchLoader  # noqa: E402
from kronfluence_tpu_torch.examples.common import sample_labels, train_model  # noqa: E402
from kronfluence_tpu_torch.examples.swag import (  # noqa: E402
    analyze,
    evaluate_lds,
    influence_analysis,
    pipeline,
    train,
)
from kronfluence_tpu_torch.factor.covariance import (  # noqa: E402
    fit_covariance_matrices_with_loader,
)
from kronfluence_tpu_torch.factor.eigen import (  # noqa: E402
    fit_lambda_matrices_with_loader,
    perform_eigendecomposition,
)
from kronfluence_tpu_torch.models.convert import state_dict_from_flax  # noqa: E402
from kronfluence_tpu_torch.models.transformer import TransformerConfig  # noqa: E402
from kronfluence_tpu_torch.prepare import prepare_model  # noqa: E402
from kronfluence_tpu_torch.score.pairwise import (  # noqa: E402
    compute_pairwise_scores_with_loaders,
)
from kronfluence_tpu_torch.utils import memory  # noqa: E402
from kronfluence_tpu_torch.utils.common.factor_arguments import (  # noqa: E402
    pytest_factor_arguments,
)
from kronfluence_tpu_torch.utils.common.score_arguments import (  # noqa: E402
    pytest_score_arguments,
)
from kronfluence_tpu_torch.utils.constants import (  # noqa: E402
    ACTIVATION_COVARIANCE_MATRIX_NAME,
    ALL_MODULE_NAME,
    NUM_ACTIVATION_COVARIANCE_PROCESSED,
)
from kronfluence_tpu_torch.utils.dataset import BatchLoader  # noqa: E402
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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread and one BLAS thread: these tests run many small ops
    and host eighs beside the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def models(seq_len=TINY["max_seq_len"], seed=0):
    """The JAX pipeline's ChoiceScorer at TINY widths with its init weights
    in fp64, and the port's holding them."""
    widths = dict(TINY, max_seq_len=seq_len)
    flax_module = jax_pipeline.ChoiceScorer(
        JaxConfig(**widths, dtype=jnp.float64, param_dtype=jnp.float64))
    ids = jnp.zeros((1, pipeline.NUM_CHOICES, seq_len), jnp.int32)
    params = flax_module.init(jax.random.PRNGKey(seed), ids, jnp.ones_like(ids))["params"]
    params = jax.tree_util.tree_map(lambda p: np.asarray(p, np.float64), jax.device_get(params))
    module = pipeline.ChoiceScorer(TransformerConfig(**widths, dtype=torch.float64), device="cpu")
    module.load_state_dict(state_dict_from_flax(params, module))
    return flax_module, params, module


def data(num, seed, seq_len=TINY["max_seq_len"]):
    return pipeline.synthetic_swag(num, seq_len=seq_len, vocab=TINY["vocab_size"], seed=seed)


def test_task_matches_jax():
    """(b, 4) logits, loss and margin measurement to the parity tolerances,
    the sampled loss on the port's draw against JAX's cross-entropy of the
    same labels, the same tracked modules (every one)."""
    flax_module, params, module = models()
    batch = data(3, seed=5)

    def bound(ids, mask):
        return flax_module.apply({"params": params}, ids, mask)

    jtask, ttask = jax_pipeline.MultipleChoiceTask(), pipeline.MultipleChoiceTask()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits = module(tbatch["input_ids"], tbatch["attention_mask"])
        assert tuple(logits.shape) == (3, pipeline.NUM_CHOICES)
        np.testing.assert_allclose(logits.numpy(),
                                   np.asarray(bound(jbatch["input_ids"], jbatch["attention_mask"])),
                                   rtol=RTOL, atol=ATOL, err_msg="logits")
        for name in ("compute_train_loss", "compute_measurement"):
            want = float(getattr(jtask, name)(jbatch, bound))
            got = float(getattr(ttask, name)(tbatch, module))
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)
        got = float(ttask.compute_train_loss(tbatch, module, True,
                                             torch.Generator().manual_seed(3)))
        labels = sample_labels(logits, torch.Generator().manual_seed(3)).numpy()
    want = float(jnp.sum(optax.softmax_cross_entropy_with_integer_labels(
        bound(jbatch["input_ids"], jbatch["attention_mask"]), jnp.asarray(labels))))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg="sampled loss")
    assert ttask.get_influence_tracked_modules() is jtask.get_influence_tracked_modules() is None
    assert ttask.get_attention_mask(tbatch) is jtask.get_attention_mask(jbatch) is None
    assert ttask.enable_post_process_per_sample_gradient


@pytest.mark.parametrize("shape", [(12, 5, 7), (4, 3, 9), (8, 1, 33)])
def test_post_process_sums_each_examples_rows(shape):
    """Rows (4b, out, in) in example-major order: each example's 4 rows
    summed, against the JAX task's post-processing."""
    rows = np.random.default_rng(sum(shape)).normal(size=shape)
    got = pipeline.MultipleChoiceTask().post_process_per_sample_gradient(
        "h_0/mlp/c_fc", torch.from_numpy(rows))
    want = jax_pipeline.MultipleChoiceTask().post_process_per_sample_gradient(
        "h_0/mlp/c_fc", jnp.asarray(rows))
    assert tuple(got.shape) == (shape[0] // 4,) + shape[1:]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14, atol=0)
    np.testing.assert_allclose(got[-1].numpy(), rows[-4:].sum(axis=0), rtol=1e-14, atol=0)


@pytest.mark.parametrize("num,seq_len,vocab,seed", [(5, 16, 64, 2), (3, 32, 2048, 0)])
def test_synthetic_data_matches_jax(num, seq_len, vocab, seed):
    got = pipeline.get_swag_dataset("train", num, seq_len=seq_len, vocab=vocab, seed=seed)
    want = jax_pipeline.get_swag_dataset("eval", num, seq_len=seq_len, vocab=vocab, seed=seed)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], want[key])
    assert got["input_ids"].shape == (num, pipeline.NUM_CHOICES, seq_len)


def test_train_step_matches_jax():
    """One AdamW step of the examples' loop on the mean cross-entropy (one
    epoch of one batch), from the same fp64 weights: every parameter."""
    flax_module, params, module = models(seed=1)
    batch = data(4, seed=3)
    jtask, ttask = jax_pipeline.MultipleChoiceTask(), pipeline.MultipleChoiceTask()

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


def test_batch_estimate_probes_one_whole_example():
    """The memory model's probe is one example: its 4 choices' sequences, so
    a block module counts 4 T rows an example and the scorer 4."""
    _, _, module = models()
    task = pipeline.MultipleChoiceTask()
    batch, _ = BatchLoader(data(3, seed=0), 1, device="cpu").probe()
    assert tuple(batch["input_ids"].shape) == (1, pipeline.NUM_CHOICES, TINY["max_seq_len"])
    probes = memory.probe_modules(prepare_model(module, task), task, batch, 1)
    assert probes["h_0/mlp/c_fc"].tokens == pipeline.NUM_CHOICES * TINY["max_seq_len"]
    assert probes["scorer"].tokens == pipeline.NUM_CHOICES


@pytest.fixture(scope="module")
def fit():
    """Both packages' stages on the same fp64 choice scorer: 6 train
    examples in batches of 4 (the last padded), 4 queries."""
    flax_module, params, module = models()
    train_data, query_data = data(NUM_TRAIN, seed=0), data(NUM_QUERY, seed=1)
    jtask, task = jax_pipeline.MultipleChoiceTask(), pipeline.MultipleChoiceTask()
    want = jax_stages(jax_prepare(flax_module, jtask), params, jtask, train_data, query_data,
                      BATCH, QUERY_BATCH)
    got = torch_stages(prepare_model(module, task), task, train_data, query_data, BATCH,
                       QUERY_BATCH)
    return dict(want=want, got=got)


def test_factors_match(fit):
    names = sorted(fit["want"][0][ACTIVATION_COVARIANCE_MATRIX_NAME])
    assert names == ["h_0/attn/c_attn", "h_0/attn/c_proj", "h_0/mlp/c_fc", "h_0/mlp/c_proj",
                     "scorer"]
    assert_factors_match(fit["got"][0], fit["want"][0], names)
    counts = {n: int(c.reshape(-1)[0]) for n, c in
              fit["got"][0][NUM_ACTIVATION_COVARIANCE_PROCESSED].items()}
    assert counts["h_0/mlp/c_fc"] == NUM_TRAIN * pipeline.NUM_CHOICES * TINY["max_seq_len"]
    assert counts["scorer"] == NUM_TRAIN * pipeline.NUM_CHOICES


@pytest.mark.parametrize("kind", ["pairwise", "self"])
def test_scores_match(fit, kind):
    index, shape = (1, (NUM_QUERY, NUM_TRAIN)) if kind == "pairwise" else (2, (NUM_TRAIN,))
    assert_scores_match(fit["got"][index], fit["want"][index], shape)


def test_lowrank_scores_at_the_gradients_rank_match_jax_dense():
    """Identity preconditioning, 2-token sequences: every block module's
    query gradient has rank at most 8, below its smaller width (32), so
    rank-8 query blocks take the randomized SVD and are exact up to
    rounding. The port's rank-8 scores and the JAX package's (each from its
    own draw) against the JAX dense scores."""
    seq_len, rank = 2, 8
    flax_module, params, module = models(seq_len=seq_len)
    train_data, query_data = data(NUM_TRAIN, 0, seq_len), data(NUM_QUERY, 1, seq_len)
    jtask, task = jax_pipeline.MultipleChoiceTask(), pipeline.MultipleChoiceTask()
    jfargs, fargs = jax_factor_args("identity"), pytest_factor_arguments("identity")
    jmodel = jax_prepare(flax_module, jtask)
    jfactors = jax_fit_covariance(jmodel, params, jtask, JaxBatchLoader(train_data, BATCH), jfargs)
    jfactors.update(jax_eigendecomposition(jfactors, jfargs))
    jfactors.update(jax_fit_lambda(jmodel, params, jtask, JaxBatchLoader(train_data, BATCH),
                                   jfargs, eigen_factors=jfactors))

    def jax_scores(low_rank):
        sargs = jax_score_args()
        sargs.query_gradient_low_rank = low_rank
        return np.asarray(jax_pairwise(jmodel, params, jtask, JaxBatchLoader(query_data, QUERY_BATCH),
                                       JaxBatchLoader(train_data, BATCH), jfactors, jfargs,
                                       sargs)[ALL_MODULE_NAME])

    model = prepare_model(module, task)
    loader = BatchLoader(train_data, BATCH, device="cpu")
    factors = fit_covariance_matrices_with_loader(model, task, loader, fargs)
    factors.update(perform_eigendecomposition(factors, fargs))
    factors.update(fit_lambda_matrices_with_loader(model, task, loader, fargs,
                                                   eigen_factors=factors))
    sargs = pytest_score_arguments()
    sargs.query_gradient_low_rank = rank
    got = compute_pairwise_scores_with_loaders(
        model, task, BatchLoader(query_data, QUERY_BATCH, device="cpu"), loader, factors, fargs,
        sargs)[ALL_MODULE_NAME]
    dense = jax_scores(None)
    assert_scores_match(got, dense, (NUM_QUERY, NUM_TRAIN))
    np.testing.assert_allclose(jax_scores(rank), dense, rtol=RTOL, atol=ATOL)
    # The block modules took the low-rank route; the scorer (1 x 33) stays dense.
    assert compute_pairwise_scores_with_loaders.last_run["formats"] == [
        "LowRank[torch.float64]", "Tensor[torch.float64]"]


SMOKE = ["--num_train", "16", "--num_query", "4", "--batch_size", "4", "--cpu"]


def test_train_writes_the_checkpoint(tmp_path):
    module, acc = train.main(["--num_train", "16", "--epochs", "1", "--batch_size", "4",
                              "--cpu", "--checkpoint_dir", str(tmp_path)])
    saved = load_file(tmp_path / "model.safetensors")
    assert saved.keys() == module.state_dict().keys()
    assert all(torch.equal(saved[k], v) for k, v in module.state_dict().items())
    assert 0.0 <= acc <= 1.0


def test_analyze_then_influence_analysis(tmp_path, capsys):
    """analyze fits and scores with rank-4 query blocks; influence_analysis,
    in the same output directory, reads analyze's factors (the same Analyzer
    name and factors name) and scores against them."""
    analyzer, scores = analyze.main(SMOKE + ["--query_gradient_low_rank", "4",
                                             "--output_dir", str(tmp_path)])
    assert tuple(scores.shape) == (4, 16) and bool(torch.isfinite(scores).all())
    factors = tmp_path / "swag" / "factors_ekfac"
    stamps = {p.name: p.stat().st_mtime_ns for p in factors.iterdir()}
    got, agreement = influence_analysis.main(SMOKE + ["--query_gradient_low_rank", "4",
                                                      "--top_k", "2",
                                                      "--output_dir", str(tmp_path)])
    assert {p.name: p.stat().st_mtime_ns for p in factors.iterdir()} == stamps
    assert got.shape == (4, 16) and np.isfinite(got).all()
    assert sorted(agreement) == [0, 1, 2]
    assert "top-2 label agreement with query" in capsys.readouterr().out


def test_evaluate_lds(tmp_path):
    results = evaluate_lds.main(SMOKE + ["--num_subsets", "4", "--epochs", "1",
                                         "--output_dir", str(tmp_path)])
    assert set(results) == {"ekfac", "identity"}
    assert all(-1.0 <= v <= 1.0 for v in results.values())
