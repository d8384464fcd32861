"""The port's uci example (`kronfluence_tpu_torch/examples/uci/`) against the
JAX package's `examples/uci/`: the task's loss, sampled loss and measurement
on the flax MLP's weights carried over by `models/convert.py`, in fp64 at the
parity harness's tolerances; the synthetic data and the Concrete CSV path,
bit for bit; the whole analysis, the port's `Analyzer` against the JAX
`Analyzer` with EK-FAC on the empirical Fisher as `uci/analyze.py` runs it,
in fp64; and each script's `main()` on the CPU at the JAX smoke test's
arguments."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from examples.uci import pipeline as jax_pipeline  # noqa: E402
from kronfluence_tpu import Analyzer as JaxAnalyzer  # noqa: E402
from kronfluence_tpu import prepare_model as jax_prepare  # noqa: E402
from kronfluence_tpu.utils.common.factor_arguments import (  # noqa: E402
    pytest_factor_arguments as jax_factor_args,
)
from kronfluence_tpu.utils.common.score_arguments import (  # noqa: E402
    pytest_score_arguments as jax_score_args,
)
from kronfluence_tpu_torch import Analyzer, prepare_model  # noqa: E402
from kronfluence_tpu_torch.examples.common import print_top_influences  # noqa: E402
from kronfluence_tpu_torch.examples.uci import (  # noqa: E402
    analyze,
    pipeline,
    run_counterfactual,
    train,
)
from kronfluence_tpu_torch.models.convert import state_dict_from_flax  # noqa: E402
from kronfluence_tpu_torch.models.mlp import MLP  # noqa: E402
from kronfluence_tpu_torch.utils.common.factor_arguments import (  # noqa: E402
    pytest_factor_arguments,
)
from kronfluence_tpu_torch.utils.common.score_arguments import (  # noqa: E402
    pytest_score_arguments,
)
from kronfluence_tpu_torch.utils.save import load_file  # noqa: E402

RTOL, ATOL = 1.3e-6, 1e-5
NUM_TRAIN, NUM_QUERY, BATCH = 40, 6, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread and one BLAS thread: these tests run many small ops
    and host eighs beside the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def _models():
    """The JAX pipeline's MLP with its init weights in fp64, and the port's
    MLP holding them."""
    module, params = jax_pipeline.construct_regression_mlp(seed=0)
    params = jax.tree_util.tree_map(lambda p: np.asarray(p, np.float64), jax.device_get(params))
    tmodule = MLP(8, hidden_dims=(64, 64), out_dim=1, dtype=torch.float64)
    tmodule.load_state_dict(state_dict_from_flax(params, tmodule))
    return module, params, tmodule


def _fp64(data):
    return {k: np.asarray(v, np.float64) for k, v in data.items()}


def test_task_matches_jax():
    """Loss and measurement to the parity tolerances; the sampled loss and
    its gradient on the port's noise against JAX's on the same noise; the
    same tracked modules (every one)."""
    module, params, tmodule = _models()
    data = _fp64(pipeline.get_regression_dataset("train", 8))
    jtask, ttask = jax_pipeline.RegressionTask(), pipeline.RegressionTask()
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in data.items()}
    bound = module.bind({"params": params})
    with torch.no_grad():
        for name in ("compute_train_loss", "compute_measurement"):
            want = float(getattr(jtask, name)(jbatch, bound))
            got = float(getattr(ttask, name)(tbatch, tmodule))
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)
        noise = torch.randn((8, 1), generator=torch.Generator().manual_seed(3),
                            dtype=torch.float64).numpy()

    def sampled(p):
        preds = module.apply({"params": p}, jbatch["x"])
        return jnp.sum((preds - (jax.lax.stop_gradient(preds) + noise)) ** 2)

    want, want_grad = jax.value_and_grad(sampled)(params)
    got = ttask.compute_train_loss(tbatch, tmodule, True, torch.Generator().manual_seed(3))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=ATOL)
    expected = state_dict_from_flax(jax.device_get(want_grad), tmodule)
    for name, p in tmodule.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), expected[name].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    assert ttask.get_influence_tracked_modules() is jtask.get_influence_tracked_modules() is None


@pytest.mark.parametrize("split,num", [("train", None), ("eval", None), ("train", 7),
                                       ("eval", 5)])
def test_synthetic_data_matches_jax(split, num):
    got = pipeline.get_regression_dataset(split, num, seed=2)
    want = jax_pipeline.get_regression_dataset(split, num, seed=2)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("split,num", [("train", None), ("eval", None), ("train", 5)])
def test_concrete_csv_matches_jax(tmp_path, monkeypatch, split, num):
    """`UCI_CONCRETE_CSV` names a local CSV: a header, 8 features and the
    target a row; the first 90% of the rows train, the rest evaluate."""
    rng = np.random.default_rng(4)
    rows = np.concatenate([rng.uniform(0, 500, (30, 8)), rng.uniform(5, 80, (30, 1))], axis=1)
    path = tmp_path / "concrete.csv"
    np.savetxt(path, rows, delimiter=",", header=",".join(f"c{i}" for i in range(9)),
               comments="")
    monkeypatch.setattr(jax_pipeline, "CONCRETE_CSV", str(path))
    monkeypatch.setattr(pipeline, "CONCRETE_CSV", str(path))
    got = pipeline.get_regression_dataset(split, num)
    want = jax_pipeline.get_regression_dataset(split, num)
    assert len(got["x"]) == (num or (27 if split == "train" else 3))
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_analysis_matches_jax(tmp_path):
    """The port's Analyzer against the JAX Analyzer on the same fp64 MLP and
    data: EK-FAC on the empirical Fisher (uci/analyze.py's recipe, in fp64),
    pairwise scores of every query against every train example, with a
    padded last train batch."""
    module, params, tmodule = _models()
    train_data = _fp64(pipeline.get_regression_dataset("train", NUM_TRAIN))
    query_data = _fp64(pipeline.get_regression_dataset("eval", NUM_QUERY))
    jtask, ttask = jax_pipeline.RegressionTask(), pipeline.RegressionTask()
    jax_analyzer = JaxAnalyzer("uci", jax_prepare(module, jtask), jtask, params=params, cpu=True,
                               output_dir=str(tmp_path / "jax"))
    port_analyzer = Analyzer("uci", prepare_model(tmodule, ttask), ttask, cpu=True,
                             output_dir=str(tmp_path / "port"))
    scores = []
    for analyzer, factor_args, score_args in ((jax_analyzer, jax_factor_args, jax_score_args),
                                              (port_analyzer, pytest_factor_arguments,
                                               pytest_score_arguments)):
        fargs = factor_args("ekfac")
        assert fargs.use_empirical_fisher
        analyzer.fit_all_factors("ekfac", train_data, per_device_batch_size=BATCH,
                                 factor_args=fargs)
        analyzer.compute_pairwise_scores(
            "pairwise", "ekfac", query_data, train_data, per_device_query_batch_size=NUM_QUERY,
            per_device_train_batch_size=BATCH, score_args=score_args())
        scores.append(np.asarray(analyzer.load_pairwise_scores("pairwise")["all_modules"],
                                 np.float64))
    want, got = scores
    assert got.shape == want.shape == (NUM_QUERY, NUM_TRAIN)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_train_writes_the_checkpoint(tmp_path):
    model = train.main(["--num_train", "48", "--epochs", "1", "--cpu",
                        "--checkpoint_dir", str(tmp_path)])
    saved = load_file(tmp_path / "model.safetensors")
    assert saved.keys() == model.state_dict().keys()
    assert all(torch.equal(saved[k], v) for k, v in model.state_dict().items())


def test_analyze(tmp_path, capsys):
    analyzer, scores = analyze.main(["--num_train", "48", "--queries", "4",
                                     "--train_batch_size", "16", "--cpu",
                                     "--output_dir", str(tmp_path)])
    assert tuple(scores.shape) == (4, 48) and bool(torch.isfinite(scores).all())
    assert (tmp_path / "uci" / "factors_ekfac").is_dir()
    assert "query 2: top" in capsys.readouterr().out


def test_run_counterfactual(tmp_path):
    results = run_counterfactual.main(["--num_train", "32", "--queries", "4", "--remove", "4",
                                       "--epochs", "1", "--seeds", "1", "--cpu",
                                       "--output_dir", str(tmp_path)])
    assert set(results) == {"full dataset", "remove most-positive", "remove most-negative",
                            "remove random"}
    assert all(np.isfinite(mean) and std == 0.0 for mean, std in results.values())


def test_print_top_influences(capsys):
    """The JAX helper's lines, from a tensor or an array."""
    scores = np.arange(12.0).reshape(3, 4) * np.array([1, -1, 1])[:, None]
    print_top_influences(torch.from_numpy(scores), k=2)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("query 0: top [3, 2]") and out[0].endswith("bottom [0, 1]")
    assert out[1].startswith("query 1: top [0, 1]") and out[1].endswith("bottom [3, 2]")
    assert len(out) == 3
