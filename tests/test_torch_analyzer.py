"""The port's public entry point (`kronfluence_tpu_torch.Analyzer`) against
the JAX package's, on the tiny GPT-2 in fp64: the artifacts on disk, their
names, arguments and metadata, the factors and the scores, cross-loading of
factor directories in both directions, the safetensors format, partitions,
resume, argument checks, task checks, the batch sizes the memory model
picks and the loader knobs."""

import copy
import json
import logging
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import safetensors.numpy
import torch
from threadpoolctl import threadpool_limits

from kronfluence_tpu.analyzer import Analyzer as JaxAnalyzer
from kronfluence_tpu.factor import io as jax_io
from kronfluence_tpu.prepare import prepare_model as jax_prepare
from kronfluence_tpu.utils.common.factor_arguments import (
    pytest_factor_arguments as jax_factor_args,
)
from kronfluence_tpu.utils.common.score_arguments import (
    pytest_score_arguments as jax_score_args,
)
from kronfluence_tpu.utils.dataset import DataLoaderKwargs as JaxDataLoaderKwargs
from kronfluence_tpu.utils.exceptions import (
    IllegalTaskConfigurationError as JaxIllegalTask,
    TrackedModuleNotFoundError as JaxTrackedNotFound,
)
from kronfluence_tpu.utils.task_check import verify_task_configuration as jax_verify_task
from kronfluence_tpu_torch import Analyzer, FactorArguments
from kronfluence_tpu_torch.computer import factor_computer, score_computer
from kronfluence_tpu_torch.factor import io as port_io
from kronfluence_tpu_torch.utils.common.factor_arguments import pytest_factor_arguments
from kronfluence_tpu_torch.utils.common.score_arguments import pytest_score_arguments
from kronfluence_tpu_torch.utils.constants import (
    ALL_MODULE_NAME,
    COVARIANCE_FACTOR_NAMES,
    LAMBDA_FACTOR_NAMES,
)
from kronfluence_tpu_torch.utils.dataset import DataLoaderKwargs
from kronfluence_tpu_torch.utils.exceptions import (
    IllegalTaskConfigurationError,
    TrackedModuleNotFoundError,
)
from kronfluence_tpu_torch.utils.save import load_file, save_file

from tests.testable_tasks.language_modeling import LanguageModelingTask, make_lm, make_lm_data
from tests.testable_tasks.torch_language_modeling import (
    TorchLanguageModelingTask,
    make_torch_lm,
)

# The reference's own equivalence tolerance (tests/test_reference_parity.py:61).
RTOL, ATOL = 1.3e-6, 1e-5
NUM_TRAIN, TRAIN_BATCH = 10, 4
NUM_QUERY, QUERY_BATCH = 5, 2
NAME = "lm"
PARTITIONS = dict(
    covariance_data_partitions=2, covariance_module_partitions=2,
    lambda_data_partitions=2, lambda_module_partitions=2,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def _run(analyzer, factors_name, train, query, factor_args, score_args, scores_suffix=""):
    analyzer.fit_all_factors(
        factors_name, train, per_device_batch_size=TRAIN_BATCH, factor_args=factor_args
    )
    analyzer.compute_pairwise_scores(
        "pairwise" + scores_suffix, factors_name, query, train,
        per_device_query_batch_size=QUERY_BATCH, per_device_train_batch_size=TRAIN_BATCH,
        score_args=score_args,
    )
    analyzer.compute_self_scores(
        "self" + scores_suffix, factors_name, train, per_device_train_batch_size=TRAIN_BATCH,
        score_args=score_args,
    )


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One analysis per package on the same weights and data, and one of the
    port with 2 data x 2 module partitions in every stage."""
    jmodel, params, jtask, config = make_lm()
    tmodel, ttask, _ = make_torch_lm(params, config)
    train = make_lm_data(NUM_TRAIN, seq_len=config.max_seq_len, vocab=config.vocab_size, seed=0)
    query = make_lm_data(NUM_QUERY, seq_len=config.max_seq_len, vocab=config.vocab_size, seed=1)
    jdir, tdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    jax_analyzer = JaxAnalyzer(NAME, jmodel, jtask, params=params, cpu=True, output_dir=str(jdir))
    port_analyzer = Analyzer(NAME, tmodel, ttask, cpu=True, output_dir=str(tdir))
    _run(jax_analyzer, "ekfac", train, query, jax_factor_args("ekfac"), jax_score_args())
    _run(port_analyzer, "ekfac", train, query, pytest_factor_arguments("ekfac"),
         pytest_score_arguments())
    parted_args = pytest_factor_arguments("ekfac")
    for field, value in PARTITIONS.items():
        setattr(parted_args, field, value)
    parted_scores = pytest_score_arguments()
    parted_scores.data_partitions = parted_scores.module_partitions = 2
    _run(port_analyzer, "parted", train, query, parted_args, parted_scores, "_parted")
    return dict(
        jmodel=jmodel, params=params, jtask=jtask, tmodel=tmodel, ttask=ttask, train=train,
        query=query, jdir=jdir / NAME, tdir=tdir / NAME, jax=jax_analyzer, port=port_analyzer,
    )


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _close(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=what)


def test_same_artifact_names(runs):
    for sub in ("factors_ekfac", "scores_pairwise", "scores_self"):
        assert _files(runs["jdir"] / sub) == _files(runs["tdir"] / sub), sub
    assert "activation_covariance.safetensors" in _files(runs["tdir"] / "factors_ekfac")


def test_same_arguments_and_metadata_json(runs):
    names = [n for n in _files(runs["jdir"]) if n.endswith(".json") and "parted" not in n]
    # Factor arguments and two stages' metadata; pairwise: score arguments,
    # query and train metadata; self: score arguments and train metadata.
    assert len(names) == 8, names
    for name in names:
        want = json.loads((runs["jdir"] / name).read_text())
        got = json.loads((runs["tdir"] / name).read_text())
        assert got == want, name


def _eigen_reconstructions(eigen, name):
    out = {}
    for side in ("activation", "gradient"):
        q = np.asarray(eigen[f"{side}_eigenvectors"][name], np.float64)
        lam = np.asarray(eigen[f"{side}_eigenvalues"][name], np.float64)
        out[side] = (lam, (q * lam) @ q.T)
    return out


def _check_factors(got_dir, want, factors_name):
    """Factors of the port at `got_dir` against the JAX package's dicts."""
    got_cov = port_io.load_covariance_matrices(got_dir / f"factors_{factors_name}")
    for factor_name in COVARIANCE_FACTOR_NAMES:
        assert set(got_cov[factor_name]) == set(want["cov"][factor_name])
        for module, w in want["cov"][factor_name].items():
            _close(got_cov[factor_name][module], w, f"{factor_name} {module}")
    got_eig = port_io.load_eigendecomposition(got_dir / f"factors_{factors_name}")
    for module in want["eig"]["activation_eigenvalues"]:
        g, w = _eigen_reconstructions(got_eig, module), _eigen_reconstructions(want["eig"], module)
        for side in g:
            _close(g[side][0], w[side][0], f"{side} eigenvalues {module}")
            _close(g[side][1], w[side][1], f"{side} reconstruction {module}")
    got_lam = port_io.load_lambda_matrices(got_dir / f"factors_{factors_name}")
    for factor_name in LAMBDA_FACTOR_NAMES:
        for module, w in want["lam"][factor_name].items():
            _close(got_lam[factor_name][module], w, f"{factor_name} {module}")


def _jax_factors(runs):
    fdir = runs["jdir"] / "factors_ekfac"
    return dict(
        cov=jax_io.load_covariance_matrices(fdir),
        eig=jax_io.load_eigendecomposition(fdir),
        lam=jax_io.load_lambda_matrices(fdir),
    )


@pytest.mark.parametrize("factors_name", ["ekfac", "parted"], ids=["whole", "partitions_2x2"])
def test_factors_match_jax(runs, factors_name):
    """Covariance and lambda elementwise, eigenpairs through eigenvalues and
    reconstructions (eigenvectors differ in sign between solvers), with and
    without partitions."""
    _check_factors(runs["tdir"], _jax_factors(runs), factors_name)


def test_partition_artifacts_on_disk(runs):
    files = _files(runs["tdir"] / "factors_parted")
    for di in range(2):
        for mi in range(2):
            for stem in ("activation_covariance", "lambda_matrix"):
                assert f"{stem}_data_partition{di}_module_partition{mi}.safetensors" in files
    assert "pairwise_scores_data_partition1_module_partition1.safetensors" in _files(
        runs["tdir"] / "scores_pairwise_parted"
    )


@pytest.mark.parametrize("kind", ["pairwise", "self"])
@pytest.mark.parametrize("suffix", ["", "_parted"], ids=["whole", "partitions_2x2"])
def test_scores_match_jax(runs, kind, suffix):
    want = runs["jax"].load_pairwise_scores if kind == "pairwise" else runs["jax"].load_self_scores
    got = runs["port"].load_pairwise_scores if kind == "pairwise" else runs["port"].load_self_scores
    want, got = want(kind), got(kind + suffix)
    assert set(got) == set(want) == {ALL_MODULE_NAME}
    shape = (NUM_QUERY, NUM_TRAIN) if kind == "pairwise" else (NUM_TRAIN,)
    assert tuple(got[ALL_MODULE_NAME].shape) == shape
    assert got[ALL_MODULE_NAME].dtype == torch.float64
    _close(got[ALL_MODULE_NAME], want[ALL_MODULE_NAME], kind)


@pytest.mark.parametrize("use_measurement", [False, True], ids=["loss", "measurement"])
def test_self_scores_match_jax(runs, use_measurement):
    """compute_self_scores with and without `use_measurement_for_self_influence`."""
    jscore, tscore = jax_score_args(), pytest_score_arguments()
    jscore.use_measurement_for_self_influence = use_measurement
    tscore.use_measurement_for_self_influence = use_measurement
    name = f"self_measurement_{use_measurement}"
    runs["jax"].compute_self_scores(
        name, "ekfac", runs["train"], per_device_train_batch_size=TRAIN_BATCH, score_args=jscore
    )
    runs["port"].compute_self_scores(
        name, "ekfac", runs["train"], per_device_train_batch_size=TRAIN_BATCH, score_args=tscore
    )
    got = runs["port"].load_self_scores(name)[ALL_MODULE_NAME]
    _close(got, runs["jax"].load_self_scores(name)[ALL_MODULE_NAME], name)
    # The task's measurement is its train loss: both variants are the
    # pairwise diagonal with the train set as queries.
    runs["port"].compute_pairwise_scores(
        "train_x_train", "ekfac", runs["train"], runs["train"],
        per_device_query_batch_size=TRAIN_BATCH, per_device_train_batch_size=TRAIN_BATCH,
        score_args=tscore,
    )
    diagonal = torch.diagonal(runs["port"].load_pairwise_scores("train_x_train")[ALL_MODULE_NAME])
    torch.testing.assert_close(got, diagonal, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("reader", ["port_reads_jax", "jax_reads_port"])
def test_cross_loading(runs, tmp_path, reader):
    """Each package scores from the other's factor directory and gets its own scores."""
    source = runs["jdir"] if reader == "port_reads_jax" else runs["tdir"]
    shutil.copytree(source / "factors_ekfac", tmp_path / NAME / "factors_ekfac")
    if reader == "port_reads_jax":
        analyzer = Analyzer(NAME, runs["tmodel"], runs["ttask"], cpu=True, output_dir=str(tmp_path))
        score_args, own = pytest_score_arguments(), runs["port"]
    else:
        analyzer = JaxAnalyzer(
            NAME, runs["jmodel"], runs["jtask"], params=runs["params"], cpu=True,
            output_dir=str(tmp_path),
        )
        score_args, own = jax_score_args(), runs["jax"]
    analyzer.compute_pairwise_scores(
        "cross", "ekfac", runs["query"], runs["train"], per_device_query_batch_size=QUERY_BATCH,
        per_device_train_batch_size=TRAIN_BATCH, score_args=score_args,
    )
    got = analyzer.load_pairwise_scores("cross")[ALL_MODULE_NAME]
    _close(got, own.load_pairwise_scores("pairwise")[ALL_MODULE_NAME], reader)


def test_resume_skips_every_stage(runs, monkeypatch):
    """A new Analyzer on the finished directory runs no stage and writes no file."""
    def forbidden(*args, **kwargs):
        raise AssertionError("a stage ran on resume")

    for module, names in (
        (factor_computer, ("fit_covariance_matrices_with_loader", "fit_lambda_matrices_with_loader",
                           "_perform_eigendecomposition")),
        (score_computer, ("compute_pairwise_scores_with_loaders",
                          "compute_self_scores_with_loaders")),
    ):
        for name in names:
            monkeypatch.setattr(module, name, forbidden)
    root = runs["tdir"]
    before = {p: p.stat().st_mtime_ns for p in root.rglob("*") if p.is_file()}
    analyzer = Analyzer(NAME, runs["tmodel"], runs["ttask"], cpu=True, output_dir=str(root.parent))
    _run(analyzer, "ekfac", runs["train"], runs["query"], pytest_factor_arguments("ekfac"),
         pytest_score_arguments())
    _run(analyzer, "parted", runs["train"], runs["query"], None, None, "_parted")
    after = {p: p.stat().st_mtime_ns for p in root.rglob("*") if p.is_file()}
    assert after == before


@pytest.mark.parametrize(
    "existing", ["same", "lacks_a_field", "has_an_extra_field", "differs_in_a_shared_field"]
)
def test_saved_arguments_compare_on_key_intersection(runs, tmp_path, existing):
    """The JAX package's compare: only keys present on both sides count."""
    analyzer = Analyzer(NAME, runs["tmodel"], runs["ttask"], cpu=True, output_dir=str(tmp_path))
    args = FactorArguments()
    saved = args.to_dict()
    if existing == "lacks_a_field":
        del saved["eigendecomposition_solver"]
    elif existing == "has_an_extra_field":
        saved["a_field_from_a_newer_version"] = 3
    elif existing == "differs_in_a_shared_field":
        saved["lambda_max_examples"] = 7
    path = tmp_path / "factor_arguments.json"
    path.write_text(json.dumps(saved))
    if existing == "differs_in_a_shared_field":
        with pytest.raises(ValueError, match="differ"):
            analyzer._save_arguments("factor", args, tmp_path, overwrite_output_dir=False)
    else:
        analyzer._save_arguments("factor", args, tmp_path, overwrite_output_dir=False)
    assert json.loads(path.read_text()) == saved
    analyzer._save_arguments("factor", args, tmp_path, overwrite_output_dir=True)
    assert json.loads(path.read_text()) == args.to_dict()


def test_changed_arguments_raise_in_a_stage(runs, tmp_path):
    analyzer = Analyzer(NAME, runs["tmodel"], runs["ttask"], cpu=True, output_dir=str(tmp_path))
    args = pytest_factor_arguments("ekfac")
    analyzer.fit_covariance_matrices("f", runs["train"], per_device_batch_size=5, factor_args=args)
    args.lambda_max_examples = 4
    with pytest.raises(ValueError, match="differ from the current"):
        analyzer.fit_lambda_matrices("f", runs["train"], per_device_batch_size=5, factor_args=args)


def test_model_save_and_verify(runs, tmp_path):
    Analyzer(NAME, runs["tmodel"], runs["ttask"], cpu=True, output_dir=str(tmp_path),
             disable_model_save=False)
    saved = load_file(tmp_path / NAME / "model.safetensors")
    assert set(saved) == set(runs["tmodel"].module.state_dict())
    Analyzer(NAME, runs["tmodel"], runs["ttask"], cpu=True, output_dir=str(tmp_path),
             disable_model_save=False)
    other = copy.deepcopy(runs["tmodel"].module)
    with torch.no_grad():
        other.lm_head.weight.add_(1e-3)
    with pytest.raises(ValueError, match="differ"):
        Analyzer(NAME, other, runs["ttask"], cpu=True, output_dir=str(tmp_path),
                 disable_model_save=False)


def test_trace_profile_and_progress_log(runs, tmp_path, caplog):
    analyzer = Analyzer(NAME, runs["tmodel"], runs["ttask"], cpu=True, output_dir=str(tmp_path),
                        profile="trace", log_level=logging.INFO)
    with caplog.at_level(logging.INFO):
        analyzer.fit_covariance_matrices(
            "f", runs["train"], per_device_batch_size=5, factor_args=pytest_factor_arguments()
        )
    assert list((tmp_path / "profiler_output").glob("fit_covariance_*.json"))
    assert any("Batches: 2/2" in r.getMessage() for r in caplog.records)
    assert "Fit Covariance" in analyzer.profiler.summary()


def test_cpu_false_without_a_card_raises(runs, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu=True"):
        Analyzer(NAME, runs["tmodel"], runs["ttask"], output_dir=str(tmp_path))


# Both packages' budget functions give these bytes: the tiny GPT-2's fp64
# recipe then runs covariance in batches of 3, lambda of 4, pairwise of 5 and
# self of 4, each with a padded last batch.
BUDGET = 3e6


def _spy_batch_sizes(analyzer, monkeypatch):
    chosen = []
    real = analyzer._find_executable_batch_size

    def spy(*args, **kwargs):
        chosen.append(real(*args, **kwargs))
        return chosen[-1]

    monkeypatch.setattr(analyzer, "_find_executable_batch_size", spy)
    return chosen


def test_default_batch_sizes_match_jax(runs, tmp_path, monkeypatch):
    """Every batch size left to the memory model: both packages pick the same
    batches for the same budget and give the same factors and scores."""
    from kronfluence_tpu.utils import memory as jax_memory
    from kronfluence_tpu_torch.utils import memory as port_memory

    monkeypatch.setattr(jax_memory, "device_memory_budget", lambda fraction=0.5: BUDGET)
    monkeypatch.setattr(port_memory, "device_memory_budget", lambda device, fraction=0.5: BUDGET)
    jax_analyzer = JaxAnalyzer(NAME, runs["jmodel"], runs["jtask"], params=runs["params"],
                               cpu=True, output_dir=str(tmp_path / "jax"))
    port = Analyzer(NAME, runs["tmodel"], runs["ttask"], cpu=True, output_dir=str(tmp_path / "port"))
    chosen = {}
    for key, analyzer, fargs, sargs in (
        ("jax", jax_analyzer, jax_factor_args("ekfac"), jax_score_args()),
        ("port", port, pytest_factor_arguments("ekfac"), pytest_score_arguments()),
    ):
        chosen[key] = _spy_batch_sizes(analyzer, monkeypatch)
        analyzer.fit_all_factors("auto", runs["train"], factor_args=fargs)
        analyzer.compute_pairwise_scores("auto", "auto", runs["query"], runs["train"],
                                         per_device_query_batch_size=QUERY_BATCH,
                                         score_args=sargs)
        analyzer.compute_self_scores("auto_self", "auto", runs["train"], score_args=sargs)
    assert chosen["port"] == chosen["jax"] == [3, 4, 5, 4]
    assert port.last_batch_estimate["stage"] == "self"
    assert port.last_batch_estimate["untracked_bytes"] == 0.0  # the JAX model on the CPU
    for factor_names, load in ((COVARIANCE_FACTOR_NAMES, "load_covariance_matrices"),
                               (LAMBDA_FACTOR_NAMES, "load_lambda_matrices")):
        got, want = getattr(port, load)("auto"), getattr(jax_analyzer, load)("auto")
        for factor in factor_names:
            for module, tensor in want[factor].items():
                _close(got[factor][module], tensor, f"{factor}/{module}")
    _close(port.load_pairwise_scores("auto")[ALL_MODULE_NAME],
           jax_analyzer.load_pairwise_scores("auto")[ALL_MODULE_NAME], "pairwise")
    _close(port.load_self_scores("auto_self")[ALL_MODULE_NAME],
           jax_analyzer.load_self_scores("auto_self")[ALL_MODULE_NAME], "self")


def test_batch_size_attempt_clamps_the_estimate(runs, tmp_path, caplog):
    """The attempt is clamped to the examples; the estimate never exceeds it,
    and an info line says when the estimate cuts it."""
    port = Analyzer(NAME, runs["tmodel"], runs["ttask"], cpu=True, output_dir=str(tmp_path),
                    log_level=logging.INFO)
    with caplog.at_level(logging.INFO):
        port.fit_covariance_matrices("f", runs["train"], initial_per_device_batch_size_attempt=6,
                                     factor_args=pytest_factor_arguments())
    assert port.last_batch_estimate["attempt"] == 6
    assert port.last_batch_estimate["batch_size"] == 6  # 7.5 GiB on the CPU fits all 6
    assert not any("reduced the per-device batch size" in r.getMessage() for r in caplog.records)
    port.fit_covariance_matrices("g", runs["train"], factor_args=pytest_factor_arguments())
    assert port.last_batch_estimate["attempt"] == NUM_TRAIN


def _rows(data):
    return [{k: v[i] for k, v in data.items()} for i in range(len(data["input_ids"]))]


def _stack_rows(rows):
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


@pytest.mark.parametrize("knob", ["collate_fn", "num_workers", "drop_last"])
def test_loader_knobs_match_jax(runs, tmp_path, knob):
    """The covariance of the train set through each loader knob, by both
    Analyzers: `collate_fn` on a dataset of rows, a prefetch thread, and
    `drop_last` (10 examples in batches of 4: 8 kept); also set through
    `set_dataloader_kwargs`."""
    value = {"collate_fn": _stack_rows, "num_workers": 2, "drop_last": True}[knob]
    data = _rows(runs["train"]) if knob == "collate_fn" else runs["train"]
    results = {}
    for key, analyzer, kwargs_cls, fargs in (
        ("jax", JaxAnalyzer(NAME, runs["jmodel"], runs["jtask"], params=runs["params"], cpu=True,
                            output_dir=str(tmp_path / "jax")), JaxDataLoaderKwargs,
         jax_factor_args("ekfac")),
        ("port", Analyzer(NAME, runs["tmodel"], runs["ttask"], cpu=True,
                          output_dir=str(tmp_path / "port")), DataLoaderKwargs,
         pytest_factor_arguments("ekfac")),
    ):
        analyzer.fit_covariance_matrices(
            "f", data, per_device_batch_size=TRAIN_BATCH,
            dataloader_kwargs=kwargs_cls(**{knob: value}), factor_args=fargs)
        analyzer.set_dataloader_kwargs(kwargs_cls(**{knob: value}))
        analyzer.fit_covariance_matrices("g", data, per_device_batch_size=TRAIN_BATCH,
                                         factor_args=fargs)
        results[key] = (analyzer.load_covariance_matrices("f"),
                        analyzer.load_covariance_matrices("g"))
    tokens = int(runs["train"]["attention_mask"][: 8 if knob == "drop_last" else NUM_TRAIN].sum())
    for got, want in zip(results["port"], results["jax"]):
        for factor in COVARIANCE_FACTOR_NAMES:
            for module, tensor in want[factor].items():
                _close(got[factor][module], tensor, f"{knob} {factor}/{module}")
        count = got["num_activation_covariance_processed"]
        assert {int(t[0]) for t in count.values()} == {tokens}


# -- The safetensors format, against the `safetensors` package. --
SAFETENSORS_DTYPES = {
    "float64": (torch.float64, np.float64),
    "float32": (torch.float32, np.float32),
    "float16": (torch.float16, np.float16),
    "bfloat16": (torch.bfloat16, ml_dtypes.bfloat16),
    "int64": (torch.int64, np.int64),
}


def _payload(dtype_name):
    rng = np.random.default_rng(0)
    if dtype_name == "int64":
        return {"count": np.asarray([12345678901], np.int64), "ids": rng.integers(-9, 9, (3, 5))}
    np_dtype = SAFETENSORS_DTYPES[dtype_name][1]
    return {
        "matrix": rng.standard_normal((7, 5)).astype(np_dtype),
        "odd": rng.standard_normal((3,)).astype(np_dtype),
        "scalar": np.asarray(1.5, np_dtype),
        "empty": np.zeros((0, 4), np_dtype),
        # A second dtype in the same file, so entries of two item sizes share
        # one buffer.
        "half": rng.standard_normal((3,)).astype(np.float16),
    }


def _as_bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.numpy()
    return np.ascontiguousarray(x).view(np.uint8).tobytes(), tuple(x.shape)


@pytest.mark.parametrize("dtype_name", list(SAFETENSORS_DTYPES))
@pytest.mark.parametrize("writer", ["port_writes", "safetensors_writes"])
def test_safetensors_round_trip(tmp_path, dtype_name, writer):
    arrays = _payload(dtype_name)
    path = tmp_path / "t.safetensors"
    if writer == "port_writes":
        tensors = {}
        for name, a in arrays.items():
            if a.dtype == ml_dtypes.bfloat16:
                t = torch.from_numpy(a.copy().view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a.copy())
            tensors[name] = t.T if t.ndim == 2 else t  # non-contiguous inputs too
        save_file(tensors, path, metadata={"format": "pt"})
        got = safetensors.numpy.load_file(str(path))
        want = {name: (a.T if a.ndim == 2 else a) for name, a in arrays.items()}
        if dtype_name == "int64":  # integers persist as int64 vectors
            want = {name: a.reshape(-1) for name, a in want.items()}
    else:
        safetensors.numpy.save_file(arrays, str(path), metadata={"format": "np"})
        got, want = load_file(path), arrays
    assert set(got) == set(want)
    for name in want:
        assert _as_bits(got[name]) == _as_bits(want[name]), name


# -- Task checks: the JAX package's and the port's raise alike. --
class _Mean(LanguageModelingTask):
    def compute_train_loss(self, batch, model, sample=False, rng=None):
        return super().compute_train_loss(batch, model, sample, rng) / batch["input_ids"].shape[0]


class _TorchMean(TorchLanguageModelingTask):
    def compute_train_loss(self, batch, model, sample=False, generator=None):
        return super().compute_train_loss(batch, model, sample, generator) / len(batch["input_ids"])


class _VectorMeasurement(LanguageModelingTask):
    def compute_measurement(self, batch, model):
        return model(batch["input_ids"], batch["attention_mask"]).sum(axis=(1, 2))


class _TorchVectorMeasurement(TorchLanguageModelingTask):
    def compute_measurement(self, batch, model):
        return model(batch["input_ids"], batch["attention_mask"]).sum(dim=(1, 2))


class _WrongMask(LanguageModelingTask):
    def get_attention_mask(self, batch):
        return jnp.ones((batch["input_ids"].shape[0], 3))


class _TorchWrongMask(TorchLanguageModelingTask):
    def get_attention_mask(self, batch):
        return torch.ones((len(batch["input_ids"]), 3))


class _UnknownTracked(LanguageModelingTask):
    def get_influence_tracked_modules(self):
        return ["h_0/mlp/c_fc", "h_9/mlp/nope"]


class _TorchUnknownTracked(TorchLanguageModelingTask):
    def get_influence_tracked_modules(self):
        return ["h_0/mlp/c_fc", "h_9/mlp/nope"]


TASK_CASES = {
    "summed": (LanguageModelingTask, TorchLanguageModelingTask, None, None),
    "mean_reduced": (_Mean, _TorchMean, JaxIllegalTask, IllegalTaskConfigurationError),
    "vector_measurement": (
        _VectorMeasurement, _TorchVectorMeasurement, JaxIllegalTask, IllegalTaskConfigurationError
    ),
    "wrong_mask": (_WrongMask, _TorchWrongMask, JaxIllegalTask, IllegalTaskConfigurationError),
    "unknown_tracked": (
        _UnknownTracked, _TorchUnknownTracked, JaxTrackedNotFound, TrackedModuleNotFoundError
    ),
}


@pytest.mark.parametrize("case", list(TASK_CASES))
def test_verify_task_raises_as_jax(runs, tmp_path, case):
    jax_task_cls, port_task_cls, jax_error, port_error = TASK_CASES[case]
    jax_task = jax_task_cls()
    jmodel = jax_prepare(runs["jmodel"].module, jax_task)
    batch = jax.tree_util.tree_map(
        jnp.asarray, {k: v[:TRAIN_BATCH] for k, v in runs["train"].items()}
    )
    if jax_error is None:
        jax_verify_task(jmodel, runs["params"], jax_task, batch)
    else:
        with pytest.raises(jax_error):
            jax_verify_task(jmodel, runs["params"], jax_task, batch)
    port_task = port_task_cls()
    analyzer = Analyzer(NAME, runs["tmodel"].module, port_task, cpu=True, output_dir=str(tmp_path))
    if port_error is None:
        analyzer.verify_task(runs["train"], per_device_batch_size=TRAIN_BATCH)
    else:
        with pytest.raises(port_error):
            analyzer.verify_task(runs["train"], per_device_batch_size=TRAIN_BATCH)

