"""The port's data-parallel runtime (kronfluence_tpu_torch/parallel/) on the CPU.

Two gloo ranks, started as subprocesses of one module-scoped launch
(tests/testable_tasks/torch_distributed_worker.py, one torch thread each,
each waited on with a time limit of its own), run every stage on a data
mesh, and are held against the JAX package's single-process results on the
same numpy-seeded data and the same weights:

  * test_multihost.py's fp64 tanh MLP: covariance, eigendecomposition,
    lambda, pairwise and self scores, at its 1e-12 on factors and 1e-10 on
    scores;
  * the tiny GPT-2 of the parity tests, at the parity harness's rtol 1.3e-6
    / atol 1e-5;
  * test_sharding.py's uneven final batch, at rtol 1e-9 / atol 1e-11.

A third process, a world of one, holds the mesh path bitwise to the path
without a mesh. The two ranks also hold the score options (float8 and
low-rank query blocks, aggregated gradients) on the mesh to one process's,
and check the refusals and the Analyzer: rank 0 alone writes, both ranks
load equal scores, and rank 1 logs only when asked to.
"""

import os
import subprocess
import sys
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kronfluence_tpu import Task as JaxTask
from kronfluence_tpu import prepare_model as jax_prepare
from kronfluence_tpu.arguments import FactorArguments as JaxFactorArguments
from kronfluence_tpu.factor.covariance import (
    fit_covariance_matrices_with_loader as jax_fit_covariance,
)
from kronfluence_tpu.utils.dataset import BatchLoader as JaxBatchLoader

from tests.testable_tasks.language_modeling import make_lm, make_lm_data
from tests.testable_tasks.parity import (
    COUNTS,
    EIGENPAIRS,
    MATRICES,
    _np,
    _reconstruction,
    assert_bitwise,
    assert_factors_match,
    assert_scores_match,
    jax_stages,
)
from tests.testable_tasks.regression import make_mlp, make_regression_data
from tests.testable_tasks.torch_distributed_worker import FP64_FACTOR
from tests.testable_tasks.torch_language_modeling import make_torch_lm
from tests.testable_tasks.torch_regression import torch_mlp

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "testable_tasks" / "torch_distributed_worker.py"
# Each process's own limit: a hung collective fails the test, not the suite.
WORKER_TIMEOUT = 240
MLP_N, MLP_QUERIES, MLP_BATCH = 40, 8, 8
GPT2_N, GPT2_QUERIES, GPT2_BATCH, GPT2_QUERY_BATCH = 10, 5, 4, 2
UNEVEN_N, UNEVEN_BASE_BATCH = 24, 24
MLP_NAMES = ("fc1", "fc2")
UNEVEN_NAMES = ("layers_0", "layers_1", "output")


class TanhMLP(nn.Module):
    @nn.compact
    def __call__(self, x):
        x = jnp.tanh(nn.Dense(8, param_dtype=jnp.float64, name="fc1")(x))
        return nn.Dense(2, param_dtype=jnp.float64, name="fc2")(x)


class HalfSquaredErrorTask(JaxTask):
    def compute_train_loss(self, batch, model, sample=False, rng=None):
        return 0.5 * jnp.sum((model(batch["x"]) - batch["y"]) ** 2)

    def compute_measurement(self, batch, model):
        return self.compute_train_loss(batch, model)


def _tanh_mlp():
    """test_multihost.py's model, weights and data; the weights also as a
    torch state dict (flax kernels are (in, out))."""
    rng = np.random.default_rng(0)
    train = {"x": rng.standard_normal((MLP_N, 6)), "y": rng.standard_normal((MLP_N, 2))}
    query = {"x": rng.standard_normal((MLP_QUERIES, 6)),
             "y": rng.standard_normal((MLP_QUERIES, 2))}
    module = TanhMLP()
    params = module.init(jax.random.PRNGKey(0), jnp.asarray(train["x"][:1]))["params"]
    state_dict = {}
    for name in MLP_NAMES:
        state_dict[f"{name}.weight"] = torch.from_numpy(
            np.asarray(params[name]["kernel"]).T.copy())
        state_dict[f"{name}.bias"] = torch.from_numpy(np.asarray(params[name]["bias"]).copy())
    task = HalfSquaredErrorTask()
    return jax_prepare(module, task), params, task, train, query, state_dict


def _launch(workdir: Path, world: int):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    rendezvous = workdir / f"rendezvous_{world}"
    return [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(rendezvous), str(world), str(rank), str(workdir)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for rank in range(world)
    ]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("distributed")
    mlp_model, mlp_params, mlp_task, mlp_train, mlp_query, mlp_state = _tanh_mlp()
    gpt2_model, gpt2_params, gpt2_task, config = make_lm()
    gpt2_torch, _, _ = make_torch_lm(gpt2_params, config)
    gpt2_train = make_lm_data(GPT2_N, seq_len=config.max_seq_len, vocab=config.vocab_size, seed=0)
    gpt2_query = make_lm_data(GPT2_QUERIES, seq_len=config.max_seq_len,
                              vocab=config.vocab_size, seed=1)
    uneven_model, uneven_params, uneven_task = make_mlp()
    uneven_train = make_regression_data(UNEVEN_N, seed=0)
    sizes = {k: getattr(config, k) for k in
             ("vocab_size", "max_seq_len", "num_layers", "num_heads", "d_model", "d_mlp")}
    torch.save(dict(
        mlp=dict(state_dict=mlp_state, train=mlp_train, query=mlp_query),
        gpt2=dict(sizes=sizes, state_dict=gpt2_torch.module.state_dict(), train=gpt2_train,
                  query=gpt2_query),
        uneven=dict(state_dict=torch_mlp(uneven_params).state_dict(), train=uneven_train),
    ), workdir / "inputs.pt")

    procs = {(rank, world): p for world in (2, 1) for rank, p in enumerate(_launch(workdir, world))}
    # The JAX package's single-process results, while the ranks run.
    want = dict(
        mlp=jax_stages(mlp_model, mlp_params, mlp_task, mlp_train, mlp_query, MLP_BATCH,
                       MLP_BATCH),
        gpt2=jax_stages(gpt2_model, gpt2_params, gpt2_task, gpt2_train, gpt2_query, GPT2_BATCH,
                        GPT2_QUERY_BATCH),
        uneven=jax_fit_covariance(uneven_model, uneven_params, uneven_task,
                                  JaxBatchLoader(uneven_train, UNEVEN_BASE_BATCH),
                                  JaxFactorArguments(strategy="ekfac", **FP64_FACTOR)),
    )
    got = {}
    try:
        for key, proc in procs.items():
            out = proc.communicate(timeout=WORKER_TIMEOUT)[0].decode()
            assert proc.returncode == 0, f"rank {key[0]} of {key[1]} failed:\n{out[-4000:]}"
            got[key] = torch.load(workdir / f"rank{key[0]}_of{key[1]}.pt", weights_only=False)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return dict(want=want, got=got, workdir=workdir)


def _assert_factors_within(got, want, names, tol):
    """Covariances, eigenvalues, reconstructions and lambda within `tol`
    (rtol and atol), counts equal."""
    for name in names:
        for key in MATRICES:
            np.testing.assert_allclose(_np(got[key][name]), _np(want[key][name]), rtol=tol,
                                       atol=tol, err_msg=f"{key}/{name}")
        for key in COUNTS:
            assert int(_np(got[key][name]).reshape(-1)[0]) == int(
                _np(want[key][name]).reshape(-1)[0]), f"{key}/{name}"
        for vectors, values in EIGENPAIRS:
            np.testing.assert_allclose(
                _reconstruction(got[vectors][name], got[values][name]),
                _reconstruction(want[vectors][name], want[values][name]),
                rtol=tol, atol=tol, err_msg=f"{vectors}/{name}")


@pytest.mark.parametrize("rank", [0, 1])
def test_mlp_two_ranks_match_jax_single_process(run, rank):
    got, (factors, pairwise, self_) = run["got"][(rank, 2)]["mlp"], run["want"]["mlp"]
    _assert_factors_within(got["factors"], factors, MLP_NAMES, 1e-12)
    assert tuple(got["pairwise"].shape) == (MLP_QUERIES, MLP_N)
    np.testing.assert_allclose(_np(got["pairwise"]), pairwise, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(_np(got["self"]), self_, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("rank", [0, 1])
def test_gpt2_two_ranks_match_jax_single_process(run, rank):
    got, (factors, pairwise, self_) = run["got"][(rank, 2)]["gpt2"], run["want"]["gpt2"]
    assert_factors_match(got["factors"], factors, sorted(factors["activation_covariance"]))
    assert_scores_match(got["pairwise"], pairwise, (GPT2_QUERIES, GPT2_N))
    assert_scores_match(got["self"], self_, (GPT2_N,))


@pytest.mark.parametrize("rank", [0, 1])
def test_uneven_final_batch_matches_jax_single_process(run, rank):
    """Global batch 16 over 24 examples: rank 1's slice of the last batch is
    all padding, and adds nothing."""
    got, want = run["got"][(rank, 2)]["uneven"], run["want"]["uneven"]
    for factor_name in want:
        assert set(got[factor_name]) == set(UNEVEN_NAMES)
        for name in UNEVEN_NAMES:
            np.testing.assert_allclose(_np(got[factor_name][name]),
                                       _np(want[factor_name][name]), rtol=1e-9, atol=1e-11,
                                       err_msg=f"{factor_name}/{name}")


@pytest.mark.parametrize("scenario", ["mlp", "gpt2", "uneven"])
def test_ranks_hold_the_same_results(run, scenario):
    """Reduced factors and assembled scores are replicated bit for bit."""
    first, second = run["got"][(0, 2)][scenario], run["got"][(1, 2)][scenario]
    if scenario == "uneven":
        assert_bitwise(second, first)
        return
    assert_bitwise(second["factors"], first["factors"])
    assert torch.equal(second["pairwise"], first["pairwise"])
    assert torch.equal(second["self"], first["self"])


def test_world_of_one_is_the_no_mesh_path_bit_for_bit(run):
    one = run["got"][(0, 1)]
    assert one["backend"] == "gloo" and one["data"] == 1
    assert_bitwise(one["mlp"]["factors"], one["mlp_no_mesh"]["factors"])
    for key in ("pairwise", "self"):
        assert torch.equal(one["mlp"][key], one["mlp_no_mesh"][key])


@pytest.mark.parametrize("option", ["float8", "low_rank", "aggregate_query", "aggregate_train"])
def test_score_options_on_the_mesh_match_one_process(run, option):
    """On the tiny GPT-2's factors, float8 blocks (bytes and scales),
    randomized low-rank pairs (the sketch drawn for the global batch) and
    all-reduced aggregate sums give each rank the scores one process gives,
    within the parity tolerance."""
    for rank in (0, 1):
        meshed, alone = run["got"][(rank, 2)]["options"][option]
        assert meshed.shape == alone.shape
        np.testing.assert_allclose(_np(meshed), _np(alone), rtol=1.3e-6, atol=1e-5)
    assert torch.equal(run["got"][(0, 2)]["options"][option][0],
                       run["got"][(1, 2)]["options"][option][0])


@pytest.mark.parametrize("case,error", [
    ("batch_not_divisible", "ValueError"),
    ("model_axis", "NotImplementedError"),
    ("data_not_world", "ValueError"),
    ("loader_off_mesh", "ValueError"),
])
def test_refusals(run, case, error):
    for rank in (0, 1):
        assert run["got"][(rank, 2)]["refusals"][case] == error


def test_analyzer_rank_zero_alone_writes(run):
    root = str(run["workdir"] / "analyzer")
    written = run["got"][(0, 2)]["analyzer"]["writes"]
    assert run["got"][(1, 2)]["analyzer"]["writes"] == []
    for artifact in ("model.safetensors", "factor_arguments.json",
                     "activation_covariance.safetensors", "activation_eigenvectors.safetensors",
                     "lambda_matrix.safetensors", "pairwise_scores.safetensors",
                     "self_scores.safetensors"):
        assert any(path.startswith(root) and path.endswith(artifact) for path in written), (
            artifact, written)


@pytest.mark.parametrize("gate", ["main_only", "every_rank"])
def test_analyzer_ranks_load_equal_scores(run, gate):
    first, second = (run["got"][(rank, 2)]["analyzer"][gate] for rank in (0, 1))
    _, pairwise, self_ = run["want"]["mlp"]
    for key, want in (("pairwise", pairwise), ("self", self_)):
        assert torch.equal(first[key], second[key])
        np.testing.assert_allclose(_np(first[key]), want, rtol=1e-10, atol=1e-10)


def test_analyzer_logs_from_rank_one_only_when_asked(run):
    main_only = [run["got"][(rank, 2)]["analyzer"]["main_only"]["lines"] for rank in (0, 1)]
    every_rank = [run["got"][(rank, 2)]["analyzer"]["every_rank"]["lines"] for rank in (0, 1)]
    assert main_only[0] and main_only[1] == []
    assert every_rank[0] and every_rank[1]
    assert not any(line.startswith("[process") for line in every_rank[0])
    assert all(line.startswith("[process 1] ") for line in every_rank[1])
    assert len(every_rank[1]) == len(every_rank[0])
