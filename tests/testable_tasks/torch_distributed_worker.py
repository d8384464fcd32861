"""One rank of the port's multi-process CPU tests (tests/test_torch_distributed.py).

Run as: python torch_distributed_worker.py <rendezvous file> <world size> <rank> <workdir>

Joins a gloo group through the `file://` rendezvous, pins torch to one
thread, and runs every scenario of the test on a data mesh, on the weights
and data the test wrote to `<workdir>/inputs.pt`:

  * "mlp": test_multihost.py's fp64 tanh MLP through covariance,
    eigendecomposition, lambda and pairwise and self scores;
  * "gpt2": the tiny GPT-2 of the parity tests through the same stages;
  * "uneven": test_sharding.py's uneven final batch (a global batch of 16
    over 24 examples: one rank's slice of the last batch is all padding);
  * "options": the gpt2's pairwise scores with float8 query blocks,
    randomized low-rank blocks (its sketch narrower than the blocks) and
    aggregated query or train gradients, on the mesh and, in the same rank,
    without one;
  * with two ranks, the refusals (a batch that does not split over the
    ranks, `make_mesh(model=2)`, a `data` that is not the world size, a
    loader off the stage's mesh) and the Analyzer: which rank opens files
    for writing under its output directory, what each rank loads, and
    what each rank logs;
  * with one rank, "mlp" again without a mesh, for a bitwise comparison.

Each rank writes what it computed to `<workdir>/rank<r>_of<n>.pt`.
"""

import datetime
import logging
import os
import sys
from pathlib import Path

import torch
from torch import nn

from kronfluence_tpu_torch import Analyzer, Task, prepare_model
from kronfluence_tpu_torch.arguments import FactorArguments
from kronfluence_tpu_torch.factor.covariance import fit_covariance_matrices_with_loader
from kronfluence_tpu_torch.factor.eigen import (
    fit_lambda_matrices_with_loader,
    perform_eigendecomposition,
)
from kronfluence_tpu_torch.models.mlp import MLP
from kronfluence_tpu_torch.models.transformer import TransformerLM, tiny_config
from kronfluence_tpu_torch.parallel import distributed
from kronfluence_tpu_torch.parallel.mesh import make_mesh
from kronfluence_tpu_torch.score.pairwise import compute_pairwise_scores_with_loaders
from kronfluence_tpu_torch.score.self_scores import compute_self_scores_with_loaders
from kronfluence_tpu_torch.utils.common.factor_arguments import pytest_factor_arguments
from kronfluence_tpu_torch.utils.common.score_arguments import pytest_score_arguments
from kronfluence_tpu_torch.utils.constants import ALL_MODULE_NAME
from kronfluence_tpu_torch.utils.dataset import BatchLoader

from tests.testable_tasks.torch_language_modeling import TorchLanguageModelingTask
from tests.testable_tasks.torch_regression import TorchRegressionTask

# Global batches; each rank takes its half of every one.
MLP_BATCH, GPT2_BATCH, GPT2_QUERY_BATCH, UNEVEN_BATCH = 8, 4, 2, 16
# test_sharding.py's fp64 recipe for the uneven-batch covariance.
FP64_FACTOR = dict(
    use_empirical_fisher=True,
    activation_covariance_dtype="float64",
    gradient_covariance_dtype="float64",
    per_sample_gradient_dtype="float64",
    lambda_dtype="float64",
)
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)


class TanhMLP(nn.Module):
    """test_multihost.py's flax MLP: Dense(8) -> tanh -> Dense(2), fp64."""

    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(6, 8, dtype=torch.float64)
        self.fc2 = nn.Linear(8, 2, dtype=torch.float64)

    def forward(self, x):
        return self.fc2(torch.tanh(self.fc1(x)))


class HalfSquaredErrorTask(Task):
    """test_multihost.py's RegressionTask: 0.5 x the summed squared error,
    which is also the measurement."""

    def compute_train_loss(self, batch, model, sample=False, generator=None):
        return 0.5 * torch.sum((model(batch["x"]) - batch["y"]) ** 2)

    def compute_measurement(self, batch, model):
        return self.compute_train_loss(batch, model)


def stages(model, task, train, query, batch, query_batch, mesh):
    """Every stage on `mesh` (None: one process): factors, scores."""
    fargs, sargs = pytest_factor_arguments("ekfac"), pytest_score_arguments()

    def loader(data, size):
        return BatchLoader(data, size, device="cpu", mesh=mesh)

    cov = fit_covariance_matrices_with_loader(model, task, loader(train, batch), fargs,
                                              mesh=mesh)
    eig = perform_eigendecomposition(cov, fargs)
    lam = fit_lambda_matrices_with_loader(model, task, loader(train, batch), fargs,
                                          eigen_factors=eig, mesh=mesh)
    factors = {**cov, **eig, **lam}
    pair = compute_pairwise_scores_with_loaders(
        model, task, loader(query, query_batch), loader(train, batch), factors, fargs, sargs,
        mesh=mesh)
    self_ = compute_self_scores_with_loaders(model, task, loader(train, batch), factors, fargs,
                                             sargs, mesh=mesh)
    return dict(factors=factors, pairwise=pair[ALL_MODULE_NAME], self=self_[ALL_MODULE_NAME])


# Score options whose blocks or sums cross the ranks differently from dense
# blocks: float8 payloads and scales, low-rank pairs, all-reduced sums.
SCORE_OPTIONS = {
    "float8": dict(query_gradient_storage_dtype="float8_e4m3fn"),
    "low_rank": dict(query_gradient_low_rank=4),
    "aggregate_query": dict(aggregate_query_gradients=True),
    "aggregate_train": dict(aggregate_train_gradients=True),
}


def score_options(model, task, train, query, factors, mesh) -> dict:
    """{option: (scores on the mesh, scores without one)} for the gpt2."""
    fargs = pytest_factor_arguments("ekfac")
    out = {}
    for name, fields in SCORE_OPTIONS.items():
        sargs = pytest_score_arguments()
        for key, value in fields.items():
            setattr(sargs, key, value)
        pair = [compute_pairwise_scores_with_loaders(
            model, task, BatchLoader(query, GPT2_QUERY_BATCH, device="cpu", mesh=m),
            BatchLoader(train, GPT2_BATCH, device="cpu", mesh=m), factors, fargs, sargs,
            mesh=m)[ALL_MODULE_NAME] for m in (mesh, None)]
        out[name] = tuple(pair)
    return out


def refusals(mesh, data) -> dict:
    """The type of what each misuse raised (None when it did not raise)."""
    cases = {
        "batch_not_divisible": lambda: BatchLoader(data, 7, device="cpu", mesh=mesh),
        "model_axis": lambda: make_mesh(model=2, device="cpu"),
        "data_not_world": lambda: make_mesh(data=3, device="cpu"),
        "loader_off_mesh": lambda: fit_covariance_matrices_with_loader(
            prepare_model(TanhMLP(), HalfSquaredErrorTask()), HalfSquaredErrorTask(),
            BatchLoader(data, 8, device="cpu"), pytest_factor_arguments("ekfac"), mesh=mesh),
    }
    raised = {}
    for name, case in cases.items():
        try:
            case()
            raised[name] = None
        except Exception as exc:  # the test reads which exception each case raised
            raised[name] = type(exc).__name__
    return raised


class Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def analyzer_run(module, train, query, mesh, root: Path) -> dict:
    """The Analyzer on the mesh: files this rank opens for writing under
    `root`, the scores it loads, and its log lines, main process only and
    then from every process (a rerun, which skips each stage)."""
    writes = []

    def audit(event, args):
        if event != "open" or not isinstance(args[0], (str, Path)):
            return
        path, mode, flags = args
        if isinstance(mode, str):
            writing = any(c in mode for c in "wax+")
        else:  # os.open: flags, no mode string
            writing = bool(flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT))
        if writing and str(path).startswith(str(root)):
            writes.append(str(path))

    sys.addaudithook(audit)
    records = Records()
    logging.getLogger("Analyzer").addHandler(records)
    logging.getLogger("Analyzer").setLevel(logging.INFO)
    task = HalfSquaredErrorTask()
    fargs, sargs = pytest_factor_arguments("ekfac"), pytest_score_arguments()
    runs = {}
    for gate in (True, False):
        start = len(records.lines)
        analyzer = Analyzer("dist", prepare_model(module, task), task, mesh=mesh,
                            log_main_process_only=gate, output_dir=str(root),
                            disable_model_save=False)
        analyzer.fit_all_factors("f", train, per_device_batch_size=MLP_BATCH // mesh.data,
                                 factor_args=fargs)
        analyzer.compute_pairwise_scores("p", "f", query, train,
                                         per_device_query_batch_size=MLP_BATCH // mesh.data,
                                         per_device_train_batch_size=MLP_BATCH // mesh.data,
                                         score_args=sargs)
        analyzer.compute_self_scores("s", "f", train,
                                     per_device_train_batch_size=MLP_BATCH // mesh.data,
                                     score_args=sargs)
        runs[gate] = dict(lines=records.lines[start:],
                          pairwise=analyzer.load_pairwise_scores("p")[ALL_MODULE_NAME],
                          self=analyzer.load_self_scores("s")[ALL_MODULE_NAME])
    return dict(writes=sorted(set(writes)), main_only=runs[True], every_rank=runs[False])


def main() -> None:
    rendezvous, world, rank, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(
        sys.argv[4])
    torch.set_num_threads(1)
    distributed.initialize("gloo", init_method=f"file://{rendezvous}", world_size=world,
                           rank=rank, timeout=COLLECTIVE_TIMEOUT)
    mesh = make_mesh(device="cpu")
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    out = {"backend": mesh.backend, "data": mesh.data, "rank": mesh.rank}

    mlp = TanhMLP()
    mlp.load_state_dict(inputs["mlp"]["state_dict"])
    mlp_task = HalfSquaredErrorTask()
    mlp_args = (prepare_model(mlp, mlp_task), mlp_task, inputs["mlp"]["train"],
                inputs["mlp"]["query"], MLP_BATCH, MLP_BATCH)
    out["mlp"] = stages(*mlp_args, mesh)

    if world == 1:
        out["mlp_no_mesh"] = stages(*mlp_args, None)
    else:
        gpt2 = TransformerLM(tiny_config(**inputs["gpt2"]["sizes"], dtype=torch.float64))
        gpt2.load_state_dict(inputs["gpt2"]["state_dict"])
        lm_task = TorchLanguageModelingTask()
        gpt2_args = (prepare_model(gpt2, lm_task), lm_task, inputs["gpt2"]["train"],
                     inputs["gpt2"]["query"])
        out["gpt2"] = stages(*gpt2_args, GPT2_BATCH, GPT2_QUERY_BATCH, mesh)
        out["options"] = score_options(*gpt2_args, out["gpt2"]["factors"], mesh)

        regression = MLP(8, hidden_dims=(16, 12), out_dim=1, dtype=torch.float64)
        regression.load_state_dict(inputs["uneven"]["state_dict"])
        out["uneven"] = fit_covariance_matrices_with_loader(
            prepare_model(regression, TorchRegressionTask()), TorchRegressionTask(),
            BatchLoader(inputs["uneven"]["train"], UNEVEN_BATCH, device="cpu", mesh=mesh),
            FactorArguments(strategy="ekfac", **FP64_FACTOR), mesh=mesh)

        out["refusals"] = refusals(mesh, inputs["mlp"]["train"])
        out["analyzer"] = analyzer_run(mlp, inputs["mlp"]["train"], inputs["mlp"]["query"],
                                       mesh, workdir / "analyzer")
    torch.save(out, workdir / f"rank{rank}_of{world}.pt")
    distributed.sync_global_devices("saved")
    distributed.shutdown()
    print(f"rank {rank} of {world}: OK", flush=True)


if __name__ == "__main__":
    main()
