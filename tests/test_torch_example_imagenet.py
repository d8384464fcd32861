"""The port's imagenet example (`kronfluence_tpu_torch/examples/imagenet/`)
against the JAX package's `examples/imagenet/`: the task on flax ResNet
weights carried over by `models/convert.py`, in fp64 at the parity harness's
tolerances; the synthetic data, bit for bit after NCHW -> NHWC; and each
script's `main()` on the CPU at the JAX smoke test's arguments (ResNet-9 at
32 x 32, 10 classes, rank-4 query blocks).

ResNet-9's widths are fixed, so every factor fit on the CPU pays two
4608-wide fp64 eighs (about 57 s on one thread). The three scripts fit the
same factors (the same seed-0 model, the same 16 training examples, EK-FAC):
analyze's fit is shared through a module fixture, and each other run finds
it in its own output directory, as a second run of a script would.
ddp_analyze runs as one process, equal bit for bit to analyze at the same
batches, and as two gloo ranks (subprocesses, a `file://` rendezvous), whose
scores equal each other and the one process's at the ranks' batch."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from threadpoolctl import threadpool_limits

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from examples.imagenet import pipeline as jax_pipeline  # noqa: E402
from kronfluence_tpu.models import resnet as flax_resnet  # noqa: E402
from kronfluence_tpu_torch.examples.common import sample_labels  # noqa: E402
from kronfluence_tpu_torch.examples.imagenet import (  # noqa: E402
    analyze,
    ddp_analyze,
    pipeline,
    query_batching_analysis,
)
from kronfluence_tpu_torch.models import resnet  # noqa: E402
from tests.testable_tasks.torch_classification import fp64_variables, load_flax  # noqa: E402

RTOL, ATOL = 1.3e-6, 1e-5
WORKER = REPO / "tests" / "testable_tasks" / "torch_example_ddp_worker.py"
WORKER_TIMEOUT = 240
# The two ranks' fp32 scores against one process's, of max|score|: the
# per-example gradients are the same, but each rank's query rows are one
# shard of a global batch twice the size (measured 1.6e-6 to 2.1e-6; the
# scores span eight decades, so an elementwise rtol would hold the smallest
# to fp32 noise of the largest).
RANKS_RTOL = 1e-5
SMALL = ["--arch", "resnet9", "--num_train", "16", "--num_query", "4", "--image_size", "32",
         "--num_classes", "10", "--query_gradient_low_rank", "4", "--cpu"]
ANALYZE = SMALL + ["--train_batch_size", "8", "--query_batch_size", "4"]
QUERY_BATCHING = SMALL + ["--per_device_batch_size", "4"]
DDP = SMALL + ["--per_device_batch_size", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread and one BLAS thread: these tests run many small ops
    and host eighs beside the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def test_task_matches_jax():
    """The imagenet pipeline's task (CIFAR's) against the JAX imagenet
    pipeline's own on a two-stage bottleneck ResNet with drawn BatchNorm
    statistics: loss and margin measurement, and the sampled loss on the
    port's draw against JAX's cross-entropy of the same labels."""
    flax_module = flax_resnet.ResNet(stage_sizes=(1, 1), num_classes=10, dtype=jnp.float64)
    variables = fp64_variables(flax_module, 16, seed=0)
    tmodel = load_flax(resnet.ResNet((1, 1), 10, dtype=torch.float64), variables).eval()
    data = jax_pipeline.synthetic_imagenet(4, 16, 10, seed=5)
    jtask, ttask = jax_pipeline.ClassificationTask(), pipeline.ClassificationTask()

    def bound(x):
        return flax_module.apply(variables, x)

    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    tbatch = {"x": torch.from_numpy(np.ascontiguousarray(data["x"].transpose(0, 3, 1, 2))),
              "y": torch.from_numpy(data["y"])}
    with torch.no_grad():
        for name in ("compute_train_loss", "compute_measurement"):
            want = float(getattr(jtask, name)(jbatch, bound))
            got = float(getattr(ttask, name)(tbatch, tmodel))
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)
        got = float(ttask.compute_train_loss(tbatch, tmodel, True, torch.Generator().manual_seed(4)))
        labels = sample_labels(tmodel(tbatch["x"].double()),
                               torch.Generator().manual_seed(4)).numpy()
    want = float(jnp.sum(optax.softmax_cross_entropy_with_integer_labels(
        bound(jbatch["x"]), jnp.asarray(labels))))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg="sampled loss")
    assert ttask.get_influence_tracked_modules() is jtask.get_influence_tracked_modules() is None


@pytest.mark.parametrize("split,num,size,classes,seed", [("train", 6, 16, 1000, 0),
                                                         ("valid", 3, 8, 10, 1)])
def test_synthetic_data_matches_jax(split, num, size, classes, seed):
    got = pipeline.get_imagenet_dataset(split, num, size, classes, seed)
    want = jax_pipeline.get_imagenet_dataset(split, num, size, classes, seed)
    assert got["x"].shape == (num, 3, size, size) and got["x"].flags.c_contiguous
    np.testing.assert_array_equal(got["x"].transpose(0, 2, 3, 1), want["x"])
    np.testing.assert_array_equal(got["y"], want["y"])
    np.testing.assert_array_equal(pipeline.synthetic_imagenet(num, size, classes, seed)["x"],
                                  got["x"])


def test_construct_resnet():
    """The architectures, seeded weights (init's zero bn3 scale redrawn) and
    the prepared model in eval mode."""
    model, task = pipeline.construct_resnet("resnet50", 7, seed=3, device="cpu")
    again, _ = pipeline.construct_resnet("resnet50", 7, seed=3, device="cpu")
    assert isinstance(task, pipeline.ClassificationTask) and not model.module.training
    assert model.module.classifier.out_features == 7
    assert float(model.module.stage0_block0.bn3.weight.abs().min()) > 0.5
    assert all(torch.equal(a, b) for a, b in zip(model.module.state_dict().values(),
                                                  again.module.state_dict().values()))
    small, _ = pipeline.construct_resnet("resnet9", 10, device="cpu")
    assert isinstance(small.module, resnet.ResNet9) and len(small.tracked_modules()) == 9


def _with_factors(root: Path, dest: Path, analysis_name: str) -> Path:
    """`dest` holding analyze's fit as `analysis_name`'s ekfac factors."""
    shutil.copytree(root / "analyze" / "imagenet" / "factors_ekfac",
                    dest / analysis_name / "factors_ekfac")
    return dest


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """analyze's run: the fit the other scripts find, and its scores."""
    root = tmp_path_factory.mktemp("imagenet")
    _, scores = analyze.main(ANALYZE + ["--output_dir", str(root / "analyze")])
    return root, scores


def test_analyze(fitted):
    _, scores = fitted
    assert tuple(scores.shape) == (4, 16) and bool(torch.isfinite(scores).all())


def test_query_batching_analysis(fitted):
    root, _ = fitted
    out = _with_factors(root, root / "query_batching", "imagenet_qb")
    spearman, pearson = query_batching_analysis.main(QUERY_BATCHING + ["--output_dir", str(out)])
    assert -1.0 <= spearman <= 1.0 and -1.0 <= pearson <= 1.0
    assert (out / "imagenet_qb" / "scores_full_rank").is_dir()
    assert (out / "imagenet_qb" / "scores_qlr4").is_dir()


@pytest.fixture(scope="module")
def one_process(fitted):
    """ddp_analyze as one process (no group: a mesh of one)."""
    root, _ = fitted
    out = _with_factors(root, root / "ddp_one", "imagenet")
    return ddp_analyze.main(DDP + ["--output_dir", str(out)])[1]


def test_ddp_analyze_alone_equals_analyze(fitted, one_process):
    """One process on a mesh of one, bit for bit analyze's scores at the
    same batches (2 train and 4 query examples) and factors."""
    root, _ = fitted
    out = _with_factors(root, root / "analyze_b2", "imagenet")
    _, want = analyze.main(SMALL + ["--train_batch_size", "2", "--query_batch_size", "4",
                                    "--output_dir", str(out)])
    assert tuple(one_process.shape) == (4, 16) and torch.equal(one_process, want)


def test_ddp_analyze_on_two_gloo_ranks(fitted, one_process):
    """Two gloo ranks, each 2 rows of every global train batch of 4 and 4 of
    every query batch of 8 (the second rank's all padding): both return the
    whole score matrix, equal bit for bit to each other's and within
    RANKS_RTOL of one process's at the ranks' batch."""
    root, _ = fitted
    out = _with_factors(root, root / "ddp_two", "imagenet")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(root / "rendezvous"), "2", str(rank), str(root)]
        + DDP + ["--output_dir", str(out)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(2)]
    logs = []
    for proc in procs:
        try:
            logs.append(proc.communicate(timeout=WORKER_TIMEOUT)[0].decode())
        finally:
            proc.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    assert "mesh: data 2, rank 1, gloo, cpu" in logs[1]
    ranks = [torch.load(root / f"scores_{rank}.pt") for rank in range(2)]
    assert torch.equal(ranks[0], ranks[1])
    gap = float((ranks[0] - one_process).abs().max() / one_process.abs().max())
    assert gap <= RANKS_RTOL, gap
    assert (out / "imagenet" / "scores_pairwise_qb").is_dir()
