"""The port's cifar example (`kronfluence_tpu_torch/examples/cifar/`) against
the JAX package's `examples/cifar/`: the task's loss, sampled loss and
measurement on flax ResNet-9 weights carried over by `models/convert.py`, in
fp64 at the parity harness's tolerances; the synthetic data, bit for bit
after NCHW -> NHWC; one `train_resnet9` step in fp64 against the JAX
pipeline's own `train_step` (parameters, running means and running
variances: BatchNorm in training mode updates its running variance with the
biased batch variance, as flax's does); and each script's `main()` on the
CPU at the JAX smoke test's arguments.

ResNet-9's widths are fixed, so every factor fit on the CPU pays two
4608-wide fp64 eighs (about 57 s on one thread), and every self score about
1.9 s an example (res2's per-example gradients preconditioned at 512 x 4608).
So the scripts run on 16 examples in one batch (the JAX smoke takes 48 in
batches of 16, 32 for half_precision_analysis), and one fit and one self
pass, detect_mislabeled_dataset's, are shared through a module fixture:
inspect_factors reads them, and half_precision_analysis, on the same data
and trained model, finds them as its fp32 pass's factors and scores (what
it would compute), so that only its bf16 pass runs."""

import shutil
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

from examples.cifar import pipeline as jax_pipeline  # noqa: E402
from kronfluence_tpu.models import resnet as flax_resnet  # noqa: E402
from kronfluence_tpu_torch.examples.cifar import (  # noqa: E402
    detect_mislabeled_dataset,
    half_precision_analysis,
    inspect_factors,
    pipeline,
    train,
)
from kronfluence_tpu_torch.examples.common import sample_labels  # noqa: E402
from kronfluence_tpu_torch.models import resnet  # noqa: E402
from kronfluence_tpu_torch.models.convert import state_dict_from_flax  # noqa: E402
from kronfluence_tpu_torch.prepare import prepare_model  # noqa: E402
from kronfluence_tpu_torch.utils.save import load_file  # noqa: E402
from tests.testable_tasks.torch_classification import fp64_variables, load_flax  # noqa: E402

RTOL, ATOL = 1.3e-6, 1e-5
DETECT = ["--num_train", "16", "--batch_size", "16", "--epochs", "1", "--cpu"]


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
    """Loss and margin measurement to the parity tolerances, the sampled loss
    on the port's draw against JAX's cross-entropy of the same labels, and
    the same tracked modules (every one)."""
    flax_module = flax_resnet.ResNet9(num_classes=10, dtype=jnp.float64)
    variables = fp64_variables(flax_module, 8, seed=1)
    tmodel = load_flax(resnet.ResNet9(10, dtype=torch.float64), variables).eval()
    data, _ = jax_pipeline.synthetic_cifar(4, corrupt_frac=0.5, seed=5)

    def bound(x):
        return flax_module.apply(variables, x)

    jtask, ttask = jax_pipeline.ClassificationTask(), pipeline.ClassificationTask()
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    tbatch = {"x": torch.from_numpy(np.ascontiguousarray(data["x"].transpose(0, 3, 1, 2))),
              "y": torch.from_numpy(data["y"])}
    with torch.no_grad():
        for name in ("compute_train_loss", "compute_measurement"):
            want = float(getattr(jtask, name)(jbatch, bound))
            got = float(getattr(ttask, name)(tbatch, tmodel))
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)
        got = float(ttask.compute_train_loss(tbatch, tmodel, True, torch.Generator().manual_seed(3)))
        labels = sample_labels(tmodel(tbatch["x"].double()), torch.Generator().manual_seed(3)).numpy()
    want = float(jnp.sum(optax.softmax_cross_entropy_with_integer_labels(
        bound(jbatch["x"]), jnp.asarray(labels))))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg="sampled loss")
    assert ttask.get_influence_tracked_modules() == jtask.get_influence_tracked_modules() is None


@pytest.mark.parametrize("corrupt_frac", [0.0, 0.1])
def test_synthetic_data_matches_jax(corrupt_frac):
    got, got_idx = pipeline.get_cifar10_dataset("train", 40, corrupt_frac=corrupt_frac, seed=2)
    want, want_idx = jax_pipeline.get_cifar10_dataset("train", 40, corrupt_frac=corrupt_frac,
                                                      seed=2)
    assert got["x"].shape == (40, 3, 32, 32) and got["x"].flags.c_contiguous
    np.testing.assert_array_equal(got["x"].transpose(0, 2, 3, 1), want["x"])
    np.testing.assert_array_equal(got["y"], want["y"])
    np.testing.assert_array_equal(got_idx, want_idx)
    assert len(got_idx) == int(40 * corrupt_frac)


def test_train_step_matches_jax(monkeypatch):
    """One AdamW step of `train_resnet9` (one epoch of one batch), both
    pipelines starting from the same fp64 flax variables: every parameter,
    running mean and running variance after the step. With torch's own
    BatchNorm update (the unbiased batch variance) the running variances
    miss by n / (n - 1): at res2, 4 examples on 4 x 4 maps, n = 64."""
    batch = 4
    flax_module = flax_resnet.ResNet9(num_classes=10, dtype=jnp.float64)
    variables = fp64_variables(flax_module, 8, seed=0, stats=False)
    data, _ = jax_pipeline.synthetic_cifar(batch, seed=3)
    monkeypatch.setattr(
        jax_pipeline, "construct_resnet9",
        lambda num_classes=10, seed=0: (flax_module, jax.tree_util.tree_map(jnp.asarray, variables)))
    want, _, _ = jax_pipeline.train_resnet9(data, epochs=1, batch_size=batch, verbose=False)

    start = load_flax(resnet.ResNet9(10, dtype=torch.float64), variables)
    monkeypatch.setattr(pipeline, "construct_resnet9",
                        lambda num_classes=10, seed=0, device=None: start)
    got, model, _ = pipeline.train_resnet9(pipeline.synthetic_cifar(batch, seed=3)[0], epochs=1,
                                           batch_size=batch, verbose=False, device="cpu")
    assert got is model.module and not got.training
    assert not any(p.requires_grad for p in got.parameters())
    expected = state_dict_from_flax(jax.device_get(want), resnet.ResNet9(10, dtype=torch.float64))
    for key, tensor in got.state_dict().items():
        if key.endswith("num_batches_tracked"):
            assert int(tensor) == 1, key
            continue
        np.testing.assert_allclose(tensor.numpy(), expected[key].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=key)


def test_batch_norm_matches_torch_but_for_the_running_variance():
    """In eval mode the port's BatchNorm is `nn.BatchNorm2d` bit for bit; in
    training mode its output and running mean are too, and its running
    variance moves by the biased batch variance, not the unbiased one."""
    x = torch.randn(2, 3, 4, 4, generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    ours = resnet.BatchNorm2d(3, eps=1e-5, momentum=0.01, dtype=torch.float64)
    plain = torch.nn.BatchNorm2d(3, eps=1e-5, momentum=0.01, dtype=torch.float64)
    for bn in (ours, plain):
        with torch.no_grad():
            bn.weight.normal_(1.0, 0.1, generator=torch.Generator().manual_seed(1))
            bn.running_var.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(2))
    start = ours.running_var.clone()
    assert torch.equal(ours.eval()(x), plain.eval()(x))
    torch.testing.assert_close(ours.train()(x), plain.train()(x), rtol=1e-12, atol=1e-14)
    torch.testing.assert_close(ours.running_mean, plain.running_mean, rtol=1e-12, atol=1e-16)
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(ours.running_var, 0.99 * start + 0.01 * biased,
                               rtol=1e-12, atol=0.0)
    assert not torch.allclose(plain.running_var, 0.99 * start + 0.01 * biased, rtol=1e-4, atol=0)
    assert int(ours.num_batches_tracked) == int(plain.num_batches_tracked) == 1


@pytest.fixture(scope="module")
def detected(tmp_path_factory):
    """detect_mislabeled_dataset's run (train, one fit, self scores)."""
    root = tmp_path_factory.mktemp("cifar")
    return root, detect_mislabeled_dataset.main(DETECT + ["--output_dir", str(root)])


def test_detect_mislabeled_dataset(detected):
    _, (analyzer, scores, recalls) = detected
    assert tuple(scores.shape) == (16,) and bool(torch.isfinite(scores).all())
    assert set(recalls) == {0.1, 0.2} and all(0.0 <= r <= 1.0 for r in recalls.values())
    assert analyzer.profiler.summary()


def test_inspect_factors_reads_detect(detected):
    root, _ = detected
    summaries = inspect_factors.main(["--factors_name", "ekfac", "--output_dir", str(root),
                                      "--cpu"])
    assert set(summaries) == set(prepare_model(resnet.ResNet9(10)).tracked_modules())
    assert summaries["res2/block_1/conv"]["activation"]["dim"] == 512 * 9
    assert summaries["classifier"]["lambda"]["dim"] == 10 * 513
    one = inspect_factors.main(["--module", "layer3/conv", "--output_dir", str(root)])
    assert list(one) == ["layer3/conv"] and one["layer3/conv"] == summaries["layer3/conv"]


def test_half_precision_analysis(detected):
    root, _ = detected
    out = root / "half"
    shutil.copytree(root / "cifar" / "factors_ekfac", out / "cifar_half" / "factors_fp32")
    shutil.copytree(root / "cifar" / "scores_self", out / "cifar_half" / "scores_fp32")
    results = half_precision_analysis.main(DETECT + ["--output_dir", str(out)])
    assert set(results) == {"pearson", "spearman", "top10_overlap"}
    assert results["pearson"] > 0.5 and 0.0 <= results["top10_overlap"] <= 1.0


def test_train_writes_the_checkpoint(tmp_path):
    module, corrupt_idx = train.main(["--num_train", "48", "--epochs", "1", "--batch_size", "16",
                                      "--corrupt_frac", "0.25", "--cpu",
                                      "--checkpoint_dir", str(tmp_path)])
    loaded = resnet.ResNet9(10)
    loaded.load_state_dict(load_file(tmp_path / "model.safetensors"))
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in module.state_dict().items())
    np.testing.assert_array_equal(np.load(tmp_path / "corrupt_idx.npy"), corrupt_idx)
    assert len(corrupt_idx) == 12 and not module.training
