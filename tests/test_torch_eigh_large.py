"""The per-matrix eigendecomposition of large factors (`ops/eigh.py:eigh_large`,
`factor/eigen.py:_large_group_eigendecomposition`) against the JAX package's,
with the large-dimension threshold lowered so that small matrices take the
path: results, the never-stacked protocol, the checkpoints in the JAX
package's names (each package reads the other's), resume, and the scratch
directory's removal by the FactorComputer."""

import weakref

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from kronfluence_tpu.factor import eigen as jax_eigen
from kronfluence_tpu.utils.save import load_file as jax_load_file
from kronfluence_tpu_torch import Analyzer
from kronfluence_tpu_torch.factor import eigen as eigen_mod
from kronfluence_tpu_torch.models.llama import init_llama, tiny_llama_config
from kronfluence_tpu_torch.ops import eigh as eigh_mod
from kronfluence_tpu_torch.prepare import prepare_model
from kronfluence_tpu_torch.utils.common.factor_arguments import (
    extreme_reduce_memory_factor_arguments,
)
from kronfluence_tpu_torch.utils.constants import (
    ACTIVATION_COVARIANCE_MATRIX_NAME,
    ACTIVATION_EIGENVALUES_NAME,
    ACTIVATION_EIGENVECTORS_NAME,
    GRADIENT_COVARIANCE_MATRIX_NAME,
    GRADIENT_EIGENVALUES_NAME,
    GRADIENT_EIGENVECTORS_NAME,
    NUM_ACTIVATION_COVARIANCE_PROCESSED,
    NUM_GRADIENT_COVARIANCE_PROCESSED,
)
from kronfluence_tpu_torch.utils.save import load_file, save_file

from tests.test_torch_llama import OpenWebTextTask

LARGE = 48
# Dims per module (activation, gradient): "big" and "layers_0/mlp/down_proj"
# have factors at or above LARGE, "small" has none.
DIMS = {"big": (64, 24), "layers_0/mlp/down_proj": (56, 48), "small": (16, 12)}
# fp32 solves of 64-dim matrices against fp64 LAPACK: eigenvalues and
# reconstructions within a few hundred fp32 ulps of the largest eigenvalue.
FP32_RTOL = 1e-5
EIGEN_NAMES = (ACTIVATION_EIGENVECTORS_NAME, ACTIVATION_EIGENVALUES_NAME,
               GRADIENT_EIGENVECTORS_NAME, GRADIENT_EIGENVALUES_NAME)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread for numpy's host eigh: OpenBLAS's thread team spins
    against the suite's other workers (tests/test_torch_analyzer_release.py)."""
    with threadpool_limits(limits=1):
        yield


@pytest.fixture(autouse=True)
def _threshold(monkeypatch):
    monkeypatch.setattr(eigen_mod, "LARGE_EIGH_DIM", LARGE)
    monkeypatch.setattr("kronfluence_tpu.ops.eigh.LARGE_EIGH_DIM", LARGE)
    monkeypatch.setenv("KF_LARGE_EIGH_SOLVER", "host")


def _covariances(seed=3):
    """fp32 covariance sums (count 2) with a spread spectrum, per module."""
    rng = np.random.default_rng(seed)
    cov = {ACTIVATION_COVARIANCE_MATRIX_NAME: {}, NUM_ACTIVATION_COVARIANCE_PROCESSED: {},
           GRADIENT_COVARIANCE_MATRIX_NAME: {}, NUM_GRADIENT_COVARIANCE_PROCESSED: {}}
    for name, dims in DIMS.items():
        for key, count_key, d in (
            (ACTIVATION_COVARIANCE_MATRIX_NAME, NUM_ACTIVATION_COVARIANCE_PROCESSED, dims[0]),
            (GRADIENT_COVARIANCE_MATRIX_NAME, NUM_GRADIENT_COVARIANCE_PROCESSED, dims[1]),
        ):
            a = rng.standard_normal((d, 2 * d)) * np.linspace(0.1, 3.0, d)[:, None]
            cov[key][name] = (a @ a.T / d).astype(np.float32)
            cov[count_key][name] = np.array(2, dtype=np.int64)
    return cov


def _torch(cov):
    return {k: {n: torch.from_numpy(np.array(v)) for n, v in d.items()} for k, d in cov.items()}


def _empty():
    return {name: {} for name in EIGEN_NAMES}


def _entries(cov):
    entries = []
    for dim, keys in eigen_mod._dim_groups(cov).items():
        if dim >= LARGE:
            entries.extend((key, dim) for key in keys)
    return entries


def _count_solves(monkeypatch):
    calls = []
    real = torch.linalg.eigh

    def eigh(matrix, *args, **kwargs):
        calls.append(tuple(matrix.shape))
        return real(matrix, *args, **kwargs)

    monkeypatch.setattr(torch.linalg, "eigh", eigh)
    return calls


def _normalized64(cov, key, count_key, name):
    m = np.asarray(cov[key][name], np.float64) / float(cov[count_key][name])
    return 0.5 * (m + m.T)


def _check_against_lapack(cov, eigen, names):
    for key, count_key, vec_name, val_name in eigen_mod._FACTOR_PAIRS:
        for name in names:
            if name not in eigen[val_name]:
                continue
            m = _normalized64(cov, key, count_key, name)
            scale = np.abs(np.linalg.eigvalsh(m)).max()
            ev = np.asarray(eigen[val_name][name], np.float64)
            vec = np.asarray(eigen[vec_name][name], np.float64)
            np.testing.assert_allclose(ev, np.linalg.eigvalsh(m), rtol=0, atol=FP32_RTOL * scale)
            np.testing.assert_allclose((vec * ev) @ vec.T, m, rtol=0, atol=FP32_RTOL * scale)


def test_large_group_matches_jax_and_lapack():
    cov = _covariances()
    entries = _entries(_torch(cov))
    assert sorted(d for _, d in entries) == [48, 56, 64]
    want, got = _empty(), _empty()
    jax_eigen._large_group_eigendecomposition(cov, want, entries)
    eigen_mod._large_group_eigendecomposition(_torch(cov), got, entries)
    solved = {name for (_, name), _ in entries}
    for eigen in (want, got):
        _check_against_lapack(cov, {k: {n: np.asarray(v) for n, v in d.items()}
                                    for k, d in eigen.items()}, solved)
    for _key, _count_key, vec_name, val_name in eigen_mod._FACTOR_PAIRS:
        for name, w in want[val_name].items():
            scale = np.abs(np.asarray(w)).max()
            g, gv = got[val_name][name], got[vec_name][name]
            assert g.dtype == gv.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=FP32_RTOL * scale)
            wv = np.asarray(want[vec_name][name], np.float64)
            np.testing.assert_allclose(
                (gv.double().numpy() * g.double().numpy()) @ gv.double().numpy().T,
                (wv * np.asarray(w, np.float64)) @ wv.T, rtol=0, atol=FP32_RTOL * scale,
            )


def test_device_path_never_stacks_a_large_group(monkeypatch):
    """"auto" sends the groups at or above LARGE through eigh_large one matrix
    at a time: no large factor reaches torch.stack, and the small ones are
    solved batched."""
    real_stack = torch.stack
    stacked = []

    def guarded(tensors, *args, **kwargs):
        tensors = list(tensors)
        for t in tensors:
            assert t.ndim < 2 or t.shape[-1] < LARGE, f"a {tuple(t.shape)} factor was stacked"
        stacked.append(len(tensors))
        return real_stack(tensors, *args, **kwargs)

    monkeypatch.setattr(torch, "stack", guarded)
    built = []
    real_large = eigen_mod.eigh_large

    def spy(matrices, on_result, solve=None):
        built.append(len(matrices))
        assert solve is None  # cuSOLVER
        return real_large(matrices, on_result, solve)

    monkeypatch.setattr(eigen_mod, "eigh_large", spy)
    cov = _covariances()
    eigen = _empty()
    eigen_mod._device_eigendecomposition(_torch(cov), eigen, "auto")
    assert built == [1, 1, 1]  # the 64, 56 and 48 groups, one matrix each
    assert stacked  # the small dims went through the batched solve
    monkeypatch.setattr(torch, "stack", real_stack)
    _check_against_lapack(cov, {k: {n: v.numpy() for n, v in d.items()} for k, d in eigen.items()},
                          DIMS)


def test_eigh_large_frees_each_matrix_before_the_next():
    rng = np.random.default_rng(0)
    mats = [torch.from_numpy(rng.standard_normal((8, 8))) for _ in range(3)]
    alive, seen = [], []

    def build(i):
        def make():
            assert all(ref() is None for ref in alive), "a previous matrix is still referenced"
            m = mats[i] + mats[i].T
            alive.append(weakref.ref(m))
            return m
        return make

    def on_result(i, evals, evecs):
        seen.append(i)
        alive.append(weakref.ref(evecs))
        m = (mats[i] + mats[i].T).numpy()
        np.testing.assert_allclose(evals.numpy(), np.linalg.eigvalsh(m), atol=1e-12)

    eigh_mod.eigh_large([build(i) for i in range(3)], on_result)
    assert seen == [0, 1, 2]


def test_eigh_large_raises_on_a_failed_solve(monkeypatch):
    def failing(matrix):
        raise torch.linalg.LinAlgError("the algorithm failed to converge")

    monkeypatch.setattr(torch.linalg, "eigh", failing)
    with pytest.raises(torch.linalg.LinAlgError):
        eigh_mod.eigh_large([lambda: torch.eye(4)], lambda *a: None)


def test_checkpoints_carry_jax_names_and_resume_bitwise(tmp_path, monkeypatch):
    cov = _torch(_covariances())
    entries = _entries(cov)
    first = _empty()
    eigen_mod._large_group_eigendecomposition(cov, first, entries, tmp_path / "port")
    jax_eigen._large_group_eigendecomposition(
        {k: {n: v.numpy() for n, v in d.items()} for k, d in cov.items()}, _empty(), entries,
        tmp_path / "jax",
    )
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert "gradient_eigenvalues.layers_0__mlp__down_proj.safetensors" in names
    assert len(names) == len(entries) and not any(n.endswith(".tmp") for n in names)

    solves = _count_solves(monkeypatch)
    again = _empty()
    eigen_mod._large_group_eigendecomposition(cov, again, entries, tmp_path / "port")
    assert solves == []
    for name in EIGEN_NAMES:
        for module, t in first[name].items():
            assert torch.equal(again[name][module], t), (name, module)
    # Two checkpoints removed: exactly those two matrices are solved again.
    for path in sorted((tmp_path / "port").iterdir())[:2]:
        path.unlink()
    partial = _empty()
    eigen_mod._large_group_eigendecomposition(cov, partial, entries, tmp_path / "port")
    assert len(solves) == 2
    for name in EIGEN_NAMES:
        for module, t in first[name].items():
            assert torch.equal(partial[name][module], t), (name, module)


def test_each_package_reads_the_others_checkpoints(tmp_path, monkeypatch):
    """Checkpoints planted with values no solver would give: a rerun that
    read them returns them as they are."""
    cov_np = _covariances()
    cov = _torch(cov_np)
    entries = _entries(cov)
    planted = {}
    for (pair_idx, name), dim in entries:
        _c, _n, vec_name, val_name = eigen_mod._FACTOR_PAIRS[pair_idx]
        planted[(pair_idx, name)] = (torch.arange(dim, dtype=torch.float32),
                                     torch.full((dim, dim), float(pair_idx + 1)))
        save_file({"evals": planted[(pair_idx, name)][0], "evecs": planted[(pair_idx, name)][1]},
                  eigen_mod._checkpoint_path(tmp_path, val_name, name))
    jax_out = _empty()
    jax_eigen._large_group_eigendecomposition(cov_np, jax_out, entries, tmp_path)
    solves = _count_solves(monkeypatch)
    port_out = _empty()
    eigen_mod._large_group_eigendecomposition(cov, port_out, entries, tmp_path)
    assert solves == []
    for (pair_idx, name), (evals, evecs) in planted.items():
        _c, _n, vec_name, val_name = eigen_mod._FACTOR_PAIRS[pair_idx]
        np.testing.assert_array_equal(np.asarray(jax_out[val_name][name]), evals.numpy())
        np.testing.assert_array_equal(np.asarray(jax_out[vec_name][name]), evecs.numpy())
        assert torch.equal(port_out[val_name][name], evals)
        assert torch.equal(port_out[vec_name][name], evecs)
    # And the JAX package's own checkpoints, read by the port.
    jax_dir = tmp_path / "from_jax"
    jax_eigen._large_group_eigendecomposition(cov_np, _empty(), entries, jax_dir)
    port_read = _empty()
    eigen_mod._large_group_eigendecomposition(cov, port_read, entries, jax_dir)
    assert solves == []
    for path in jax_dir.iterdir():
        saved = jax_load_file(path)
        pair_idx = 0 if path.name.startswith("activation") else 1
        name = path.name.split(".")[1].replace("__", "/")
        _c, _n, vec_name, val_name = eigen_mod._FACTOR_PAIRS[pair_idx]
        np.testing.assert_array_equal(port_read[val_name][name].numpy(), saved["evals"])
        np.testing.assert_array_equal(port_read[vec_name][name].numpy(), saved["evecs"])


def test_results_take_each_covariance_dtype(tmp_path):
    cov = _torch(_covariances())
    for key in (ACTIVATION_COVARIANCE_MATRIX_NAME, GRADIENT_COVARIANCE_MATRIX_NAME):
        cov[key] = {n: t.to(torch.bfloat16) for n, t in cov[key].items()}
    eigen = _empty()
    eigen_mod._large_group_eigendecomposition(cov, eigen, _entries(cov), tmp_path)
    for name in EIGEN_NAMES:
        assert {t.dtype for t in eigen[name].values()} == {torch.bfloat16}
    saved = load_file(eigen_mod._checkpoint_path(tmp_path, ACTIVATION_EIGENVALUES_NAME, "big"))
    assert saved["evecs"].dtype == torch.bfloat16 and saved["evecs"].shape == (64, 64)
    assert torch.equal(saved["evecs"], eigen[ACTIVATION_EIGENVECTORS_NAME]["big"])


def test_factor_computer_removes_the_scratch_after_saving(tmp_path, monkeypatch):
    """The device path runs on the CPU here (the rule is patched to take fp32
    CPU factors): the tiny Llama's 112-dim MLP factors go through eigh_large,
    whose checkpoints exist while the stage runs and are gone once the
    artifact is saved, in the synchronous and the background write."""
    monkeypatch.setattr(eigen_mod, "_runs_on_device", lambda dtype, factor: dtype == "float32")
    monkeypatch.setattr(eigen_mod, "LARGE_EIGH_DIM", 100)
    scratch_seen = []
    real_large = eigen_mod.eigh_large

    def spy(matrices, on_result, solve=None):
        def record(i, evals, evecs):
            on_result(i, evals, evecs)
            scratch_seen.append(sorted(p.name for p in scratch.iterdir()))
        return real_large(matrices, record, solve)

    monkeypatch.setattr(eigen_mod, "eigh_large", spy)
    config = tiny_llama_config(num_layers=1, dtype=torch.float32)
    task = OpenWebTextTask(1)
    analyzer = Analyzer("llama", prepare_model(init_llama(config, seed=0, device="cpu"), task),
                        task, cpu=True, output_dir=str(tmp_path))
    rng = np.random.default_rng(0)
    data = {"input_ids": rng.integers(1, 128, size=(4, 32)).astype(np.int32),
            "attention_mask": np.ones((4, 32), dtype=np.int32)}
    args = extreme_reduce_memory_factor_arguments("ekfac", module_partitions=1, dtype="float32")
    args.eigendecomposition_dtype = "float32"
    args.use_empirical_fisher = True
    for name, run in (
        ("sync", lambda: (analyzer.fit_covariance_matrices("sync", data, per_device_batch_size=2,
                                                           factor_args=args),
                          analyzer.perform_eigendecomposition("sync", factor_args=args))),
        ("async", lambda: analyzer.fit_all_factors("async", data, per_device_batch_size=2,
                                                   factor_args=args)),
    ):
        scratch = analyzer.factors_output_dir(name) / "eigendecomposition_scratch"
        scratch_seen.clear()
        run()
        analyzer.wait_for_async_saves()
        # gate and up: gradient 112; down: activation 112.
        assert [len(s) for s in scratch_seen] == [1, 2, 3], scratch_seen
        assert not scratch.exists()
        eigen = analyzer.load_eigendecomposition(name)
        assert eigen[GRADIENT_EIGENVECTORS_NAME]["layers_0/mlp/gate_proj"].shape == (112, 112)
