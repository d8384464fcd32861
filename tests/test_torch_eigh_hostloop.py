"""The host-loop blocked Jacobi (`ops/eigh.py:eigh_jacobi_hostloop`, the
solve of `eigendecomposition_solver="jacobi"` at dimensions >=
LARGE_EIGH_DIM) against the JAX package's `eigh_jacobi_hostloop` and fp64
LAPACK, and the eigendecomposition stage's "jacobi" route for large groups
against the JAX package's `_large_group_eigendecomposition`, checkpoints and
resume included. On the CPU the K2 wrapper takes its plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import kronfluence_tpu.ops.eigh as jax_eigh
import kronfluence_tpu.ops.pallas.jacobi as jax_pallas_jacobi
from kronfluence_tpu.factor import eigen as jax_eigen
from kronfluence_tpu_torch.factor import eigen as eigen_mod
from kronfluence_tpu_torch.ops import eigh as eigh_mod
from kronfluence_tpu_torch.ops.eigh import eigh_jacobi_hostloop
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

LARGE = 48
EIGEN_NAMES = (ACTIVATION_EIGENVECTORS_NAME, ACTIVATION_EIGENVALUES_NAME,
               GRADIENT_EIGENVECTORS_NAME, GRADIENT_EIGENVALUES_NAME)
# fp32 solves against fp64 LAPACK, of max|lambda| (tests/test_torch_eigh_large.py).
FP32_RTOL = 1e-5
_ORIGINAL_JAX_K2 = jax_pallas_jacobi.jacobi_pivot_rotations


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread and one BLAS thread: these tests run many small ops
    and host eighs beside the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def _hostloop_inputs(n):
    """tests/test_eigh.py:test_jacobi_hostloop_matches_lapack's matrices."""
    rng = np.random.default_rng(3 + n)
    g = rng.normal(size=(2, n, n)).astype(np.float32)
    scale = np.exp(rng.uniform(-4, 2, size=(2, n, 1))).astype(np.float32)
    a = (g * scale) @ (g * scale).transpose(0, 2, 1)
    return 0.5 * (a + a.transpose(0, 2, 1))


@pytest.mark.parametrize("n", [96, 130])
def test_scalar_pivots_match_jax_k2_route(n, monkeypatch):
    """pivot="scalar": every pivot solve is K2 in the port; the JAX host loop
    is run with its Pallas K2 (interpret mode) in place of its XLA scalar
    loop, so both run the same algorithm. Eigenvalues within 1e-6 and
    eigenvectors (up to sign) within 1e-5 of max|lambda| / (their eigengap)."""
    monkeypatch.setattr(
        jax_pallas_jacobi, "jacobi_pivot_rotations",
        lambda s, sweeps, eps=None, **_: _ORIGINAL_JAX_K2(s, sweeps, eps=eps, interpret=True),
    )
    one_sweep = jax_eigh._jacobi_one_sweep
    monkeypatch.setattr(
        jax_eigh, "_jacobi_one_sweep",
        lambda A, W, bs, inner, _pallas, high, pivot: one_sweep(A, W, bs, inner, True, high, pivot),
    )
    a = _hostloop_inputs(n)
    want_ev, want_vec = jax_eigh.eigh_jacobi_hostloop(jnp.asarray(a), pivot="scalar")
    want_ev, want_vec = np.asarray(want_ev, np.float64), np.asarray(want_vec, np.float64)
    eigh_jacobi_hostloop.solves.clear()
    got_ev, got_vec = eigh_jacobi_hostloop(torch.from_numpy(a), pivot="scalar")
    got_ev, got_vec = got_ev.double().numpy(), got_vec.double().numpy()
    (record,) = eigh_jacobi_hostloop.solves
    assert record["pivot"] == "scalar" and 1 <= record["sweeps"] <= 24
    for i in range(a.shape[0]):
        scale = np.abs(want_ev[i]).max()
        assert np.abs(got_ev[i] - want_ev[i]).max() <= 1e-6 * scale
        gaps = np.abs(want_ev[i][:, None] - want_ev[i][None, :]) + np.eye(n) * scale
        gap = np.maximum(gaps.min(axis=1), 1e-30)
        sign = np.sign(np.sum(got_vec[i] * want_vec[i], axis=0))
        err = np.abs(got_vec[i] * sign - want_vec[i]).max(axis=0)
        assert np.all(err <= 1e-5 * scale / gap + 1e-6)


@pytest.mark.parametrize("n", [96, 130])
def test_exact_pivots_match_lapack(n):
    """The default pivots (an exact batched eigh of the pivot blocks), as
    tests/test_eigh.py holds the JAX host loop: eigenvalues within 5e-5,
    reconstructions 1e-4 and orthogonality 5e-5 of max|lambda| of fp64
    LAPACK's."""
    a = _hostloop_inputs(n)
    evals, vecs = eigh_jacobi_hostloop(torch.from_numpy(a))
    evals, vecs = evals.double().numpy(), vecs.double().numpy()
    for i in range(a.shape[0]):
        ref = np.linalg.eigh(a[i].astype(np.float64))[0]
        scale = np.abs(ref).max()
        assert np.abs(evals[i] - ref).max() < 5e-5 * scale
        assert np.abs((vecs[i] * evals[i]) @ vecs[i].T - a[i]).max() < 1e-4 * scale
        assert np.abs(vecs[i].T @ vecs[i] - np.eye(n)).max() < 5e-5 * scale


def test_polish_steps_and_full_fp32(monkeypatch):
    """Three Newton-Schulz steps at a padded size >= 4096 and one below, and
    every sweep and the polish at "highest" precision under a caller's TF32."""
    seen = []
    polish, sweep = eigh_mod._polish, eigh_mod._sweep

    def spy_polish(A0, W, ns_steps=1):
        seen.append(("polish", ns_steps, torch.get_float32_matmul_precision()))
        return polish(A0, W, ns_steps)

    def spy_sweep(*args):
        seen.append(("sweep", None, torch.get_float32_matmul_precision()))
        return sweep(*args)

    monkeypatch.setattr(eigh_mod, "_polish", spy_polish)
    monkeypatch.setattr(eigh_mod, "_sweep", spy_sweep)
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        eigh_jacobi_hostloop(torch.from_numpy(_hostloop_inputs(40)[:1]), block_size=16)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(previous)
    assert [s for s in seen if s[0] == "polish"] == [("polish", 1, "highest")]
    assert {p for _, _, p in seen} == {"highest"}
    # At n_pad >= 4096 the polish takes three steps (the sweeps and the
    # polish are stubbed: an identity is diagonal).
    seen.clear()
    monkeypatch.setattr(eigh_mod, "_hostloop_sweep",
                        lambda A, W, *args: (A, W, torch.zeros(A.shape[0])))
    monkeypatch.setattr(eigh_mod, "_polish", lambda A0, W, ns_steps=1: (
        seen.append(("polish", ns_steps, None)) or (A0.diagonal(dim1=1, dim2=2), W)))
    eigh_jacobi_hostloop(torch.eye(4096)[None], block_size=128)
    assert [s[:2] for s in seen if s[0] == "polish"] == [("polish", 3)]


def test_exact_pivot_rotations_are_orthogonal_eigenvectors():
    """One Newton-Schulz step after the eigh: the rotations stay the blocks'
    eigenvectors (V^T S V diagonal to fp32 rounding) and are orthogonal to
    rounding, closer than the eigh's own."""
    rng = np.random.default_rng(0)
    s = rng.standard_normal((3, 256, 256)).astype(np.float32)
    s = torch.from_numpy(s + s.transpose(0, 2, 1))
    eye = torch.eye(256, dtype=torch.float64)
    plain = torch.linalg.eigh(s)[1].double()
    with eigh_mod.full_fp32_matmul():
        v = eigh_mod.exact_pivot_rotations(s)
    v = v.double()
    d = v.transpose(1, 2) @ s.double() @ v
    scale = float(s.abs().max())
    assert float((d - torch.diag_embed(d.diagonal(dim1=1, dim2=2))).abs().max()) < 1e-4 * scale
    orth = float((v.transpose(1, 2) @ v - eye).abs().max())
    assert orth < 1e-6 and orth < float((plain.transpose(1, 2) @ plain - eye).abs().max())


def test_pivot_form_is_checked():
    with pytest.raises(ValueError, match="pivot"):
        eigh_jacobi_hostloop(torch.eye(8)[None], pivot="qdwh")


# ---------------------------------------------------------------------------
# The stage's "jacobi" route for groups at or above LARGE_EIGH_DIM.
# ---------------------------------------------------------------------------

DIMS = {"big": (64, 24), "layers_0/mlp/down_proj": (56, 48), "small": (16, 12)}


@pytest.fixture
def _threshold(monkeypatch):
    monkeypatch.setattr(eigen_mod, "LARGE_EIGH_DIM", LARGE)
    monkeypatch.setattr("kronfluence_tpu.ops.eigh.LARGE_EIGH_DIM", LARGE)
    monkeypatch.setenv("KF_LARGE_EIGH_SOLVER", "jacobi")


def _covariances(seed=5):
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


def _large_entries(cov):
    return [(key, dim) for dim, keys in eigen_mod._dim_groups(cov).items() if dim >= LARGE
            for key in keys]


def _assert_close(got, want, cov, names):
    """Eigenvalues and reconstructions within FP32_RTOL of max|lambda|, both
    sides against fp64 LAPACK too."""
    for key, count_key, vec_name, val_name in eigen_mod._FACTOR_PAIRS:
        for name in names:
            if name not in want[val_name]:
                continue
            m = np.asarray(cov[key][name], np.float64) / float(cov[count_key][name])
            m = 0.5 * (m + m.T)
            ref = np.linalg.eigvalsh(m)
            scale = np.abs(ref).max()
            recon = []
            for side in (got, want):
                ev = np.asarray(side[val_name][name], np.float64)
                vec = np.asarray(side[vec_name][name], np.float64)
                np.testing.assert_allclose(ev, ref, rtol=0, atol=FP32_RTOL * scale)
                recon.append((vec * ev) @ vec.T)
                np.testing.assert_allclose(recon[-1], m, rtol=0, atol=FP32_RTOL * scale)
            np.testing.assert_allclose(recon[0], recon[1], rtol=0, atol=FP32_RTOL * scale)


def test_large_groups_go_through_the_host_loop(_threshold, monkeypatch):
    """Under "jacobi" the factors at or above LARGE reach the host-loop solve
    one matrix at a time, each at its own dimension (block 128, exact
    pivots), and the small groups the batched solver; every result within
    FP32_RTOL of fp64 LAPACK."""
    cov = _covariances()
    solves, batched = [], []
    real, real_batched = eigh_mod.eigh_jacobi_hostloop, eigen_mod.eigh_batched

    def spy(matrices, block_size=32, **kwargs):
        solves.append((tuple(matrices.shape), block_size, kwargs.get("pivot", "eigh")))
        return real(matrices, block_size, **kwargs)

    spy.solves = real.solves
    monkeypatch.setattr(eigh_mod, "eigh_jacobi_hostloop", spy)
    monkeypatch.setattr(eigen_mod, "eigh_batched",
                        lambda m: batched.append(tuple(m.shape)) or real_batched(m))
    got = _empty()
    eigen_mod._device_eigendecomposition(_torch(cov), got, "jacobi")
    assert sorted(solves) == [((1, 48, 48), 128, "eigh"), ((1, 56, 56), 128, "eigh"),
                              ((1, 64, 64), 128, "eigh")]
    assert sorted(batched) == [(1, 12, 12), (2, 24, 24)]
    got = {k: {n: v.numpy() for n, v in d.items()} for k, d in got.items()}
    _assert_close(got, got, cov, DIMS)
    assert set(got[ACTIVATION_EIGENVALUES_NAME]) == set(DIMS)


def test_hostloop_checkpoints_resume_across_packages(_threshold, tmp_path, monkeypatch):
    """The host-loop route against the JAX package's
    `_large_group_eigendecomposition` under KF_LARGE_EIGH_SOLVER=jacobi:
    results within FP32_RTOL of each other and of LAPACK, the JAX package's
    checkpoint names; the JAX package resumes from the port's, the port from
    the JAX package's, and a rerun of the port on its own solves nothing
    again."""
    cov_np = _covariances()
    cov = _torch(cov_np)
    entries = _large_entries(cov)
    solve = eigh_mod.jacobi_hostloop_solve
    port = _empty()
    eigen_mod._large_group_eigendecomposition(cov, port, entries, tmp_path / "port", solve)
    jax_out = _empty()
    jax_eigen._large_group_eigendecomposition(cov_np, jax_out, entries, tmp_path / "jax")
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == len(entries)
    _assert_close({k: {n: v.numpy() for n, v in d.items()} for k, d in port.items()},
                  {k: {n: np.asarray(v) for n, v in d.items()} for k, d in jax_out.items()},
                  cov_np, DIMS)

    calls = []
    monkeypatch.setattr(eigh_mod, "eigh_jacobi_hostloop",
                        lambda *a, **k: calls.append(a) or (_ for _ in ()).throw(AssertionError))
    again = _empty()
    eigen_mod._large_group_eigendecomposition(cov, again, entries, tmp_path / "port", solve)
    from_jax = _empty()
    eigen_mod._large_group_eigendecomposition(cov, from_jax, entries, tmp_path / "jax", solve)
    assert calls == []
    jax_again = _empty()
    jax_eigen._large_group_eigendecomposition(cov_np, jax_again, entries, tmp_path / "port")
    for name in EIGEN_NAMES:
        for module, t in port[name].items():
            assert torch.equal(again[name][module], t)
            np.testing.assert_array_equal(np.asarray(jax_again[name][module]), t.numpy())
            np.testing.assert_array_equal(from_jax[name][module].numpy(),
                                          np.asarray(jax_out[name][module]))


# ---------------------------------------------------------------------------
# Card only.
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_exact_pivots_over_streams_match_one_call():
    """Card only: the pivot blocks' solves split over PIVOT_STREAMS streams
    give the bits of one batched torch.linalg.eigh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU takes one torch.linalg.eigh")
    g = torch.Generator("cuda").manual_seed(0)
    s = torch.randn(56, 256, 256, device="cuda", generator=g)
    s = s + s.transpose(1, 2)
    got = eigh_mod._pivot_eigenvectors(s)
    assert torch.equal(got, torch.linalg.eigh(s)[1])


@pytest.mark.cuda
def test_cuda_scalar_pivots_refuse_blocks_k2_cannot_hold():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with pytest.raises(ValueError, match="K2"):
        eigh_jacobi_hostloop(torch.eye(512, device="cuda")[None], block_size=128, pivot="scalar")
