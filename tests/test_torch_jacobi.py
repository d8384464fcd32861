"""The blocked-Jacobi eigensolver path of the port (`eigendecomposition_solver=
"jacobi"`) against kronfluence_tpu: K2's plain version, and a CPU emulation of
the m 64 register kernel's schedule, against the JAX Pallas kernel in
interpret mode; K2's route rule; the solver against the JAX solver's K2 route and
LAPACK, the eigendecomposition stage on the tiny GPT-2, and the solver
dispatch. On the CPU the K2 wrapper takes its plain version; the CUDA kernel
is compared with it on the card by chip_smoke.py and the `cuda`-marked tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import kronfluence_tpu.ops.pallas.jacobi as jax_pallas_jacobi
import kronfluence_tpu_torch.factor.eigen as eigen_mod
import kronfluence_tpu_torch.ops.eigh as eigh_mod
from kronfluence_tpu.factor.covariance import (
    fit_covariance_matrices_with_loader as jax_fit_covariance,
)
from kronfluence_tpu.factor.eigen import _device_eigendecomposition as jax_device_eigendecomposition
from kronfluence_tpu.factor.eigen import _merge_dim_groups as jax_merge_dim_groups
from kronfluence_tpu.ops.eigh import _blocked_jacobi_eigh as jax_blocked_jacobi_eigh
from kronfluence_tpu.ops.eigh import eigh_batched as jax_eigh_batched
from kronfluence_tpu.utils.common.factor_arguments import (
    pytest_factor_arguments as jax_factor_args,
)
from kronfluence_tpu.utils.dataset import BatchLoader as JaxBatchLoader
from kronfluence_tpu_torch.arguments import FactorArguments
from kronfluence_tpu_torch.factor.eigen import (
    _device_eigendecomposition,
    _merge_dim_groups,
    perform_eigendecomposition,
)
from kronfluence_tpu_torch.ops.eigh import eigh_batched, gershgorin_pad
from kronfluence_tpu_torch.ops.kernels.jacobi import (
    jacobi_pivot_rotations,
    jacobi_pivot_rotations_reference,
    jacobi_route,
    rotation_coefficients,
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
from tests.testable_tasks.language_modeling import make_lm, make_lm_data

_ORIGINAL_JAX_K2 = jax_pallas_jacobi.jacobi_pivot_rotations
PAIRS = (
    (ACTIVATION_COVARIANCE_MATRIX_NAME, NUM_ACTIVATION_COVARIANCE_PROCESSED,
     ACTIVATION_EIGENVALUES_NAME, ACTIVATION_EIGENVECTORS_NAME),
    (GRADIENT_COVARIANCE_MATRIX_NAME, NUM_GRADIENT_COVARIANCE_PROCESSED,
     GRADIENT_EIGENVALUES_NAME, GRADIENT_EIGENVECTORS_NAME),
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain K2 and the solver run tens of thousands of small ops. With
    intra-op threads on a loaded machine (the suite's parallel workers) every
    op's thread team contends for the cores: one (70, 64, 64) solve took 55 s
    with 8 threads under load and 2.7 s with one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def _sym_blocks(y, m, seed):
    base = np.random.default_rng(seed).standard_normal((y, m, m)).astype(np.float32)
    return base + base.transpose(0, 2, 1)


def _psd_batch(x, n, seed=0, ill_conditioned_first=True):
    """tests/test_eigh.py's inputs."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((x, n, n)).astype(np.float32)
    a = g @ g.transpose(0, 2, 1) / n
    if ill_conditioned_first:
        h = rng.standard_normal((n, max(1, n // 2))).astype(np.float32)
        a[0] = (h @ h.T) / n + 1e-6 * np.eye(n, dtype=np.float32)
    return 0.5 * (a + a.transpose(0, 2, 1))


# ---------------------------------------------------------------------------
# K2: the plain version against the JAX kernel.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("y", [1, 3, 70])
@pytest.mark.parametrize("sweeps", [1, 2])
@pytest.mark.parametrize("m", [8, 32, 64])
def test_k2_plain_version_matches_jax_kernel(m, sweeps, y):
    """Same schedule, same coefficients, both fp32. They differ in rounding
    only (XLA's rsqrt is not torch's in ~45% of inputs), and a Jacobi
    rotation sequence amplifies rounding: near-equal diagonal pairs and the
    eps * scale skip make V a steep function of its input, so the same
    algorithm in fp32 and fp64 differs by up to 0.5 on some random 64 x 64
    blocks at 2 sweeps. So each block is held to 1e-5 plus 16x how far fp32
    rounding alone moves that block's V (the plain version in fp64 vs fp32);
    a wrong schedule or coefficient moves every block by O(1). The V-derived
    invariants (orthogonality, remaining off-diagonal mass) must agree too."""
    s = _sym_blocks(y, m, seed=1000 * m + 10 * y + sweeps)
    want = np.asarray(
        jax_pallas_jacobi.jacobi_pivot_rotations(jnp.asarray(s), sweeps=sweeps, interpret=True),
        np.float64,
    )
    got = jacobi_pivot_rotations(torch.from_numpy(s), sweeps)
    assert got.dtype == torch.float32 and got.shape == (y, m, m)
    got = got.double().numpy()
    fp64 = jacobi_pivot_rotations_reference(torch.from_numpy(s).double(), sweeps).numpy()
    sensitivity = np.abs(got - fp64).max(axis=(1, 2))
    diff = np.abs(got - want).max(axis=(1, 2))
    assert np.all(diff <= 1e-5 + 16.0 * sensitivity), (diff, sensitivity)

    eye = np.eye(m)
    assert np.abs(np.einsum("yji,yjk->yik", got, got) - eye).max() < 1e-5

    def off_mass(v):
        d = np.einsum("yji,yjk,ykl->yil", v, s.astype(np.float64), v)
        return np.sqrt(np.sum(np.square(d - d * eye))) / np.sqrt(np.sum(np.square(s - s * eye)))

    ratio = off_mass(got)
    assert ratio < 0.75  # the rotations work (the JAX probe's gate)
    # A block whose V rounding moves by O(1) ends with another off-mass too.
    assert abs(ratio - off_mass(want)) < 1e-2 * ratio


def test_k2_exact_diagonal_tie_stays_orthogonal():
    """A pair with exactly equal diagonal entries: the JAX kernel computes
    each seat's coefficients separately, both get tau = +0 and the same sign
    of s, and its V is singular. The port computes the pair once (odd seat
    -s) and rotates by 45 degrees, as scalar Jacobi does."""
    m = 8
    s = np.diag(np.arange(1.0, m + 1.0)).astype(np.float32)
    s[0, 0] = s[1, 1] = 2.0
    s[0, 1] = s[1, 0] = 0.5
    v = jacobi_pivot_rotations(torch.from_numpy(s[None]), 1)[0].double().numpy()
    assert np.abs(v.T @ v - np.eye(m)).max() < 1e-6
    d = v.T @ s @ v
    assert np.abs(d - np.diag(np.diag(d))).max() < 1e-6
    jax_v = np.asarray(
        jax_pallas_jacobi.jacobi_pivot_rotations(jnp.asarray(s[None]), sweeps=1, interpret=True)
    )[0]
    assert np.abs(jax_v.T @ jax_v - np.eye(m)).max() > 0.5


def test_k2_cpu_tensor_takes_plain_path_and_counts_nothing():
    s = torch.from_numpy(_sym_blocks(3, 16, seed=4))
    before = jacobi_pivot_rotations.launches
    got = jacobi_pivot_rotations(s, 2)
    assert jacobi_pivot_rotations.launches == before
    assert torch.equal(got, jacobi_pivot_rotations_reference(s, 2))


@pytest.mark.parametrize("shape", [(2, 7, 7), (2, 2, 2), (2, 8, 6), (8, 8)])
def test_k2_rejects_odd_small_or_nonsquare_blocks(shape):
    with pytest.raises(ValueError, match="jacobi_pivot_rotations"):
        jacobi_pivot_rotations(torch.zeros(shape), 1)


def test_k2_non_cpu_non_cuda_tensor_raises_instead_of_falling_back():
    with pytest.raises(ValueError, match="CPU or CUDA"):
        jacobi_pivot_rotations(torch.empty((2, 8, 8), device="meta"), 1)


@pytest.mark.parametrize(
    "m,route",
    [(4, "generic"), (8, "generic"), (32, "generic"), (62, "generic"), (64, "registers"),
     (66, "generic"), (128, "generic")],
)
def test_jacobi_route_takes_the_register_kernel_at_m_64_only(m, route):
    assert jacobi_route(m) == route


@pytest.mark.parametrize("m", [32, 64])
def test_k2_cpu_tensor_counts_no_route(m):
    s = torch.from_numpy(_sym_blocks(2, m, seed=m))
    before = (jacobi_pivot_rotations.registers_launches, jacobi_pivot_rotations.generic_launches)
    jacobi_pivot_rotations(s, 1)
    after = (jacobi_pivot_rotations.registers_launches, jacobi_pivot_rotations.generic_launches)
    assert after == before


def _register_schedule(s: torch.Tensor, sweeps: int, warps: int = 4) -> torch.Tensor:
    """csrc/jacobi_m64.cu's schedule on the CPU, owner for owner: warp w, lane
    k holds the 2 x 2 tiles (seat pair k, column pair w * cols + j) of A and
    V, as (Y, warp, lane, j, 4) with element (odd row) * 2 + (odd column).
    Each round, every warp computes all pairs' coefficients from the pivots
    (lane k pair k) and shuffles a column pair's to its tiles; A's rows then
    columns are rotated; the row half of sigma moves rows between lanes
    (shuffles up and down with the fixups of lanes 0, 1 and 31); each warp
    writes its candidates for the next pivots to its own slot and lane k
    reads the holder's; the column half moves columns between a thread's
    tiles and hands the edge columns to the neighbouring warps. V trails A
    by one round. The same operations as the plain version, so bit for bit
    its V, unless a layout, shuffle or hand-off is wrong."""
    y, m, _ = s.shape
    assert m == 64 and s.dtype == torch.float32
    pairs, cols = m // 2, m // 2 // warps
    eps = float(np.finfo(np.float32).eps)
    lane = torch.arange(pairs).view(1, 1, pairs, 1, 1)
    warp = torch.arange(warps).view(1, warps, 1, 1)

    def tiles(x):
        return x.reshape(y, pairs, 2, warps, cols, 2).permute(0, 3, 1, 4, 2, 5).reshape(
            y, warps, pairs, cols, 4)

    def rot(c, x, sn, other):
        return c * x - sn * other

    def rotate_columns(x, c2, s2):
        x0, x1, x2, x3 = x.unbind(-1)
        return torch.stack([rot(c2, x0, s2, x1), rot(c2, x1, -s2, x0),
                            rot(c2, x2, s2, x3), rot(c2, x3, -s2, x2)], -1)

    def send_and_shift_columns(x):
        up, down = x[:, :, :, -1][..., 0::2], x[:, :, :, 0][..., 1::2]
        new = x.clone()
        new[:, :, :, 2:, 0::2] = x[:, :, :, 1:-1, 0::2]
        new[:, :, :, 1, 0::2] = torch.where(warp == 0, x[:, :, :, 0, 1::2], x[:, :, :, 0, 0::2])
        new[:, :, :, :-1, 1::2] = x[:, :, :, 1:, 1::2]
        new[:, -1, :, -1, 1::2] = x[:, -1, :, -1, 0::2]
        return new, up, down

    def receive_columns(x, up, down):
        x[:, 1:, :, 0, 0::2] = up[:, :-1]
        x[:, :-1, :, -1, 1::2] = down[:, 1:]
        return x

    def v_round(v, c2, s2):
        return receive_columns(*send_and_shift_columns(rotate_columns(v, c2, s2)))

    k = torch.arange(pairs)
    pp_pair = torch.where(k <= 1, 0, k - 1)
    q_pair = torch.where(k == pairs - 1, pairs - 1, k + 1)
    a = tiles(s).clone()
    v = tiles(torch.eye(m).expand(y, m, m)).clone()
    diag = torch.stack([s[:, 2 * k, 2 * k], s[:, 2 * k + 1, 2 * k + 1], s[:, 2 * k, 2 * k + 1]], -1)
    slots = diag[:, None].expand(y, warps, pairs, 3)  # round 0's pivots in every warp's slot
    c2p = s2p = None
    for r in range(sweeps * (m - 1)):
        pivot = torch.stack([slots[:, pp_pair // cols, k, 0], slots[:, q_pair // cols, k, 1],
                             slots[:, q_pair // cols, k, 2]], -1)
        c, sn = rotation_coefficients(pivot[..., 0], pivot[..., 1], pivot[..., 2], eps)
        if r > 0:
            v = v_round(v, c2p, s2p)
        c2, s2 = c.view(y, warps, 1, cols), sn.view(y, warps, 1, cols)
        cr, sr = c.view(y, 1, pairs, 1), sn.view(y, 1, pairs, 1)
        x0, x1, x2, x3 = a.unbind(-1)
        a = torch.stack([rot(cr, x0, sr, x2), rot(cr, x1, sr, x3),
                         rot(cr, x2, -sr, x0), rot(cr, x3, -sr, x1)], -1)
        a = rotate_columns(a, c2, s2)
        up = torch.roll(torch.where(lane == 0, a[..., 2:], a[..., :2]), 1, dims=2)
        down = torch.roll(a[..., 2:], -1, dims=2)
        a = torch.cat([torch.where(lane == 0, a[..., :2], up),
                       torch.where(lane == pairs - 1, a[..., :2], down)], -1)
        # Each warp's candidates, picked from its tiles (j = pair mod cols).
        mine = a[:, :, k]  # (Y, warp, lane, j, 4)
        slots = torch.stack([mine[:, :, k, pp_pair % cols, torch.where(k == 1, 1, 0)],
                             mine[:, :, k, q_pair % cols, torch.where(k == pairs - 1, 2, 3)],
                             mine[:, :, k, q_pair % cols, torch.where(k == pairs - 1, 0, 1)]], -1)
        a = receive_columns(*send_and_shift_columns(a))
        c2p, s2p = c2, s2
    if c2p is not None:
        v = v_round(v, c2p, s2p)
    return v.view(y, warps, pairs, cols, 2, 2).permute(0, 2, 4, 1, 3, 5).reshape(y, m, m)


@pytest.mark.parametrize("warps", [4, 8])
@pytest.mark.parametrize("sweeps", [0, 1, 2])
def test_register_schedule_matches_plain_version_bit_for_bit(sweeps, warps):
    """The register kernel's owners, shuffles and hand-offs (4 warps as
    built; 8 as its profiled copy), emulated on the CPU, give the plain
    version's V bit for bit: an index fault moves V by O(1)."""
    s = torch.from_numpy(_sym_blocks(3, 64, seed=640 + sweeps))
    got = _register_schedule(s, sweeps, warps)
    assert torch.equal(got, jacobi_pivot_rotations_reference(s, sweeps))


@pytest.mark.parametrize("sweeps", [1, 2])
def test_register_schedule_matches_jax_kernel(sweeps):
    """The emulated schedule against the JAX kernel in interpret mode, with
    test_k2_plain_version_matches_jax_kernel's per-block tolerance."""
    s = _sym_blocks(2, 64, seed=6400 + sweeps)
    want = np.asarray(
        jax_pallas_jacobi.jacobi_pivot_rotations(jnp.asarray(s), sweeps=sweeps, interpret=True),
        np.float64,
    )
    got = _register_schedule(torch.from_numpy(s), sweeps).double().numpy()
    fp64 = jacobi_pivot_rotations_reference(torch.from_numpy(s).double(), sweeps).numpy()
    sensitivity = np.abs(got - fp64).max(axis=(1, 2))
    diff = np.abs(got - want).max(axis=(1, 2))
    assert np.all(diff <= 1e-5 + 16.0 * sensitivity), (diff, sensitivity)
    assert np.abs(np.einsum("yji,yjk->yik", got, got) - np.eye(64)).max() < 1e-5


# ---------------------------------------------------------------------------
# The blocked solver.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [96, 130])
def test_blocked_jacobi_matches_jax_k2_route(n, monkeypatch):
    """The port's solver against the JAX package's `_blocked_jacobi_eigh(
    use_pallas=True)`, its K2 in interpret mode: the same algorithm, so the
    same sweeps, eigenvalues within 1e-5 of max|lambda|, and each eigenvector
    equal up to sign within 1e-5 max|lambda| / (its eigengap), the
    first-order perturbation bound for eigenvectors."""
    monkeypatch.setattr(
        jax_pallas_jacobi, "jacobi_pivot_rotations",
        lambda s, sweeps, eps=None, **_: _ORIGINAL_JAX_K2(s, sweeps, eps=eps, interpret=True),
    )
    a = gershgorin_pad(torch.from_numpy(_psd_batch(2, n, seed=n)), -(-n // 32) * 32)
    want_ev, want_vec = jax_blocked_jacobi_eigh(
        jnp.asarray(a.numpy()), 16, 2, 16, 1e-6, use_pallas=True
    )
    want_ev, want_vec = np.asarray(want_ev, np.float64), np.asarray(want_vec, np.float64)
    got_ev, got_vec, sweeps = eigh_mod._blocked_jacobi_eigh(a, 16, 2, 16, 1e-6)
    got_ev, got_vec = got_ev.double().numpy(), got_vec.double().numpy()
    assert 1 <= sweeps <= 16
    for i in range(a.shape[0]):
        scale = np.abs(want_ev[i]).max()
        assert np.abs(got_ev[i] - want_ev[i]).max() < 1e-5 * scale
        gaps = np.abs(want_ev[i][:, None] - want_ev[i][None, :]) + np.eye(a.shape[1]) * scale
        gap = np.maximum(gaps.min(axis=1), 1e-30)
        sign = np.sign(np.sum(got_vec[i] * want_vec[i], axis=0))
        err = np.abs(got_vec[i] * sign - want_vec[i]).max(axis=0)
        assert np.all(err <= 1e-5 * scale / gap + 1e-6)


@pytest.mark.parametrize("n,bs", [(5, 32), (48, 16), (129, 32), (200, 32), (384, 32)])
def test_eigh_batched_vs_lapack_and_jax(n, bs):
    """tests/test_eigh.py's accuracy test on the port (5e-5 of scale against
    fp64 LAPACK), and up to n 200 the port against the JAX package's default
    eigh_batched (scalar pivots): eigenvalues 5e-5, reconstructions 1e-4
    (each side is within 5e-5 of LAPACK's). At 384 the JAX solve costs 13 s
    on the CPU, and tests/test_eigh.py holds it against LAPACK already."""
    a = _psd_batch(2, n)
    evals, vecs = eigh_batched(torch.from_numpy(a), block_size=bs)
    evals, vecs = evals.double().numpy(), vecs.double().numpy()
    if n <= 200:
        jev, jvec = jax_eigh_batched(jnp.asarray(a), block_size=bs)
        jev, jvec = np.asarray(jev, np.float64), np.asarray(jvec, np.float64)
    for i in range(a.shape[0]):
        ref = np.linalg.eigh(a[i].astype(np.float64))[0]
        scale = np.abs(ref).max()
        assert np.abs(evals[i] - ref).max() / scale < 5e-5
        assert np.all(np.diff(evals[i]) >= -1e-6 * scale)
        assert np.abs(vecs[i].T @ vecs[i] - np.eye(n)).max() < 5e-5
        recon = (vecs[i] * evals[i]) @ vecs[i].T
        assert np.abs(recon - a[i]).max() / scale < 5e-5
        if n <= 200:
            assert np.abs(evals[i] - jev[i]).max() / scale < 5e-5
            assert np.abs(recon - (jvec[i] * jev[i]) @ jvec[i].T).max() / scale < 1e-4


@pytest.mark.parametrize("n", [72, 100])
def test_padded_matrix_converges_at_small_scale(n):
    """A fault of the JAX solver that the port does not copy: padding puts
    4 * bound + 1 on the padded diagonal, and the JAX convergence test
    measures the off-norm against a Frobenius norm that counts those entries.
    For a matrix of scale 1e-4 the "+1" dominates, the solve stops early and
    its eigenvalues are off by 1e-3 to 2e-2 of max|lambda|. The port leaves
    decoupled diagonal entries out of the reference norm: 5e-5, as at
    scale 1."""
    rng = np.random.default_rng(7)
    g = rng.standard_normal((1, n, n)).astype(np.float32)
    a = (g @ g.transpose(0, 2, 1) / n * 1e-4).astype(np.float32)
    ref = np.linalg.eigh(a[0].astype(np.float64))[0]
    scale = np.abs(ref).max()
    got, _ = eigh_batched(torch.from_numpy(a), block_size=32)
    assert np.abs(got[0].double().numpy() - ref).max() < 5e-5 * scale
    jax_got, _ = jax_eigh_batched(jnp.asarray(a), block_size=32)
    assert np.abs(np.asarray(jax_got[0], np.float64) - ref).max() > 5e-5 * scale


def test_batch_chunking_consistency():
    """tests/test_eigh.py's chunking case, the budget passed in: 5 matrices
    in chunks of 2 give matrix 2 the eigenvalues of a solve on its own."""
    n = 80
    a = torch.from_numpy(_psd_batch(5, n, seed=3, ill_conditioned_first=False))
    eigh_batched.chunks.clear()
    ev_all, _ = eigh_batched(a, block_size=16, budget_elems=2 * n * n)
    assert [c["matrices"] for c in eigh_batched.chunks] == [2, 2, 1]
    ev_one, _ = eigh_batched(a[2:3], block_size=16)
    np.testing.assert_allclose(ev_all[2].numpy(), ev_one[0].numpy(), rtol=1e-4, atol=1e-5)


def test_chunk_log_counts_k2_rounds(monkeypatch):
    """`eigh_batched.chunks` gives K2's launch count: sweeps x rounds."""
    a = torch.from_numpy(_psd_batch(3, 96, seed=5, ill_conditioned_first=False))
    calls = []
    original = eigh_mod.jacobi_pivot_rotations

    def spy(s, sweeps, eps=None):
        calls.append(tuple(s.shape))
        return original(s, sweeps, eps)

    monkeypatch.setattr(eigh_mod, "jacobi_pivot_rotations", spy)
    eigh_batched.chunks.clear()
    eigh_batched(a, block_size=16)
    (chunk,) = eigh_batched.chunks
    assert chunk == {"n": 96, "matrices": 3, "sweeps": chunk["sweeps"], "rounds_per_sweep": 5}
    assert len(calls) == chunk["sweeps"] * chunk["rounds_per_sweep"] > 0
    assert set(calls) == {(3 * 3, 32, 32)}


def test_fine_phase_and_polish_run_full_fp32_under_tf32(monkeypatch):
    """The caller allows TF32; every sweep and the polish still run at
    "highest" precision, and the caller's setting is back afterwards."""
    seen = []
    sweep, polish = eigh_mod._sweep, eigh_mod._polish

    def spy(fn, tag):
        def wrapped(*args, **kwargs):
            seen.append((tag, torch.get_float32_matmul_precision()))
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(eigh_mod, "_sweep", spy(sweep, "sweep"))
    monkeypatch.setattr(eigh_mod, "_polish", spy(polish, "polish"))
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        # A tolerance under 1e-3 makes the solve run both phases.
        eigh_batched(torch.from_numpy(_psd_batch(1, 96, seed=6)), block_size=16)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(previous)
    assert [t for t, _ in seen].count("polish") == 1
    assert [t for t, _ in seen].count("sweep") >= 2
    assert {p for _, p in seen} == {"highest"}


# ---------------------------------------------------------------------------
# The stage on the tiny GPT-2, and the solver dispatch.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def covariances():
    """The tiny GPT-2's covariance factors (fp64, from the JAX package), as
    fp32 for both packages."""
    jmodel, params, jtask, config = make_lm()
    train = make_lm_data(10, seq_len=config.max_seq_len, vocab=config.vocab_size, seed=0)
    jcov = jax_fit_covariance(jmodel, params, jtask, JaxBatchLoader(train, 4), jax_factor_args("ekfac"))
    host = {k: {n: np.asarray(t) for n, t in v.items()} for k, v in jcov.items()}
    jax32 = {k: {n: jnp.asarray(t.astype(np.float32) if t.dtype == np.float64 else t)
                 for n, t in v.items()} for k, v in host.items()}
    torch32 = {k: {n: torch.tensor(t.astype(np.float32) if t.dtype == np.float64 else t)
                   for n, t in v.items()} for k, v in host.items()}
    return jax32, torch32


def _empty_eigen():
    return {name: {} for _, _, e, v in PAIRS for name in (e, v)}


def test_jacobi_stage_matches_jax_on_tiny_gpt2(covariances):
    """`_device_eigendecomposition(..., "jacobi")` of both packages on the
    same fp32 factors. d_model 32: dims 33/32 run `_small_eigh`, 96 and
    129/128 the blocked path with K2's plain version. The port's eigenvalues
    and reconstructions are within 5e-5 of max|lambda| of fp64 LAPACK's and
    its eigenvectors are unit. Against the JAX stage: 2e-4, since the JAX
    solver stops early on the padded 129/128 group (its own error there is
    up to 1.1e-4 in eigenvalues, 1.5e-4 in reconstructions; see
    test_padded_matrix_converges_at_small_scale)."""
    jax32, torch32 = covariances
    dims = {int(t.shape[0]) for v in (torch32[c] for c, _, _, _ in PAIRS) for t in v.values()}
    assert dims == {33, 32, 96, 129, 128}
    want = {name: {} for _, _, e, v in PAIRS for name in (e, v)}
    jax_device_eigendecomposition(jax32, want, "jacobi", None)
    got = _empty_eigen()
    eigh_batched.chunks.clear()
    _device_eigendecomposition(torch32, got, "jacobi")
    assert sorted(c["n"] for c in eigh_batched.chunks) == [128, 192]
    for cov_name, count_name, eval_name, evec_name in PAIRS:
        for name, mat in torch32[cov_name].items():
            q, lam = got[evec_name][name], got[eval_name][name]
            assert q.dtype == torch.float32 and q.shape == mat.shape
            q, lam = q.double().numpy(), lam.double().numpy()
            jq = np.asarray(want[evec_name][name], np.float64)
            jlam = np.asarray(want[eval_name][name], np.float64)
            normalized = mat.double().numpy() / float(torch32[count_name][name].reshape(()))
            normalized = 0.5 * (normalized + normalized.T)
            ref = np.linalg.eigh(normalized)[0]
            scale = np.abs(ref).max()
            recon = (q * lam) @ q.T
            assert np.abs(lam - ref).max() < 5e-5 * scale, name
            assert np.abs(recon - normalized).max() < 5e-5 * scale, name
            assert np.abs(lam - jlam).max() < 2e-4 * scale, name
            assert np.abs(recon - (jq * jlam) @ jq.T).max() < 2e-4 * scale, name
            np.testing.assert_allclose(np.linalg.norm(q, axis=0), 1.0, atol=1e-5)


@pytest.mark.parametrize(
    "groups",
    [
        {769: ["a"], 768: ["b"], 2304: ["c"]},
        {3073: ["a", "b"], 3072: ["c"], 769: ["d"], 768: ["e"], 2304: ["f"]},
        {64: ["a"], 65: ["b"], 80: ["c"], 14336: ["d"], 14300: ["e"]},
    ],
)
def test_merge_dim_groups_matches_jax(groups):
    merged = _merge_dim_groups(groups)
    assert merged == jax_merge_dim_groups(groups)
    if 769 in groups and 3073 not in groups:
        assert set(merged) == {769, 2304}
        assert sorted(merged[769]) == [("a", 769), ("b", 768)]


def _spy_solvers(monkeypatch):
    """Counts the calls of each solver. The Jacobi spy answers with LAPACK:
    these tests check the dispatch, and the solver has its own tests."""
    calls = {"jacobi": 0, "eigh": 0}
    linalg_eigh = torch.linalg.eigh

    def jacobi(matrices):
        calls["jacobi"] += 1
        return linalg_eigh(matrices)

    def eigh(*a, **k):
        calls["eigh"] += 1
        return linalg_eigh(*a, **k)

    monkeypatch.setattr(eigen_mod, "eigh_batched", jacobi)
    monkeypatch.setattr(torch.linalg, "eigh", eigh)
    return calls


@pytest.mark.parametrize(
    "solver,want", [("jacobi", "jacobi"), ("auto", "eigh"), ("qdwh", "eigh")]
)
def test_solver_argument_reaches_the_named_solver(covariances, monkeypatch, solver, want):
    """perform_eigendecomposition hands `eigendecomposition_solver` to the
    device path (taken here for CPU tensors by patching the device rule):
    "jacobi" reaches the blocked-Jacobi solver, "auto" and "qdwh"
    torch.linalg.eigh."""
    _, torch32 = covariances
    calls = _spy_solvers(monkeypatch)
    monkeypatch.setattr(eigen_mod, "_runs_on_device", lambda *_: True)
    args = FactorArguments(eigendecomposition_dtype="float32", eigendecomposition_solver=solver)
    out = perform_eigendecomposition(torch32, args)
    assert calls[want] >= 1
    assert calls["jacobi" if want == "eigh" else "eigh"] == 0
    assert set(out[ACTIVATION_EIGENVALUES_NAME]) == set(torch32[ACTIVATION_COVARIANCE_MATRIX_NAME])


def test_device_rule_takes_cuda_fp32_only():
    assert not eigen_mod._runs_on_device("float32", torch.zeros(2, 2))
    assert not eigen_mod._runs_on_device("float64", torch.zeros(2, 2))
    assert not eigen_mod._runs_on_device("float32", torch.zeros(2, 2, device="meta"))


def test_dc_solver_raises(covariances):
    with pytest.raises(NotImplementedError, match="TPU-only"):
        _device_eigendecomposition(covariances[1], _empty_eigen(), "dc")


def test_jacobi_raises_at_llama_dims_before_solving(monkeypatch):
    """Under "jacobi" the 14336- and 6144-dim groups no longer raise: each
    reaches `_large_group_eigendecomposition` with the host-loop solve
    (`ops/eigh.py:jacobi_hostloop_solve`), and neither reaches the batched
    solver or cuSOLVER. The stage is spied, so nothing of that size is
    allocated: the factors are expanded zeros."""
    calls = _spy_solvers(monkeypatch)
    large = []

    def spy(covariance_factors, eigen_factors, entries, scratch_dir=None, solve=None):
        large.append((sorted(dim for _, dim in entries), solve))

    monkeypatch.setattr(eigen_mod, "_large_group_eigendecomposition", spy)
    cov = {
        ACTIVATION_COVARIANCE_MATRIX_NAME: {"m": torch.zeros(()).expand(14336, 14336)},
        GRADIENT_COVARIANCE_MATRIX_NAME: {"m": torch.zeros(()).expand(6144, 6144)},
        NUM_ACTIVATION_COVARIANCE_PROCESSED: {"m": torch.ones(1)},
        NUM_GRADIENT_COVARIANCE_PROCESSED: {"m": torch.ones(1)},
    }
    _device_eigendecomposition(cov, _empty_eigen(), "jacobi")
    assert sorted(large, key=lambda c: c[0]) == [
        ([6144], eigh_mod.jacobi_hostloop_solve), ([14336], eigh_mod.jacobi_hostloop_solve)]
    assert calls == {"jacobi": 0, "eigh": 0}


# ---------------------------------------------------------------------------
# Card only.
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize(
    "y,m,sweeps", [(780, 64, 2), (294, 64, 2), (77, 64, 1), (5, 32, 1), (300, 32, 2)]
)
def test_cuda_k2_matches_plain_version(y, m, sweeps):
    """Card only: each route's kernel repeats the plain version's IEEE
    operations in the same order (explicitly rounded intrinsics, no FMA), so
    the two agree to 1e-5 on the same card; V is orthogonal; the route's
    counter counts the launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain version only")
    s = torch.from_numpy(_sym_blocks(y, m, seed=y + m)).cuda()
    before = jacobi_pivot_rotations.launches
    counter = f"{jacobi_route(m)}_launches"
    route_before = getattr(jacobi_pivot_rotations, counter)
    got = jacobi_pivot_rotations(s, sweeps)
    want = jacobi_pivot_rotations_reference(s, sweeps)
    torch.cuda.synchronize()
    assert jacobi_pivot_rotations.launches == before + 1
    assert getattr(jacobi_pivot_rotations, counter) == route_before + 1
    assert float((got - want).abs().max()) <= 1e-5
    eye = torch.eye(m, device="cuda")
    assert float((got.transpose(1, 2) @ got - eye).abs().max()) < 1e-5


@pytest.mark.cuda
def test_cuda_jacobi_stage_launches_k2(covariances):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain version only")
    cuda32 = {k: {n: t.cuda() for n, t in v.items()} for k, v in covariances[1].items()}
    args = FactorArguments(eigendecomposition_dtype="float32", eigendecomposition_solver="jacobi")
    before = jacobi_pivot_rotations.launches
    eigh_batched.chunks.clear()
    out = perform_eigendecomposition(cuda32, args)
    torch.cuda.synchronize()
    want = sum(c["sweeps"] * c["rounds_per_sweep"] for c in eigh_batched.chunks)
    assert jacobi_pivot_rotations.launches - before == want > 0
    assert all(t.is_cuda for t in out[ACTIVATION_EIGENVECTORS_NAME].values())
