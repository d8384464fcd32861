"""The port's low-rank factorisations (kronfluence_tpu_torch/ops/svd.py)
against kronfluence_tpu/ops/svd.py on seeded fp64 batches.

Singular vectors differ in sign between LAPACK builds, so the tests compare
the rebuilt block left @ right and the singular values (the column norms of
left), never raw vectors. The randomized SVD draws its sketch from another
RNG in each package: given JAX's own draw through the sketch helper it must
match the JAX function; with its own generator it is held by the error
bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from kronfluence_tpu.ops.svd import lowrank_factors_full as jax_full
from kronfluence_tpu.ops.svd import lowrank_factors_randomized as jax_randomized
from kronfluence_tpu_torch.ops.svd import (
    _lowrank_factors_from_sketch,
    lowrank_factors_full,
    lowrank_factors_randomized,
    sketch_width,
)

# (queries, out_dim, in_dim, rank): tall, wide, and a rank whose sketch is
# capped by min(o, i).
SHAPES = [(3, 24, 17, 4), (2, 13, 30, 6), (2, 12, 11, 5)]


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread for numpy's host eigh: OpenBLAS's thread team spins
    against the suite's other workers (tests/test_torch_analyzer_release.py)."""
    with threadpool_limits(limits=1):
        yield


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(q, o, i, seed, rank=None):
    """Seeded (q, o, i) fp64 gradients; of exact rank `rank` when given."""
    rng = np.random.default_rng(seed)
    if rank is None:
        return rng.standard_normal((q, o, i))
    return rng.standard_normal((q, o, rank)) @ rng.standard_normal((q, rank, i))


def _rebuilt(left, right):
    return np.asarray(left) @ np.asarray(right)


def _singular_values(left):
    return np.linalg.norm(np.asarray(left), axis=1)  # (q, r): S_r, columns of U S


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_full_svd_matches_jax(shape):
    q, o, i, rank = shape
    g = _batch(q, o, i, seed=sum(shape))
    jl, jr = jax_full(jnp.asarray(g), rank, jnp.float64)
    tl, tr = lowrank_factors_full(torch.from_numpy(g), rank, torch.float64)
    assert tl.shape == (q, o, rank) and tr.shape == (q, rank, i) and tl.dtype == torch.float64
    np.testing.assert_allclose(_rebuilt(tl, tr), _rebuilt(jl, jr), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(_singular_values(tl), _singular_values(jl), rtol=1e-10)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_randomized_svd_matches_jax_on_its_sketch(shape):
    """JAX's draw for the same key, fed to the port's steps after the draw."""
    q, o, i, rank = shape
    g = _batch(q, o, i, seed=sum(shape) + 1)
    key = jax.random.PRNGKey(7)
    k = sketch_width(torch.from_numpy(g), rank)
    omega = np.array(jax.random.normal(key, (q, i, k), jnp.float64))
    jl, jr = jax_randomized(jnp.asarray(g), rank, jnp.float64, key)
    tl, tr = _lowrank_factors_from_sketch(
        torch.from_numpy(g), rank, torch.float64, torch.from_numpy(omega)
    )
    np.testing.assert_allclose(_rebuilt(tl, tr), _rebuilt(jl, jr), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(_singular_values(tl), _singular_values(jl), rtol=1e-9)


@pytest.mark.parametrize("method", ["full", "randomized"])
def test_exact_rebuild_at_true_rank(method):
    q, o, i, rank = 3, 20, 14, 5
    g = torch.from_numpy(_batch(q, o, i, seed=3, rank=rank))
    if method == "full":
        left, right = lowrank_factors_full(g, rank, torch.float64)
    else:
        gen = torch.Generator().manual_seed(0)
        left, right = lowrank_factors_randomized(g, rank, torch.float64, gen)
    np.testing.assert_allclose(_rebuilt(left, right), g.numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randomized_error_within_bound_of_optimal(seed):
    """Eckart-Young: the best rank-r error is the singular-value tail; the
    randomized SVD through the port's own generator stays within 1.5x of it
    on a decaying spectrum."""
    q, o, i, rank = 2, 40, 30, 6
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((q, o, i)))
    v, _ = np.linalg.qr(rng.standard_normal((q, i, i)))
    s = 0.7 ** np.arange(i)
    g = torch.from_numpy((u * s[None, None, :]) @ v.transpose(0, 2, 1))
    gen = torch.Generator().manual_seed(seed)
    left, right = lowrank_factors_randomized(g, rank, torch.float64, gen)
    err = np.linalg.norm(g.numpy() - _rebuilt(left, right), axis=(1, 2))
    optimal = np.sqrt((s[rank:] ** 2).sum())
    assert np.all(err <= 1.5 * optimal), (err, optimal)
    full_l, full_r = lowrank_factors_full(g, rank, torch.float64)
    full_err = np.linalg.norm(g.numpy() - _rebuilt(full_l, full_r), axis=(1, 2))
    np.testing.assert_allclose(full_err, optimal, rtol=1e-9)


def test_randomized_is_reproducible_from_its_generator():
    g = torch.from_numpy(_batch(2, 16, 12, seed=4))
    a = lowrank_factors_randomized(g, 3, torch.float64, torch.Generator().manual_seed(5))
    b = lowrank_factors_randomized(g, 3, torch.float64, torch.Generator().manual_seed(5))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_factors_take_the_out_dtype():
    g = torch.from_numpy(_batch(2, 10, 9, seed=6)).to(torch.float32)
    for left, right in (
        lowrank_factors_full(g, 3, "bfloat16"),
        lowrank_factors_randomized(g, 3, "bfloat16", torch.Generator().manual_seed(0)),
    ):
        assert left.dtype == right.dtype == torch.bfloat16
        assert left.shape == (2, 10, 3) and right.shape == (2, 3, 9)
