"""F2H and F3H (`kronfluence_tpu_torch/csrc/flash_backward_d128.cu`), the
bf16 D 128 backward route ("split_h"), against JAX: a blocked emulation of
each kernel's schedule, and the wrappers on CPU tensors, held against JAX's
flash-attention reference (`mha_reference_no_custom_vjp` and its `jax.vjp`)
at D 128 on padded segments. The CUDA kernels are compared with their plain
versions on the card by the `cuda`-marked test and by chip_smoke.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
from jax.experimental.pallas.ops.tpu.flash_attention import (
    SegmentIds,
    mha_reference_no_custom_vjp,
)

from kronfluence_tpu_torch.ops.attention import output_dot, segment_ids_for
from kronfluence_tpu_torch.ops.kernels.flash import (
    backward_route,
    flash_backward_dkv_d128,
    flash_backward_dkv_reference,
    flash_backward_dq_d128,
    flash_backward_dq_reference,
    flash_forward_reference,
)

# Relative to the largest reference value, at every position: fp64 sums in
# another order agree to ~1e-15; fp32 to a few ulps of the partial sums.
TOL = {np.float64: 1e-10, np.float32: 1e-5}
D = 128
# The kernels' tiles: F2H 64 keys a CTA and 32 queries a step, F3H 64 queries
# a CTA and 64 keys a step.
KEY_TILE, QUERY_STEP, QUERY_TILE = 64, 32, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def _inputs(t, dtype, seed):
    """(q, k, v, do, mask) at B 3, H 2, D 128: example 0 keeps 70 tokens,
    example 1 keeps 100, example 2 is unpadded."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((3, 2, t, D)).astype(dtype) for _ in range(4))
    mask = np.ones((3, t), np.int32)
    mask[0, 70:] = 0
    mask[1, 100:] = 0
    return q, k, v, do, mask


def _jax_vjp(q, k, v, do, mask):
    seg = SegmentIds(q=jnp.asarray(mask), kv=jnp.asarray(mask))
    scale = 1.0 / math.sqrt(q.shape[-1])

    def fwd(q, k, v):
        return mha_reference_no_custom_vjp(q, k, v, segment_ids=seg, causal=True, sm_scale=scale)

    _, vjp = jax.vjp(fwd, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol, atol=tol * np.abs(want).max())


def _probabilities(s, rows, keep, l, m, scale):
    """P as the kernels form it: 2^(s scale log2 e - m log2 e) / l with 1/l
    taken once per query row, exactly 0 where `keep` is False. `s` is
    (B, H, keys, queries) when `rows` is False, else (B, H, queries, keys)."""
    log2e = math.log2(math.e)
    m2, rl = m * log2e, 1.0 / l
    m2, rl = (m2[..., None], rl[..., None]) if rows else (m2[:, :, None, :], rl[:, :, None, :])
    return torch.where(keep, torch.exp2(s * (scale * log2e) - m2) * rl, 0.0)


def _dkv_schedule(q, k, v, seg, l, m, do, di, scale):
    """F2H's schedule, blocked: for each 64-key tile the 32-query steps from
    the diagonal to T; the mask only on the steps the diagonal crosses and on
    steps whose key and query segment ids are not all one id (per example, as
    the CTA's vote decides); query 16-blocks wholly above a 16-key row group
    skipped on the masked steps. Returns (dK, dV)."""
    b, h, t, d = q.shape
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    causal = torch.ones(t, t, dtype=torch.bool).tril()
    for k0 in range(0, t, KEY_TILE):
        cols = slice(k0, k0 + KEY_TILE)
        sk = seg[:, cols]
        k_one = (sk == sk[:, :1]).all(1)
        acc_k = q.new_zeros(b, h, KEY_TILE, d)
        acc_v = q.new_zeros(b, h, KEY_TILE, d)
        for q0 in range(k0, t, QUERY_STEP):
            rows = slice(q0, q0 + QUERY_STEP)
            sq = seg[:, rows]
            uniform = k_one & (sq == sk[:, :1]).all(1)
            need = ~uniform if q0 >= k0 + KEY_TILE else torch.ones_like(uniform)
            keep = causal[rows, cols].T[None] & (sk[:, :, None] == sq[:, None, :])
            keep = (keep | ~need[:, None, None])[:, None]
            for kr in range(0, KEY_TILE, 16):
                jp_first = max(0, (k0 + kr - q0) // 16)
                if jp_first * 16 >= QUERY_STEP:
                    continue  # the step lies wholly above these keys
                keys = slice(kr, kr + 16)
                live = slice(q0 + 16 * jp_first, q0 + QUERY_STEP)
                qcols = slice(16 * jp_first, QUERY_STEP)
                st = torch.matmul(k[:, :, cols][:, :, keys], q[:, :, live].transpose(-1, -2))
                dpt = torch.matmul(v[:, :, cols][:, :, keys], do[:, :, live].transpose(-1, -2))
                p = _probabilities(st, False, keep[:, :, keys, qcols], l[:, :, live], m[:, :, live],
                                   scale)
                ds = p * (dpt - di[:, :, live][:, :, None, :]) * scale
                acc_v[:, :, keys] += torch.matmul(p, do[:, :, live])
                acc_k[:, :, keys] += torch.matmul(ds, q[:, :, live])
        dk[:, :, cols], dv[:, :, cols] = acc_k, acc_v
    return dk, dv


def _dq_schedule(q, k, v, seg, l, m, do, di, scale):
    """F3H's schedule, blocked: for each 64-query tile the 64-key tiles from 0
    to the diagonal; the mask only on the diagonal tile and on tiles whose
    query and key segment ids are not all one id (per example); on the
    diagonal, key 16-blocks wholly above a 16-row group skipped. Returns dQ."""
    b, h, t, d = q.shape
    dq = torch.zeros_like(q)
    causal = torch.ones(t, t, dtype=torch.bool).tril()
    for q0 in range(0, t, QUERY_TILE):
        rows = slice(q0, q0 + QUERY_TILE)
        sq = seg[:, rows]
        q_one = (sq == sq[:, :1]).all(1)
        for rw in range(0, QUERY_TILE, 16):
            own = slice(q0 + rw, q0 + rw + 16)
            acc = q.new_zeros(b, h, 16, d)
            for kt in range(q0 // KEY_TILE + 1):
                k0 = kt * KEY_TILE
                diag = k0 == q0
                last = k0 + (rw + 16 if diag else KEY_TILE)  # keys past the warp's rows skipped
                cols = slice(k0, last)
                sk = seg[:, k0:k0 + KEY_TILE]
                uniform = q_one & (sk == sq[:, :1]).all(1)
                need = torch.ones_like(uniform) if diag else ~uniform
                keep = causal[own, cols][None] & (seg[:, own, None] == seg[:, None, cols])
                keep = (keep | ~need[:, None, None])[:, None]
                s = torch.matmul(q[:, :, own], k[:, :, cols].transpose(-1, -2))
                dp = torch.matmul(do[:, :, own], v[:, :, cols].transpose(-1, -2))
                p = _probabilities(s, True, keep, l[:, :, own], m[:, :, own], scale)
                ds = p * (dp - di[:, :, own][..., None]) * scale
                acc += torch.matmul(ds, k[:, :, cols])
            dq[:, :, own] = acc
    return dq


def _forward(q, k, v, mask, scale):
    tq, tk, tv, tmask = map(torch.from_numpy, (q, k, v, mask))
    seg = segment_ids_for(tmask, tq)
    o, l, m = flash_forward_reference(tq, tk, tv, seg, scale)
    return tq, tk, tv, seg, o, l, m


@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_split_h_schedules_match_jax_vjp(dtype, t):
    """Both kernels' schedules, held against JAX's VJP (dQ, dK, dV) at D 128
    on padded segments. Example 2 is unpadded, so its steps below the
    diagonal take the unmasked branch; the padded examples' steps that cross
    a padding boundary are masked, and a padded row's tiles of valid keys
    give it nothing."""
    q, k, v, do, mask = _inputs(t, dtype, seed=t + 1)
    want = _jax_vjp(q, k, v, do, mask)
    scale = 1.0 / math.sqrt(D)
    tq, tk, tv, seg, o, l, m = _forward(q, k, v, mask, scale)
    tdo = torch.from_numpy(do)
    di = output_dot(o, tdo)
    dk, dv = _dkv_schedule(tq, tk, tv, seg, l, m, tdo, di, scale)
    dq = _dq_schedule(tq, tk, tv, seg, l, m, tdo, di, scale)
    for got, w in zip((dq, dk, dv), want):
        _close(got, w, TOL[dtype])


@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_split_h_wrappers_match_jax_vjp(dtype, t):
    """On CPU tensors F2H's and F3H's wrappers take the plain versions and
    give JAX's VJP, without counting a launch."""
    q, k, v, do, mask = _inputs(t, dtype, seed=t + 2)
    want = _jax_vjp(q, k, v, do, mask)
    scale = 1.0 / math.sqrt(D)
    tq, tk, tv, seg, o, l, m = _forward(q, k, v, mask, scale)
    tdo = torch.from_numpy(do)
    di = output_dot(o, tdo)
    counts = (flash_backward_dkv_d128.launches, flash_backward_dq_d128.launches)
    dk, dv = flash_backward_dkv_d128(tq, tk, tv, seg, l, m, tdo, di, scale)
    dq = flash_backward_dq_d128(tq, tk, tv, seg, l, m, tdo, di, scale)
    assert counts == (flash_backward_dkv_d128.launches, flash_backward_dq_d128.launches)
    for got, w in zip((dq, dk, dv), want):
        _close(got, w, TOL[dtype])


def test_cpu_split_h_wrappers_are_the_plain_versions_in_bf16():
    q, k, v, do, mask = _inputs(128, np.float32, seed=3)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do))
    seg = segment_ids_for(torch.from_numpy(mask), tq)
    o, l, m = flash_forward_reference(tq, tk, tv, seg, D ** -0.5)
    di = output_dot(o, tdo)
    args = (tq, tk, tv, seg, l, m, tdo, di, D ** -0.5)
    assert backward_route(tq.dtype, D) == "split_h"
    assert all(torch.equal(a, b) for a, b in zip(flash_backward_dkv_d128(*args),
                                                  flash_backward_dkv_reference(*args)))
    assert torch.equal(flash_backward_dq_d128(*args), flash_backward_dq_reference(*args))


@pytest.mark.parametrize("wrapper", [flash_backward_dkv_d128, flash_backward_dq_d128])
def test_split_h_wrappers_reject_other_devices(wrapper):
    x = torch.empty((1, 1, 128, D), dtype=torch.bfloat16, device="meta")
    seg = torch.empty((1, 128), dtype=torch.int32, device="meta")
    stat = torch.empty((1, 1, 128), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        wrapper(x, x, x, seg, stat, stat, x, stat, 0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [256, 512])
def test_cuda_split_h_kernels_match_plain_versions(t):
    """Card only: F2H and F3H against their plain versions at every position
    of dQ, dK and dV at (2, 4, T, 128), padded, each element to 8 bf16 unit
    roundoffs u = 2^-8 of its row's scale, u (|plain| + max |plain| of the
    row) + u^2 max |plain|, as chip_smoke.py holds them (P and dS rounded to
    bf16 from fp32 values that differ in the last bits, sums in another
    order, outputs rounded to bf16); two calls give the same bits; fp32 and
    D 64 raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain versions only")
    g = torch.Generator("cuda").manual_seed(3)
    q, k, v, do = (torch.randn(2, 4, t, D, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    seg = torch.ones(2, t, dtype=torch.int32, device="cuda")
    seg[1, t - 56:] = 0
    scale = D ** -0.5
    o, l, m = flash_forward_reference(q, k, v, seg, scale)
    di = output_dot(o, do)
    args = (q, k, v, seg, l, m, do, di, scale)
    before = (flash_backward_dkv_d128.launches, flash_backward_dq_d128.launches)
    got = (flash_backward_dq_d128(*args), *flash_backward_dkv_d128(*args))
    again = (flash_backward_dq_d128(*args), *flash_backward_dkv_d128(*args))
    assert (flash_backward_dkv_d128.launches, flash_backward_dq_d128.launches) == (
        before[0] + 2, before[1] + 2)
    want = (flash_backward_dq_reference(*args), *flash_backward_dkv_reference(*args))
    torch.cuda.synchronize()
    for x, x2, y in zip(got, again, want):
        assert torch.equal(x, x2)
        x, y = x.float(), y.float()
        size = y.abs()
        bound = 8 * (2.0 ** -8 * (size + size.amax(-1, keepdim=True)) + 2.0 ** -16 * size.max())
        assert bool(((x - y).abs() <= bound).all())
    for bad in (q.float(), q[..., :64].contiguous()):
        with pytest.raises((ValueError, TypeError)):
            flash_backward_dq_d128(bad, bad, bad, seg, l, m, bad, di, scale)
