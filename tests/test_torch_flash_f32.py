"""F2S and F3S (`kronfluence_tpu_torch/csrc/flash_backward_f32.cu`), the
fp32 D 64 backward route ("split_f32"), against JAX: a blocked emulation of
each kernel's schedule, the wrappers on CPU tensors and the autograd
Function, held against JAX's flash-attention reference
(`mha_reference_no_custom_vjp` and its `jax.vjp`) at D 64 on padded segments.
The CUDA kernels are compared with their plain versions on the card by the
`cuda`-marked test and by chip_smoke.py.
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

from kronfluence_tpu_torch.ops import attention
from kronfluence_tpu_torch.ops.attention import FlashAttention, output_dot, segment_ids_for
from kronfluence_tpu_torch.ops.kernels.flash import (
    backward_route,
    flash_backward_dkv,
    flash_backward_dkv_f32,
    flash_backward_dkv_reference,
    flash_backward_dq,
    flash_backward_dq_f32,
    flash_backward_dq_reference,
    flash_forward_reference,
)

# Relative to the largest reference value, at every position: fp64 sums in
# another order agree to ~1e-15; fp32 to a few ulps of the partial sums.
TOL = {np.float64: 1e-10, np.float32: 1e-5}
D = 64
# The kernels' tiles: F2S 64 keys a CTA and 32 queries a step, F3S 64 queries
# a CTA and 64 keys a step.
KEY_TILE, QUERY_STEP, QUERY_TILE, KEY_STEP = 64, 32, 64, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def _inputs(t, dtype, seed):
    """(q, k, v, do, mask) at B 3, H 2, D 64: example 0 keeps 70 tokens,
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


def _keep(seg, rows, cols):
    """(B, 1, len(rows), len(cols)) mask: key at or below the query, same segment."""
    t = seg.shape[1]
    causal = torch.ones(t, t, dtype=torch.bool).tril()
    return (causal[rows, cols][None] & (seg[:, rows, None] == seg[:, None, cols]))[:, None]


def _dkv_schedule(q, k, v, seg, l, m, do, di, scale):
    """F2S's schedule, blocked: for each 64-key tile the 32-query steps from
    the diagonal to T, every element masked (the steps at the diagonal and
    those that cross a padding boundary among them); P = exp(s scale - m)
    times 1/l of its query, exactly 0 where masked; dV += Pᵀ dO and
    dK += dSᵀ Q a step. Returns (dK, dV)."""
    t = q.shape[2]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, t, KEY_TILE):
        cols = slice(k0, k0 + KEY_TILE)
        acc_k, acc_v = torch.zeros_like(k[:, :, cols]), torch.zeros_like(v[:, :, cols])
        for q0 in range(k0, t, QUERY_STEP):
            rows = slice(q0, q0 + QUERY_STEP)
            keep = _keep(seg, rows, cols).transpose(-1, -2)  # (keys, queries)
            st = torch.matmul(k[:, :, cols], q[:, :, rows].transpose(-1, -2))
            dpt = torch.matmul(v[:, :, cols], do[:, :, rows].transpose(-1, -2))
            rl = 1.0 / l[:, :, rows][:, :, None, :]
            p = torch.where(keep, torch.exp(st * scale - m[:, :, rows][:, :, None, :]) * rl, 0.0)
            ds = p * (dpt - di[:, :, rows][:, :, None, :]) * scale
            acc_v += torch.matmul(p, do[:, :, rows])
            acc_k += torch.matmul(ds, q[:, :, rows])
        dk[:, :, cols], dv[:, :, cols] = acc_k, acc_v
    return dk, dv


def _dq_schedule(q, k, v, seg, l, m, do, di, scale):
    """F3S's schedule, blocked: for each 64-query tile the 64-key steps from 0
    to the diagonal, every element masked; dQ += dS K a step. Returns dQ."""
    t = q.shape[2]
    dq = torch.zeros_like(q)
    for q0 in range(0, t, QUERY_TILE):
        rows = slice(q0, q0 + QUERY_TILE)
        rl = 1.0 / l[:, :, rows][..., None]
        acc = torch.zeros_like(q[:, :, rows])
        for k0 in range(0, q0 + 1, KEY_STEP):
            cols = slice(k0, k0 + KEY_STEP)
            keep = _keep(seg, rows, cols)
            s = torch.matmul(q[:, :, rows], k[:, :, cols].transpose(-1, -2))
            dp = torch.matmul(do[:, :, rows], v[:, :, cols].transpose(-1, -2))
            p = torch.where(keep, torch.exp(s * scale - m[:, :, rows][..., None]) * rl, 0.0)
            ds = p * (dp - di[:, :, rows][..., None]) * scale
            acc += torch.matmul(ds, k[:, :, cols])
        dq[:, :, rows] = acc
    return dq


def _forward(q, k, v, mask, scale):
    tq, tk, tv, tmask = map(torch.from_numpy, (q, k, v, mask))
    seg = segment_ids_for(tmask, tq)
    o, l, m = flash_forward_reference(tq, tk, tv, seg, scale)
    return tq, tk, tv, seg, o, l, m


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_backward_route_takes_split_f32_at_fp32_d64_only(dtype, d):
    want = {(torch.float32, 64): "split_f32", (torch.bfloat16, 64): "fused",
            (torch.bfloat16, 128): "split_h", (torch.float32, 128): "split_f32_h",
            (torch.bfloat16, 256): "split_w",
            (torch.float32, 256): "split_f32_w"}.get((dtype, d), "split")
    assert backward_route(dtype, d) == want


@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_split_f32_schedules_match_jax_vjp(dtype, t):
    """Both kernels' schedules, held against JAX's VJP (dQ, dK, dV) at D 64
    on padded segments: the padded examples' steps that cross a padding
    boundary, and a padded row's tiles of valid keys, give what JAX gives."""
    q, k, v, do, mask = _inputs(t, dtype, seed=t + 11)
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
def test_split_f32_wrappers_match_jax_vjp(dtype, t):
    """On CPU tensors F2S's and F3S's wrappers take the plain versions, bit
    for bit, and give JAX's VJP, without counting a launch."""
    q, k, v, do, mask = _inputs(t, dtype, seed=t + 12)
    want = _jax_vjp(q, k, v, do, mask)
    scale = 1.0 / math.sqrt(D)
    tq, tk, tv, seg, o, l, m = _forward(q, k, v, mask, scale)
    tdo = torch.from_numpy(do)
    args = (tq, tk, tv, seg, l, m, tdo, output_dot(o, tdo), scale)
    counts = (flash_backward_dkv_f32.launches, flash_backward_dq_f32.launches)
    dk, dv = flash_backward_dkv_f32(*args)
    dq = flash_backward_dq_f32(*args)
    assert counts == (flash_backward_dkv_f32.launches, flash_backward_dq_f32.launches)
    plain = (*flash_backward_dkv_reference(*args), flash_backward_dq_reference(*args))
    assert all(torch.equal(a, b) for a, b in zip((dk, dv, dq), plain))
    for got, w in zip((dq, dk, dv), want):
        _close(got, w, TOL[dtype])


@pytest.mark.parametrize("wrapper", [flash_backward_dkv_f32, flash_backward_dq_f32])
def test_split_f32_wrappers_reject_other_devices(wrapper):
    x = torch.empty((1, 1, 128, D), dtype=torch.float32, device="meta")
    seg = torch.empty((1, 128), dtype=torch.int32, device="meta")
    stat = torch.empty((1, 1, 128), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        wrapper(x, x, x, seg, stat, stat, x, stat, 0.125)


@pytest.mark.parametrize("t", [128, 256])
def test_function_fp32_d64_gradient_goes_through_split_f32_and_matches_jax_vjp(monkeypatch, t):
    """FlashAttention's fp32 D 64 gradient on CPU tensors: the backward calls
    F2S's and F3S's wrappers (F2's and F3's never), which take the plain
    versions, and the gradient is JAX's VJP."""
    q, k, v, do, mask = _inputs(t, np.float32, seed=t + 13)
    want = _jax_vjp(q, k, v, do, mask)
    tq, tk, tv, tdo, tmask = map(torch.from_numpy, (q, k, v, do, mask))
    called = []
    for name in ("flash_backward_dkv_f32", "flash_backward_dq_f32", "flash_backward_dkv",
                 "flash_backward_dq"):
        wrapper = getattr(attention, name)
        monkeypatch.setattr(attention, name,
                            lambda *args, _n=name, _w=wrapper: called.append(_n) or _w(*args))
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    counts = [fn.launches for fn in (flash_backward_dkv_f32, flash_backward_dq_f32,
                                     flash_backward_dkv, flash_backward_dq)]
    out = FlashAttention.apply(*leaves, segment_ids_for(tmask, tq), 1.0 / math.sqrt(D))
    dq, dk, dv = torch.autograd.grad(out, leaves, tdo)
    assert called == ["flash_backward_dkv_f32", "flash_backward_dq_f32"]
    assert counts == [fn.launches for fn in (flash_backward_dkv_f32, flash_backward_dq_f32,
                                             flash_backward_dkv, flash_backward_dq)]
    for got, w in zip((dq, dk, dv), want):
        _close(got, w, TOL[np.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("t", [256, 512])
def test_cuda_split_f32_kernels_match_plain_versions(t):
    """Card only: F2S and F3S against their plain versions at every position
    of dQ, dK and dV at (2, 4, T, 64) fp32, padded, within 1e-5 of the
    largest plain value (the same fp32 sums in another order), as
    chip_smoke.py holds them; two calls give the same bits; bf16 and D 128
    raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain versions only")
    g = torch.Generator("cuda").manual_seed(5)
    q, k, v, do = (torch.randn(2, 4, t, D, generator=g, device="cuda") for _ in range(4))
    seg = torch.ones(2, t, dtype=torch.int32, device="cuda")
    seg[1, t - 56:] = 0
    scale = D ** -0.5
    o, l, m = flash_forward_reference(q, k, v, seg, scale)
    di = output_dot(o, do)
    args = (q, k, v, seg, l, m, do, di, scale)
    before = (flash_backward_dkv_f32.launches, flash_backward_dq_f32.launches)
    got = (flash_backward_dq_f32(*args), *flash_backward_dkv_f32(*args))
    again = (flash_backward_dq_f32(*args), *flash_backward_dkv_f32(*args))
    assert (flash_backward_dkv_f32.launches, flash_backward_dq_f32.launches) == (
        before[0] + 2, before[1] + 2)
    want = (flash_backward_dq_reference(*args), *flash_backward_dkv_reference(*args))
    torch.cuda.synchronize()
    for x, x2, y in zip(got, again, want):
        assert torch.equal(x, x2)
        assert float((x - y).abs().max()) <= 1e-5 * float(y.abs().max())
    for bad in (q.to(torch.bfloat16), torch.randn(2, 4, t, 128, device="cuda")):
        with pytest.raises((ValueError, TypeError)):
            flash_backward_dq_f32(bad, bad, bad, seg, l, m, bad, di, scale)
