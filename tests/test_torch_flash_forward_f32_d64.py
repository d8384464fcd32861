"""FFS64 (`kronfluence_tpu_torch/csrc/flash_forward_f32_d64.cu`), the fp32
forward route at D 64 ("tiled_f32_64"), against JAX: a blocked emulation of
the kernel's schedule, the wrapper on CPU tensors and the autograd Function,
held against JAX's flash-attention reference (`mha_reference_no_custom_vjp`,
its O and its l and m from the same logits, and its `jax.vjp`) on padded
segments. The CUDA kernel is compared with its plain version on the card by
the `cuda`-marked test and by chip_smoke.py.
"""

import math

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from kronfluence_tpu_torch.ops import attention
from kronfluence_tpu_torch.ops.attention import FlashAttention, segment_ids_for
from kronfluence_tpu_torch.ops.kernels import flash
from kronfluence_tpu_torch.ops.kernels.flash import (
    MASK_VALUE,
    flash_forward,
    flash_forward_f32_d64,
    flash_forward_reference,
    forward_route,
)
from tests.test_torch_flash_f32 import TOL, _close, _jax_vjp
from tests.test_torch_flash_forward_f32 import _jax_reference

D = 64
# FFS64's tiles: 128 query rows a CTA, 16 rows a warp, 64 keys a step; the
# 8 lanes of a row hold keys 4 c to 4 c + 3 and 32 + 4 c to 32 + 4 c + 3 (c <
# 8) of a step.
QUERY_TILE, WARP_ROWS, KEY_STEP, LANES = 128, 16, 64, 8


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


def _lane_sum(parts):
    """The kernel's sum of a row's 8 lane partials (..., 8): shuffles across
    lanes 4, 8 and 16 apart, lane c holding part c."""
    p = parts
    return ((p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])) + (
        (p[..., 4] + p[..., 5]) + (p[..., 6] + p[..., 7]))


def _ffs64_schedule(q, k, v, seg, scale, skip=True):
    """FFS64's schedule, blocked, per example (its segment ids decide the
    mask): for each 128-query tile and each warp's 16 rows the 64-key steps
    from key 0 to the tile's last row, a step past the warp's last row
    skipped (with `skip`); logits s scale plus MASK_VALUE where masked
    (added, so every logit stays finite); an online softmax in natural-log
    units, P = exp(logit - running max), O and each lane's partial row sum
    rescaled by exp(old max - new max); O divided at the end by the lanes'
    sum. Returns (O, l, m) and the number of (warp, step) units of the whole
    call that were skipped."""
    b, h, t, d = q.shape
    o, l, m = torch.zeros_like(q), q.new_zeros(b, h, t), q.new_zeros(b, h, t)
    causal = torch.ones(t, t, dtype=torch.bool).tril()
    # Lane of each key of a step: key 4 c + v and 32 + 4 c + v belong to lane c.
    lane_of_key = (torch.arange(KEY_STEP) % 32) // 4
    skipped = 0
    for e in range(b):
        for q0 in range(0, t, QUERY_TILE):
            for r0 in range(q0, q0 + QUERY_TILE, WARP_ROWS):
                rows = slice(r0, r0 + WARP_ROWS)
                acc = q.new_zeros(h, WARP_ROWS, d)
                mx = torch.full((h, WARP_ROWS), -math.inf, dtype=q.dtype)
                parts = q.new_zeros(h, WARP_ROWS, LANES)
                for k0 in range(0, q0 + QUERY_TILE, KEY_STEP):
                    if skip and k0 > r0 + WARP_ROWS - 1:
                        skipped += 1
                        continue
                    cols = slice(k0, k0 + KEY_STEP)
                    keep = causal[rows, cols] & (seg[e, rows, None] == seg[e, None, cols])
                    s = torch.matmul(q[e, :, rows], k[e, :, cols].transpose(-1, -2)) * scale
                    s = torch.where(keep[None], s, s + MASK_VALUE)
                    new_mx = torch.maximum(mx, s.amax(-1))
                    alpha = torch.exp(mx - new_mx)
                    p = torch.exp(s - new_mx[..., None])
                    lane_sums = torch.stack([p[..., lane_of_key == c].sum(-1)
                                             for c in range(LANES)], -1)
                    parts = parts * alpha[..., None] + lane_sums
                    acc = acc * alpha[..., None] + torch.matmul(p, v[e, :, cols])
                    mx = new_mx
                    assert all(bool(torch.isfinite(x).all()) for x in (acc, parts, mx))
                ls = _lane_sum(parts)
                o[e, :, rows], l[e, :, rows], m[e, :, rows] = acc / ls[..., None], ls, mx
    return (o, l, m), skipped


@pytest.mark.parametrize("t", [128, 256, 512])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ffs64_schedule_matches_jax_reference(dtype, t):
    """FFS64's schedule, held against JAX's reference (O, l and m) on padded
    segments. Padded rows of example 0 (segment 0 from token 70) meet keys 0
    to 63, all of segment 1, first: the step is wholly masked for them, and
    their running max, sum and O stay finite through it."""
    q, k, v, _, mask = _inputs(t, dtype, seed=t + 1)
    want = _jax_reference(q, k, v, mask)
    tq, tk, tv, tmask = map(torch.from_numpy, (q, k, v, mask))
    got, skipped = _ffs64_schedule(tq, tk, tv, segment_ids_for(tmask, tq), 1.0 / math.sqrt(D))
    # Four of a tile's eight warps skip its last step.
    assert skipped == 3 * 4 * (t // QUERY_TILE)
    for x, y in zip(got, want):
        assert bool(torch.isfinite(x).all())
        _close(x, y, TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ffs64_diagonal_skip_changes_no_bit(dtype):
    """A step past a warp's last row adds exactly 0 to O and l (exp of a
    masked logit against a kept row max) and rescales by exactly 1: the
    schedule with and without the skip gives the same bits."""
    q, k, v, _, mask = _inputs(256, dtype, seed=3)
    tq, tk, tv, tmask = map(torch.from_numpy, (q, k, v, mask))
    seg = segment_ids_for(tmask, tq)
    skipped, n = _ffs64_schedule(tq, tk, tv, seg, 1.0 / math.sqrt(D))
    full, none = _ffs64_schedule(tq, tk, tv, seg, 1.0 / math.sqrt(D), skip=False)
    assert n > 0 and none == 0
    for x, y in zip(skipped, full):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ffs64_wrapper_matches_jax_reference(dtype):
    """On CPU tensors FFS64's wrapper takes the plain version and gives JAX's
    O, l and m, without counting a launch."""
    q, k, v, _, mask = _inputs(256, dtype, seed=7)
    want = _jax_reference(q, k, v, mask)
    tq, tk, tv, tmask = map(torch.from_numpy, (q, k, v, mask))
    seg = segment_ids_for(tmask, tq)
    before = flash_forward_f32_d64.launches
    got = flash_forward_f32_d64(tq, tk, tv, seg, 1.0 / math.sqrt(D))
    assert flash_forward_f32_d64.launches == before
    plain = flash_forward_reference(tq, tk, tv, seg, 1.0 / math.sqrt(D))
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    for x, y in zip(got, want):
        _close(x, y, TOL[dtype])


def test_ffs64_wrapper_rejects_other_devices():
    x = torch.empty((1, 1, 128, D), dtype=torch.float32, device="meta")
    seg = torch.empty((1, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        flash_forward_f32_d64(x, x, x, seg, 0.125)


@pytest.mark.parametrize("dtype,d,t,match", [
    (torch.bfloat16, 64, 128, "tiled_f32_64"), (torch.float16, 64, 128, "tiled_f32_64"),
    (torch.float64, 64, 128, "tiled_f32_64"), (torch.float32, 128, 128, "tiled_f32_64"),
    (torch.float32, 256, 128, "tiled_f32_64"), (torch.float32, 64, 64, "multiple of 128"),
    (torch.float32, 64, 192, "multiple of 128"),
])
def test_ffs64_wrapper_rejects_off_route_operands(monkeypatch, dtype, d, t, match):
    """Off the CPU FFS64 takes only its route's operands, fp32 at D 64 with T
    a multiple of 128: past the device and shape checks (stubbed here, where
    no card is), any other type, head dim or length raises rather than
    reaching the kernel."""
    monkeypatch.setattr(flash, "_check_cuda",
                        lambda tensors, seg, stats=(): tuple(tensors[0].shape))
    x = torch.empty((1, 1, t, d), dtype=dtype, device="meta")
    seg = torch.empty((1, t), dtype=torch.int32, device="meta")
    before = flash_forward_f32_d64.launches
    with pytest.raises(ValueError, match=match):
        flash_forward_f32_d64(x, x, x, seg, 0.125)
    assert flash_forward_f32_d64.launches == before


def test_no_kernel_operand_reaches_the_generic_forward():
    """Since FFS64 took fp32 at D 64, no type and head dim the kernels take
    reaches F1's "generic" forward route."""
    assert all(forward_route(dtype, d) != "generic"
               for dtype in (torch.bfloat16, torch.float32) for d in flash.HEAD_DIMS)


@pytest.mark.parametrize("t", [128, 256])
def test_function_fp32_d64_forward_goes_through_ffs64_and_matches_jax(monkeypatch, t):
    """FlashAttention in fp32 at D 64 on CPU tensors: the forward calls
    FFS64's wrapper (F1's never) and the backward F2S + F3S, each taking its
    plain version; O is JAX's and the gradient JAX's VJP."""
    q, k, v, do, mask = _inputs(t, np.float32, seed=t + 9)
    want_o = _jax_reference(q, k, v, mask)[0]
    want = _jax_vjp(q, k, v, do, mask)
    tq, tk, tv, tdo, tmask = map(torch.from_numpy, (q, k, v, do, mask))
    names = ("flash_forward_f32_d64", "flash_forward", "flash_forward_f32",
             "flash_backward_dkv_f32", "flash_backward_dq_f32", "flash_backward_dkv",
             "flash_backward_dq")
    called = []
    for name in names:
        wrapper = getattr(attention, name)
        monkeypatch.setattr(attention, name,
                            lambda *args, _n=name, _w=wrapper: called.append(_n) or _w(*args))
    counts = (flash_forward_f32_d64.launches, flash_forward.launches)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = FlashAttention.apply(*leaves, segment_ids_for(tmask, tq), 1.0 / math.sqrt(D))
    grads = torch.autograd.grad(out, leaves, tdo)
    assert called == ["flash_forward_f32_d64", "flash_backward_dkv_f32", "flash_backward_dq_f32"]
    assert counts == (flash_forward_f32_d64.launches, flash_forward.launches)
    _close(out, want_o, TOL[np.float32])
    for got, w in zip(grads, want):
        _close(got, w, TOL[np.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("t", [128, 256, 512])
def test_cuda_ffs64_matches_plain_version(t):
    """Card only: FFS64 against its plain version at every position of O, l
    and m at (2, 4, T, 64) fp32, padded, within 1e-5 of the largest plain
    value (the same fp32 sums in another order), as chip_smoke.py holds it;
    two calls give the same bits and count two launches; bf16, D 128 and T
    not a multiple of 128 raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain versions only")
    g = torch.Generator("cuda").manual_seed(11)
    q, k, v = (torch.randn(2, 4, t, D, generator=g, device="cuda") for _ in range(3))
    seg = torch.ones(2, t, dtype=torch.int32, device="cuda")
    seg[1, t - 56:] = 0
    scale = D ** -0.5
    before = flash_forward_f32_d64.launches
    got = flash_forward_f32_d64(q, k, v, seg, scale)
    again = flash_forward_f32_d64(q, k, v, seg, scale)
    assert flash_forward_f32_d64.launches == before + 2
    want = flash_forward_reference(q, k, v, seg, scale)
    torch.cuda.synchronize()
    for x, x2, y in zip(got, again, want):
        assert torch.equal(x, x2)
        assert float((x - y).abs().max()) <= 1e-5 * float(y.abs().max())
    for bad in (q.to(torch.bfloat16), torch.randn(2, 4, t, 128, device="cuda"),
                q[:, :, :t - 64].contiguous()):
        with pytest.raises((ValueError, TypeError)):
            flash_forward_f32_d64(bad, bad, bad, seg[:, :bad.shape[2]].contiguous(), scale)
