"""FFS (`kronfluence_tpu_torch/csrc/flash_forward_f32.cu`), the fp32 forward
route at D 128 and 256 ("tiled_f32"), against JAX: a blocked emulation of the
kernel's schedule, the wrapper on CPU tensors and the autograd Function,
held against JAX's flash-attention reference (`mha_reference_no_custom_vjp`,
its O and its l and m from the same logits, and its `jax.vjp`) on padded
segments. The CUDA kernel is compared with its plain version on the card by
the `cuda`-marked test and by chip_smoke.py.
"""

import math

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
from kronfluence_tpu_torch.ops.attention import FlashAttention, segment_ids_for
from kronfluence_tpu_torch.ops.kernels import flash
from kronfluence_tpu_torch.ops.kernels.flash import (
    MASK_VALUE,
    flash_forward_f32,
    flash_forward_reference,
    forward_route,
)
from tests.test_torch_flash_f32 import TOL, _close, _jax_vjp

# FFS's tiles: 64 query rows a CTA; key steps of 64 at D 128 and 32 at D 256
# as built, and 32 at D 128 in the copy that --profile-flash times.
QUERY_TILE = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def _inputs(t, d, dtype, seed):
    """(q, k, v, do, mask) at B 3, H 2: example 0 keeps 70 tokens, example 1
    keeps 100, example 2 is unpadded."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((3, 2, t, d)).astype(dtype) for _ in range(4))
    mask = np.ones((3, t), np.int32)
    mask[0, 70:] = 0
    mask[1, 100:] = 0
    return q, k, v, do, mask


def _jax_reference(q, k, v, mask):
    """JAX's (O, l, m): l and m from the reference's own masked logits."""
    seg = SegmentIds(q=jnp.asarray(mask), kv=jnp.asarray(mask))
    out = mha_reference_no_custom_vjp(*map(jnp.asarray, (q, k, v)), segment_ids=seg, causal=True,
                                      sm_scale=1.0 / math.sqrt(q.shape[-1]), save_residuals=True)
    return [np.asarray(x) for x in out]


def _ffs_schedule(q, k, v, seg, scale, keys):
    """FFS's schedule, blocked: for each 64-query tile the key steps of
    `keys` from key 0 to the tile's last row; logits s scale plus MASK_VALUE
    where masked (added, so every logit stays finite); an online softmax in
    natural-log units, P = exp(logit - running max), O and l rescaled by
    exp(old max - new max); O divided by l at the end. Asserts that O, l and
    m stay finite after every step, and returns (O, l, m) and the number of
    (example, row) pairs whose first key step held none of their keys."""
    b, h, t, d = q.shape
    o, l, m = torch.zeros_like(q), q.new_zeros(b, h, t), q.new_zeros(b, h, t)
    causal = torch.ones(t, t, dtype=torch.bool).tril()
    masked_first = 0
    for q0 in range(0, t, QUERY_TILE):
        rows = slice(q0, q0 + QUERY_TILE)
        acc = q.new_zeros(b, h, QUERY_TILE, d)
        mx = torch.full((b, h, QUERY_TILE), -math.inf, dtype=q.dtype)
        ls = q.new_zeros(b, h, QUERY_TILE)
        for k0 in range(0, q0 + QUERY_TILE, keys):
            cols = slice(k0, k0 + keys)
            keep = causal[rows, cols][None] & (seg[:, rows, None] == seg[:, None, cols])
            if k0 == 0:
                masked_first += int((~keep.any(-1)).sum())
            s = torch.matmul(q[:, :, rows], k[:, :, cols].transpose(-1, -2)) * scale
            s = torch.where(keep[:, None], s, s + MASK_VALUE)
            new_mx = torch.maximum(mx, s.amax(-1))
            alpha = torch.exp(mx - new_mx)
            p = torch.exp(s - new_mx[..., None])
            ls = ls * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.matmul(p, v[:, :, cols])
            mx = new_mx
            assert all(bool(torch.isfinite(x).all()) for x in (acc, ls, mx))
        o[:, :, rows], l[:, :, rows], m[:, :, rows] = acc / ls[..., None], ls, mx
    return (o, l, m), masked_first


@pytest.mark.parametrize("d,keys", [(128, 32), (128, 64), (256, 32)])
@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ffs_schedule_matches_jax_reference(dtype, t, d, keys):
    """FFS's schedule, held against JAX's reference (O, l and m) on padded
    segments, at both head dims and the key steps built or timed. Padded
    rows of example 0 (segment 0 from token 70; row 100 among them) meet
    keys 0 to keys - 1, all of segment 1, first: the step is wholly masked
    for them, and their running max, sum and O stay finite through it."""
    q, k, v, _, mask = _inputs(t, d, dtype, seed=t + d + keys)
    want = _jax_reference(q, k, v, mask)
    tq, tk, tv, tmask = map(torch.from_numpy, (q, k, v, mask))
    got, masked_first = _ffs_schedule(tq, tk, tv, segment_ids_for(tmask, tq),
                                      1.0 / math.sqrt(d), keys)
    assert masked_first >= t - 70
    for x, y in zip(got, want):
        assert bool(torch.isfinite(x).all())
        _close(x, y, TOL[dtype])


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ffs_wrapper_matches_jax_reference(dtype, d):
    """On CPU tensors FFS's wrapper takes the plain version and gives JAX's
    O, l and m, without counting a launch."""
    q, k, v, _, mask = _inputs(256, d, dtype, seed=d + 5)
    want = _jax_reference(q, k, v, mask)
    tq, tk, tv, tmask = map(torch.from_numpy, (q, k, v, mask))
    seg = segment_ids_for(tmask, tq)
    before = flash_forward_f32.launches
    got = flash_forward_f32(tq, tk, tv, seg, 1.0 / math.sqrt(d))
    assert flash_forward_f32.launches == before
    plain = flash_forward_reference(tq, tk, tv, seg, 1.0 / math.sqrt(d))
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    for x, y in zip(got, want):
        _close(x, y, TOL[dtype])


def test_ffs_wrapper_rejects_other_devices():
    x = torch.empty((1, 1, 128, 128), dtype=torch.float32, device="meta")
    seg = torch.empty((1, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        flash_forward_f32(x, x, x, seg, 0.125)


@pytest.mark.parametrize("dtype,d,t,match", [
    (torch.bfloat16, 128, 128, "tiled_f32"), (torch.bfloat16, 256, 128, "tiled_f32"),
    (torch.float16, 128, 128, "tiled_f32"), (torch.float64, 256, 128, "tiled_f32"),
    (torch.float32, 64, 128, "tiled_f32"), (torch.float32, 128, 96, "multiple of 64"),
    (torch.float32, 256, 160, "multiple of 64"),
])
def test_ffs_wrapper_rejects_off_route_operands(monkeypatch, dtype, d, t, match):
    """Off the CPU FFS takes only its route's operands, fp32 at D 128 or 256
    with T a multiple of 64: past the device and shape checks (stubbed here,
    where no card is), any other type, head dim or length raises rather than
    reaching the kernel."""
    monkeypatch.setattr(flash, "_check_cuda",
                        lambda tensors, seg, stats=(): tuple(tensors[0].shape))
    x = torch.empty((1, 1, t, d), dtype=dtype, device="meta")
    seg = torch.empty((1, t), dtype=torch.int32, device="meta")
    before = flash_forward_f32.launches
    with pytest.raises(ValueError, match=match):
        flash_forward_f32(x, x, x, seg, 0.125)
    assert flash_forward_f32.launches == before


@pytest.mark.parametrize("d,backward", [
    (128, ("flash_backward_dkv_f32_d128", "flash_backward_dq_f32_d128")),
    (256, ("flash_backward_dkv_f32_d256", "flash_backward_dq_f32_d256")),
])
def test_function_fp32_forward_goes_through_ffs_and_matches_jax(monkeypatch, d, backward):
    """FlashAttention in fp32 at D 128 and D 256 on CPU tensors: the forward
    calls FFS's wrapper (F1's never) and the backward the route's split pair
    (F2SH + F3SH at D 128, F2SW + F3SW at D 256), each taking its plain version;
    O is JAX's and the gradient JAX's VJP."""
    q, k, v, do, mask = _inputs(128, d, np.float32, seed=d + 9)
    want_o = _jax_reference(q, k, v, mask)[0]
    want = _jax_vjp(q, k, v, do, mask)
    tq, tk, tv, tdo, tmask = map(torch.from_numpy, (q, k, v, do, mask))
    names = ("flash_forward_f32", "flash_forward", "flash_backward_dkv_f32_d128",
             "flash_backward_dq_f32_d128", "flash_backward_dkv_f32_d256",
             "flash_backward_dq_f32_d256", "flash_backward_dkv", "flash_backward_dq")
    called = []
    for name in names:
        wrapper = getattr(attention, name)
        monkeypatch.setattr(attention, name,
                            lambda *args, _n=name, _w=wrapper: called.append(_n) or _w(*args))
    assert forward_route(tq.dtype, d) == "tiled_f32"
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = FlashAttention.apply(*leaves, segment_ids_for(tmask, tq), 1.0 / math.sqrt(d))
    grads = torch.autograd.grad(out, leaves, tdo)
    assert called == ["flash_forward_f32", *backward]
    _close(out, want_o, TOL[np.float32])
    for got, w in zip(grads, want):
        _close(got, w, TOL[np.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("t,d", [(256, 128), (512, 128), (256, 256), (512, 256)])
def test_cuda_ffs_matches_plain_version(t, d):
    """Card only: FFS against its plain version at every position of O, l
    and m at (2, 4, T, D) fp32, padded, within 1e-5 of the largest plain
    value (the same fp32 sums in another order), as chip_smoke.py holds it;
    two calls give the same bits; bf16, D 64 and T not a multiple of 64
    raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain versions only")
    g = torch.Generator("cuda").manual_seed(8)
    q, k, v = (torch.randn(2, 4, t, d, generator=g, device="cuda") for _ in range(3))
    seg = torch.ones(2, t, dtype=torch.int32, device="cuda")
    seg[1, t - 56:] = 0
    scale = d ** -0.5
    before = flash_forward_f32.launches
    got = flash_forward_f32(q, k, v, seg, scale)
    again = flash_forward_f32(q, k, v, seg, scale)
    assert flash_forward_f32.launches == before + 2
    want = flash_forward_reference(q, k, v, seg, scale)
    torch.cuda.synchronize()
    for x, x2, y in zip(got, again, want):
        assert torch.equal(x, x2)
        assert float((x - y).abs().max()) <= 1e-5 * float(y.abs().max())
    for bad in (q.to(torch.bfloat16), q[..., :64].contiguous(), q[:, :, :t - 32].contiguous()):
        with pytest.raises((ValueError, TypeError)):
            flash_forward_f32(bad, bad, bad, seg, scale)
