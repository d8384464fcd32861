"""FFW (`kronfluence_tpu_torch/csrc/flash_forward_d256.cu`), the bf16 D 256
forward route ("wgmma_w"), against JAX: a blocked emulation of the kernel's
schedule, the wrapper on CPU tensors, and the autograd Function, held against
JAX's flash-attention reference (`mha_reference_no_custom_vjp`, its O and its
l and m from the same logits, and its `jax.vjp`) at D 256. The CUDA kernel is
compared with its plain version on the card by the `cuda`-marked test and by
chip_smoke.py.
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
    flash_forward_d256,
    flash_forward_reference,
    forward_route,
)
from tests.test_torch_flash_d128 import _close, _jax_vjp
from tests.test_torch_flash_d256 import BF16_UNITS, _bf16_units
from tests.test_torch_flash_f32_d256 import BACKWARD_NAMES

# Relative to the largest reference value, at every position: fp64 sums in
# another order agree to ~1e-15; fp32 to a few ulps of the partial sums.
TOL = {np.float64: 1e-10, np.float32: 1e-5}
D = 256
# FFW's tiles: 128 query rows a CTA, 64 a warpgroup, 64 keys a loop step.
QUERY_TILE, GROUP_ROWS, KEY_TILE = 128, 64, 64
# Every forward wrapper `FlashAttention.forward` may call.
FORWARD_NAMES = ("flash_forward", "flash_forward_pipelined", "flash_forward_d128",
                 "flash_forward_d256", "flash_forward_f32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def _inputs(t, dtype, seed, padded=True):
    """(q, k, v, mask) at B 3, H 2, D 256; padded: example 0 keeps 70 tokens,
    example 1 keeps 100, example 2 is unpadded; else no example is padded."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((3, 2, t, D)).astype(dtype) for _ in range(3))
    mask = np.ones((3, t), np.int32)
    if padded:
        mask[0, 70:] = 0
        mask[1, 100:] = 0
    return q, k, v, mask


def _jax_reference(q, k, v, mask):
    """JAX's (O, l, m): l and m from the reference's own masked logits."""
    seg = SegmentIds(q=jnp.asarray(mask), kv=jnp.asarray(mask))
    out = mha_reference_no_custom_vjp(*map(jnp.asarray, (q, k, v)), segment_ids=seg, causal=True,
                                      sm_scale=1.0 / math.sqrt(D), save_residuals=True)
    return [np.asarray(x) for x in out]


def _ffw_schedule(q, k, v, seg, scale, diagonal_mask=True):
    """FFW's schedule, blocked: for each 128-query tile and each warpgroup's
    64 rows, the key tiles from the query tile's last down to 0, the tile
    above the warpgroup's rows skipped (warpgroup 0 skips the CTA's last);
    the mask only on the warpgroup's diagonal tile and on tiles whose query
    tile and key tile do not all hold one segment id (per example, as the
    CTA's vote decides); a base-2 online softmax on the raw scores, P = 2^(s
    c - max c) with c = scale log2 e against the running max, rescaled by
    2^((old max - new max) c); l sums P before it is rounded to the operand
    type for P V; a masked P exactly 0. `diagonal_mask=False` plants a fault:
    the diagonal tile taken for one below it. Returns (O, l, m), m in
    natural-log units."""
    b, h, t, d = q.shape
    c = scale * math.log2(math.e)
    o, l, m = torch.zeros_like(q), q.new_zeros(b, h, t), q.new_zeros(b, h, t)
    causal = torch.ones(t, t, dtype=torch.bool).tril()
    for q0 in range(0, t, QUERY_TILE):
        sq = seg[:, q0:q0 + QUERY_TILE]
        q_one = (sq == sq[:, :1]).all(1)
        kt_last = (q0 + QUERY_TILE - 1) // KEY_TILE
        for rw in range(0, QUERY_TILE, GROUP_ROWS):
            own = slice(q0 + rw, q0 + rw + GROUP_ROWS)
            kt_diag = (q0 + rw) // KEY_TILE
            acc = q.new_zeros(b, h, GROUP_ROWS, d)
            mx = torch.full((b, h, GROUP_ROWS), -math.inf, dtype=q.dtype)
            ls = q.new_zeros(b, h, GROUP_ROWS)
            for kt in range(kt_last, -1, -1):
                if kt > kt_diag:
                    continue  # the tile lies wholly above the warpgroup's rows
                cols = slice(kt * KEY_TILE, (kt + 1) * KEY_TILE)
                sk = seg[:, cols]
                uniform = q_one & (sk == sq[:, :1]).all(1)
                need = ~uniform | (kt == kt_diag and diagonal_mask)
                keep = causal[own, cols][None] & (seg[:, own, None] == sk[:, None, :])
                keep = (keep | ~need[:, None, None])[:, None]
                s = torch.matmul(q[:, :, own], k[:, :, cols].transpose(-1, -2))
                new_mx = torch.maximum(mx, torch.where(keep, s, -math.inf).amax(-1))
                alpha = torch.exp2((mx - new_mx) * c)
                p = torch.where(keep, torch.exp2(s * c - (new_mx * c)[..., None]), 0.0)
                ls = ls * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.matmul(p.to(v.dtype), v[:, :, cols])
                mx = new_mx
            o[:, :, own], l[:, :, own], m[:, :, own] = acc / ls[..., None], ls, mx * scale
    return o, l, m


@pytest.mark.parametrize("padded", [True, False])
@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ffw_schedule_matches_jax_reference(dtype, t, padded):
    """FFW's schedule, held against JAX's reference (O, l and m) at D 256. A
    padded row (segment 0) meets its diagonal tile first, so its running max
    is a real logit before any tile of valid keys, which gives it nothing;
    unpadded examples' tiles below the diagonal take the unmasked branch; in
    every CTA warpgroup 0 skips the tile above its rows."""
    q, k, v, mask = _inputs(t, dtype, seed=t + 7 + padded, padded=padded)
    want = _jax_reference(q, k, v, mask)
    tq, tk, tv, tmask = map(torch.from_numpy, (q, k, v, mask))
    got = _ffw_schedule(tq, tk, tv, segment_ids_for(tmask, tq), 1.0 / math.sqrt(D))
    for x, y in zip(got, want):
        _close(x, y, TOL[dtype])


def test_ffw_schedule_catches_a_diagonal_tile_taken_for_one_below():
    """The comparison has teeth: the schedule with the causal mask left off
    each warpgroup's diagonal tile (unpadded, so no vote masks it) is far
    off JAX's O."""
    q, k, v, mask = _inputs(256, np.float32, seed=12, padded=False)
    want = _jax_reference(q, k, v, mask)
    tq, tk, tv, tmask = map(torch.from_numpy, (q, k, v, mask))
    got = _ffw_schedule(tq, tk, tv, segment_ids_for(tmask, tq), 1.0 / math.sqrt(D),
                        diagonal_mask=False)
    err = float(np.abs(got[0].numpy() - want[0]).max())
    assert err > 1e3 * TOL[np.float32] * float(np.abs(want[0]).max())


@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ffw_wrapper_matches_jax_reference(dtype, t):
    """On CPU tensors FFW's wrapper takes the plain version and gives JAX's
    O, l and m, without counting a launch."""
    q, k, v, mask = _inputs(t, dtype, seed=t + 2)
    want = _jax_reference(q, k, v, mask)
    tq, tk, tv, tmask = map(torch.from_numpy, (q, k, v, mask))
    before = flash_forward_d256.launches
    got = flash_forward_d256(tq, tk, tv, segment_ids_for(tmask, tq), 1.0 / math.sqrt(D))
    assert flash_forward_d256.launches == before
    for x, y in zip(got, want):
        _close(x, y, TOL[dtype])


def test_cpu_ffw_wrapper_is_the_plain_version_in_bf16():
    q, k, v, mask = _inputs(128, np.float32, seed=3)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    seg = segment_ids_for(torch.from_numpy(mask), tq)
    assert forward_route(tq.dtype, D) == "wgmma_w"
    before = flash_forward_d256.launches
    got = flash_forward_d256(tq, tk, tv, seg, D ** -0.5)
    want = flash_forward_reference(tq, tk, tv, seg, D ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert flash_forward_d256.launches == before


def test_ffw_wrapper_rejects_other_devices():
    x = torch.empty((1, 1, 128, D), dtype=torch.bfloat16, device="meta")
    seg = torch.empty((1, 128), dtype=torch.int32, device="meta")
    before = flash_forward_d256.launches
    with pytest.raises(ValueError, match="CPU or CUDA"):
        flash_forward_d256(x, x, x, seg, 0.0625)
    assert flash_forward_d256.launches == before


@pytest.mark.parametrize("dtype,d", [(torch.float32, 256), (torch.float16, 256),
                                     (torch.float64, 256), (torch.bfloat16, 64),
                                     (torch.bfloat16, 128)])
def test_ffw_wrapper_rejects_other_dtypes_and_head_dims(dtype, d):
    """Off the CPU FFW's wrapper takes only its route's operands, bf16 at D
    256: any other type or head dim raises before any launch."""
    x = torch.empty((1, 1, 128, d), dtype=dtype, device="meta")
    seg = torch.empty((1, 128), dtype=torch.int32, device="meta")
    before = flash_forward_d256.launches
    with pytest.raises(ValueError, match="'wgmma_w'"):
        flash_forward_d256(x, x, x, seg, 0.0625)
    assert flash_forward_d256.launches == before


def test_ffw_wrapper_rejects_misaligned_segment_ids_and_ragged_tiles():
    """FFW copies each key tile's segment ids with a 16-byte bulk copy and
    takes 128-query tiles: segment ids that do not start on 16 bytes, or T
    not a multiple of 128, raise before any launch."""
    x = torch.empty((1, 1, 128, D), dtype=torch.bfloat16, device="meta")
    shifted = torch.empty(129, dtype=torch.int32, device="meta")[1:].view(1, 128)
    assert shifted.data_ptr() % 16
    before = flash_forward_d256.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_forward_d256(x, x, x, shifted, 0.0625)
    y = torch.empty((1, 1, 192, D), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="multiple of 128"):
        flash_forward_d256(y, y, y, torch.empty((1, 192), dtype=torch.int32, device="meta"),
                           0.0625)
    assert flash_forward_d256.launches == before


def _di_shift(q, k, mask, o, o_ref, do):
    """How JAX's fp32 VJP moves when di = rowsum(O∘dO) is taken from the
    Function's bf16 O (as FlashAttention.backward takes it from what the
    forward saved) instead of JAX's fp32 O: di shifts by δ = rowsum((O -
    O_ref)∘dO), so dS = P (dP - di) scale by -P δ scale, dQ by -scale δ (P K)
    and dK by -scale (P δ)ᵀ Q; dV not at all. In fp64 from the same inputs."""
    q, k, o, o_ref, do = (np.asarray(x, np.float64) for x in (q, k, o, o_ref, do))
    t, scale = q.shape[2], 1.0 / math.sqrt(D)
    keep = np.tril(np.ones((t, t), bool))[None] & (mask[:, :, None] == mask[:, None, :])
    s = np.where(keep[:, None], q @ k.swapaxes(-1, -2) * scale, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    delta = ((o - o_ref) * do).sum(-1)
    return (-scale * delta[..., None] * (p @ k), -scale * (p * delta[..., None]).swapaxes(-1, -2) @ q,
            np.zeros_like(o))


@pytest.mark.parametrize("t", [128, 256])
def test_function_bf16_d256_goes_through_ffw_and_matches_jax_vjp(monkeypatch, t):
    """FlashAttention at bf16 D 256 on CPU tensors: the forward calls FFW's
    wrapper and no other forward wrapper (F1's never), the backward F2W's and
    F3W's, all taking the plain versions without counting a launch. O is
    JAX's fp32 reference on the same bf16 values within the bf16 limit (P
    and O rounded to bf16), and so is the gradient JAX's fp32 VJP, once the
    VJP takes di from the Function's bf16 O as the backward does (`_di_shift`:
    in a row of few keys dP - di cancels, and O's rounding alone moves dQ by
    up to 25 bf16 units of its row)."""
    q, k, v, mask = _inputs(t, np.float32, seed=t + 5)
    do = np.random.default_rng(t).standard_normal(q.shape).astype(np.float32)
    # bf16 values, handed to JAX as those fp32 values.
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16).float().numpy() for x in (q, k, v, do))
    want_o = _jax_reference(q, k, v, mask)[0]
    want = _jax_vjp(q, k, v, do, mask)
    called = []
    for name in FORWARD_NAMES + BACKWARD_NAMES:
        wrapper = getattr(attention, name)
        monkeypatch.setattr(attention, name,
                            lambda *args, _n=name, _w=wrapper: called.append(_n) or _w(*args))
    wrappers = [getattr(flash, name) for name in FORWARD_NAMES + BACKWARD_NAMES]
    counts = [fn.launches for fn in wrappers]
    leaves = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v)]
    seg = segment_ids_for(torch.from_numpy(mask), leaves[0])
    out = FlashAttention.apply(*leaves, seg, 1.0 / math.sqrt(D))
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do).to(torch.bfloat16))
    assert called == ["flash_forward_d256", "flash_backward_dkv_d256", "flash_backward_dq_d256"]
    assert counts == [fn.launches for fn in wrappers]
    assert out.dtype == torch.bfloat16 and _bf16_units(out, want_o) <= BF16_UNITS
    shift = _di_shift(q, k, mask, out.detach().float().numpy(), want_o, do)
    for got, w, moved in zip(grads, want, shift):
        assert got.dtype == torch.bfloat16
        assert _bf16_units(got, np.asarray(w, np.float64) + moved) <= BF16_UNITS


@pytest.mark.cuda
@pytest.mark.parametrize("t,padded", [(256, True), (256, False), (512, True), (512, False)])
def test_cuda_ffw_matches_plain_version(t, padded):
    """Card only: FFW against its plain version at every position of O, each
    element to 8 bf16 unit roundoffs u = 2^-8 of its row's scale, u (|plain|
    + max |plain| of the row) + u^2 max |plain|, as chip_smoke.py holds it (P
    rounded to bf16 against a running rather than the final row max, sums in
    another order, O rounded to bf16); l and m to 1e-5 of their largest
    value (fp32 on both sides); two calls give the same bits; fp32, D 128
    and T not a multiple of FFW's 128-query tile raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain versions only")
    g = torch.Generator("cuda").manual_seed(5)
    q, k, v = (torch.randn(2, 4, t, D, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    seg = torch.ones(2, t, dtype=torch.int32, device="cuda")
    if padded:
        seg[1, t - 56:] = 0
    scale = D ** -0.5
    before = flash_forward_d256.launches
    got = flash_forward_d256(q, k, v, seg, scale)
    again = flash_forward_d256(q, k, v, seg, scale)
    assert flash_forward_d256.launches == before + 2
    ro, rl, rm = flash_forward_reference(q, k, v, seg, scale)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    x, y = got[0].float(), ro.float()
    size = y.abs()
    bound = 8 * (2.0 ** -8 * (size + size.amax(-1, keepdim=True)) + 2.0 ** -16 * size.max())
    assert bool(((x - y).abs() <= bound).all())
    for x, y in ((got[1], rl), (got[2], rm)):
        assert float((x - y).abs().max()) <= 1e-5 * float(y.abs().max())
    for bad in (q.float(), q[..., :128].contiguous(), q[:, :, :192].contiguous()):
        with pytest.raises((ValueError, TypeError)):
            flash_forward_d256(bad, bad, bad, seg, scale)
    assert flash_forward_d256.launches == before + 2
