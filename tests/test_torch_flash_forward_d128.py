"""FFH (`kronfluence_tpu_torch/csrc/flash_forward.cu` at D 128), the bf16 D
128 forward route ("pipelined_h"), against JAX: a blocked emulation of the
kernel's schedule, and the wrapper on CPU tensors, held against JAX's
flash-attention reference (`mha_reference_no_custom_vjp`, its O and its l
and m from the same logits) at D 128 on padded segments. The CUDA kernel is
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

from kronfluence_tpu_torch.ops.attention import segment_ids_for
from kronfluence_tpu_torch.ops.kernels.flash import (
    flash_forward_d128,
    flash_forward_reference,
    forward_route,
)

# Relative to the largest reference value, at every position: fp64 sums in
# another order agree to ~1e-15; fp32 to a few ulps of the partial sums.
TOL = {np.float64: 1e-10, np.float32: 1e-5}
D = 128
# FFH's tiles: 64 keys a loop step, 16 query rows a warp; the query tile is
# 128 as built and 64 in the copies that --profile-flash times.
KEY_TILE, WARP_ROWS = 64, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def _inputs(t, dtype, seed):
    """(q, k, v, mask) at B 3, H 2, D 128: example 0 keeps 70 tokens, example
    1 keeps 100, example 2 is unpadded."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((3, 2, t, D)).astype(dtype) for _ in range(3))
    mask = np.ones((3, t), np.int32)
    mask[0, 70:] = 0
    mask[1, 100:] = 0
    return q, k, v, mask


def _jax_reference(q, k, v, mask):
    """JAX's (O, l, m): l and m from the reference's own masked logits."""
    seg = SegmentIds(q=jnp.asarray(mask), kv=jnp.asarray(mask))
    out = mha_reference_no_custom_vjp(*map(jnp.asarray, (q, k, v)), segment_ids=seg, causal=True,
                                      sm_scale=1.0 / math.sqrt(D), save_residuals=True)
    return [np.asarray(x) for x in out]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol, atol=tol * np.abs(want).max())


def _ffh_schedule(q, k, v, seg, scale, query_tile):
    """FFH's schedule, blocked: for each query tile and each warp's 16 rows,
    the key tiles from the query tile's last down to 0, tiles above the
    warp's rows skipped; the mask only on the warp's diagonal tile and on
    tiles whose query tile and key tile do not all hold one segment id (per
    example, as the CTA's vote decides); a base-2 online softmax on the raw
    scores, P = 2^(s c - max c) with c = scale log2 e against the running
    max, rescaled by 2^((old max - new max) c); l sums P before it is
    rounded to the operand type for P V; a masked P exactly 0. Returns
    (O, l, m), m in natural-log units."""
    b, h, t, d = q.shape
    c = scale * math.log2(math.e)
    o, l, m = torch.zeros_like(q), q.new_zeros(b, h, t), q.new_zeros(b, h, t)
    causal = torch.ones(t, t, dtype=torch.bool).tril()
    for q0 in range(0, t, query_tile):
        sq = seg[:, q0:q0 + query_tile]
        q_one = (sq == sq[:, :1]).all(1)
        kt_last = (q0 + query_tile - 1) // KEY_TILE
        for rw in range(0, query_tile, WARP_ROWS):
            own = slice(q0 + rw, q0 + rw + WARP_ROWS)
            kt_diag = (q0 + rw) // KEY_TILE
            acc = q.new_zeros(b, h, WARP_ROWS, d)
            mx = torch.full((b, h, WARP_ROWS), -math.inf, dtype=q.dtype)
            ls = q.new_zeros(b, h, WARP_ROWS)
            for kt in range(kt_last, -1, -1):
                if kt > kt_diag:
                    continue  # the tile lies wholly above the warp's rows
                cols = slice(kt * KEY_TILE, (kt + 1) * KEY_TILE)
                sk = seg[:, cols]
                uniform = q_one & (sk == sq[:, :1]).all(1)
                need = torch.ones_like(uniform) if kt == kt_diag else ~uniform
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


@pytest.mark.parametrize("query_tile", [64, 128])
@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ffh_schedule_matches_jax_reference(dtype, t, query_tile):
    """FFH's schedule, held against JAX's reference (O, l and m) at D 128 on
    padded segments. A padded row (segment 0) meets its diagonal tile first,
    so its running max is a real logit before any tile of valid keys, which
    gives it nothing; example 2 is unpadded, so its tiles below the diagonal
    take the unmasked branch. At a 128-query tile (FFH's) the first four
    warps skip the tile above their rows."""
    q, k, v, mask = _inputs(t, dtype, seed=t + query_tile)
    want = _jax_reference(q, k, v, mask)
    tq, tk, tv, tmask = map(torch.from_numpy, (q, k, v, mask))
    got = _ffh_schedule(tq, tk, tv, segment_ids_for(tmask, tq), 1.0 / math.sqrt(D), query_tile)
    for x, y in zip(got, want):
        _close(x, y, TOL[dtype])


@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ffh_wrapper_matches_jax_reference(dtype, t):
    """On CPU tensors FFH's wrapper takes the plain version and gives JAX's
    O, l and m, without counting a launch."""
    q, k, v, mask = _inputs(t, dtype, seed=t + 2)
    want = _jax_reference(q, k, v, mask)
    tq, tk, tv, tmask = map(torch.from_numpy, (q, k, v, mask))
    before = flash_forward_d128.launches
    got = flash_forward_d128(tq, tk, tv, segment_ids_for(tmask, tq), 1.0 / math.sqrt(D))
    assert flash_forward_d128.launches == before
    for x, y in zip(got, want):
        _close(x, y, TOL[dtype])


def test_cpu_ffh_wrapper_is_the_plain_version_in_bf16():
    q, k, v, mask = _inputs(128, np.float32, seed=3)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    seg = segment_ids_for(torch.from_numpy(mask), tq)
    assert forward_route(tq.dtype, D) == "pipelined_h"
    before = flash_forward_d128.launches
    got = flash_forward_d128(tq, tk, tv, seg, D ** -0.5)
    want = flash_forward_reference(tq, tk, tv, seg, D ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert flash_forward_d128.launches == before


def test_ffh_wrapper_rejects_other_devices():
    x = torch.empty((1, 1, 128, D), dtype=torch.bfloat16, device="meta")
    seg = torch.empty((1, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        flash_forward_d128(x, x, x, seg, 0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("t,padded", [(256, True), (256, False), (512, True), (512, False)])
def test_cuda_ffh_matches_plain_version(t, padded):
    """Card only: FFH against its plain version at every position of O, each
    element to 8 bf16 unit roundoffs u = 2^-8 of its row's scale, u (|plain|
    + max |plain| of the row) + u^2 max |plain|, as chip_smoke.py holds it (P
    rounded to bf16 against a running rather than the final row max, sums in
    another order, O rounded to bf16); l and m to 1e-5 of their largest
    value (fp32 on both sides); two calls give the same bits; fp32, D 64 and
    T not a multiple of FFH's 128-query tile raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain versions only")
    g = torch.Generator("cuda").manual_seed(4)
    q, k, v = (torch.randn(2, 4, t, D, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    seg = torch.ones(2, t, dtype=torch.int32, device="cuda")
    if padded:
        seg[1, t - 56:] = 0
    scale = D ** -0.5
    before = flash_forward_d128.launches
    got = flash_forward_d128(q, k, v, seg, scale)
    again = flash_forward_d128(q, k, v, seg, scale)
    assert flash_forward_d128.launches == before + 2
    ro, rl, rm = flash_forward_reference(q, k, v, seg, scale)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    x, y = got[0].float(), ro.float()
    size = y.abs()
    bound = 8 * (2.0 ** -8 * (size + size.amax(-1, keepdim=True)) + 2.0 ** -16 * size.max())
    assert bool(((x - y).abs() <= bound).all())
    for x, y in ((got[1], rl), (got[2], rm)):
        assert float((x - y).abs().max()) <= 1e-5 * float(y.abs().max())
    for bad in (q.float(), q[..., :64].contiguous(), q[:, :, :192].contiguous()):
        with pytest.raises((ValueError, TypeError)):
            flash_forward_d128(bad, bad, bad, seg, scale)
