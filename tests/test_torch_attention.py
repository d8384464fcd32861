"""The port's attention module (`kronfluence_tpu_torch/ops/attention.py`)
against JAX: the plain versions of F1-F3, FF (the pipelined forward) and FB
(the fused backward) and the `FlashAttention` Function against JAX's
flash-attention reference (`mha_reference_no_custom_vjp` and its `jax.vjp`),
and against the JAX package's naive form at valid query rows; a blocked
emulation of FF's schedule against the same reference. On the CPU the
wrappers take their plain versions; the CUDA kernels are compared with them
on the card by chip_smoke.py and the `cuda`-marked tests.
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

from kronfluence_tpu.ops.attention import _naive_attention as jax_naive_attention
from kronfluence_tpu_torch.models.transformer import TransformerLM, tiny_config
from kronfluence_tpu_torch.models.transformer import naive_attention as model_naive_attention
from kronfluence_tpu_torch.ops.attention import (
    FlashAttention,
    flash_attention,
    flash_attention_backward_reference,
    flash_attention_reference,
    flash_supported,
    naive_attention,
    scaled_dot_attention,
    segment_ids_for,
)
from kronfluence_tpu_torch.ops import attention
from kronfluence_tpu_torch.ops.attention import output_dot
from kronfluence_tpu_torch.ops.kernels.flash import (
    backward_route,
    flash_backward,
    flash_backward_dkv,
    flash_backward_dkv_d128,
    flash_backward_dkv_d256,
    flash_backward_dkv_f32,
    flash_backward_dkv_f32_d128,
    flash_backward_dkv_f32_d256,
    flash_backward_dkv_reference,
    flash_backward_dq,
    flash_backward_dq_d128,
    flash_backward_dq_d256,
    flash_backward_dq_f32,
    flash_backward_dq_f32_d128,
    flash_backward_dq_f32_d256,
    flash_backward_dq_reference,
    flash_backward_reference,
    flash_forward,
    flash_forward_pipelined,
    flash_forward_reference,
    forward_route,
)

# Relative to the largest reference value, at every position: fp64 sums in
# another order agree to ~1e-15; fp32 to a few ulps of the partial sums.
TOL = {np.float64: 1e-10, np.float32: 1e-5}
CASES = [(t, d, dt) for t in (128, 256) for d in (64, 128) for dt in (np.float64, np.float32)]


def _inputs(b, h, t, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, h, t, d)).astype(dtype) for _ in range(4))
    mask = np.ones((b, t), np.int32)
    mask[1, t - t // 3:] = 0  # a padded example
    return q, k, v, do, mask


def _jax_reference(q, k, v, do, mask):
    seg = SegmentIds(q=jnp.asarray(mask), kv=jnp.asarray(mask))
    scale = 1.0 / math.sqrt(q.shape[-1])

    def fwd(q, k, v):
        return mha_reference_no_custom_vjp(q, k, v, segment_ids=seg, causal=True, sm_scale=scale)

    out, vjp = jax.vjp(fwd, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = vjp(jnp.asarray(do))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("t,d,dtype", CASES)
def test_plain_versions_match_jax_reference(t, d, dtype):
    q, k, v, do, mask = _inputs(2, 2, t, d, dtype)
    want_o, want_grads = _jax_reference(q, k, v, do, mask)
    tq, tk, tv, tdo, tmask = map(torch.from_numpy, (q, k, v, do, mask))
    o, l, m = flash_attention_reference(tq, tk, tv, tmask)
    _close(o, want_o, TOL[dtype])
    grads = flash_attention_backward_reference(tq, tk, tv, tmask, o, l, m, tdo)
    for got, want in zip(grads, want_grads):
        _close(got, want, TOL[dtype])


@pytest.mark.parametrize("t,d,dtype", CASES)
def test_function_matches_jax_vjp(t, d, dtype):
    q, k, v, do, mask = _inputs(2, 2, t, d, dtype, seed=1)
    want_o, want_grads = _jax_reference(q, k, v, do, mask)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, torch.from_numpy(mask))
    _close(out, want_o, TOL[dtype])
    out.backward(torch.from_numpy(do))
    for got, want in zip((tq.grad, tk.grad, tv.grad), want_grads):
        _close(got, want, TOL[dtype])


@pytest.mark.parametrize("d", [64, 128])
def test_flash_matches_jax_naive_at_valid_rows(d):
    """The forms differ at padded query rows only: outputs agree at valid
    rows, and gradients of a loss over valid rows agree everywhere."""
    q, k, v, do, mask = _inputs(2, 2, 128, d, np.float64, seed=2)
    do = do * mask[:, None, :, None]

    def loss(q, k, v):
        return jnp.sum(jax_naive_attention(q, k, v, jnp.asarray(mask)) * jnp.asarray(do))

    want_o = np.asarray(jax_naive_attention(*map(jnp.asarray, (q, k, v)), jnp.asarray(mask)))
    want_grads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = scaled_dot_attention(tq, tk, tv, torch.from_numpy(mask), "flash")
    valid = mask.astype(bool)
    for i in range(2):
        _close(out[i][:, valid[i]], want_o[i][:, valid[i]], 1e-10)
    (out * torch.from_numpy(do)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), want_grads):
        _close(got, np.asarray(want), 1e-10)


def test_naive_form_matches_jax_naive():
    q, k, v, _, mask = _inputs(2, 2, 128, 64, np.float64, seed=3)
    want = np.asarray(jax_naive_attention(*map(jnp.asarray, (q, k, v)), jnp.asarray(mask)))
    got = naive_attention(*map(torch.from_numpy, (q, k, v, mask)))
    _close(got, want, 1e-12)
    assert model_naive_attention is naive_attention


def test_gradcheck_function_fp64():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 16, 8))).requires_grad_()
               for _ in range(3))
    seg = torch.tensor([[1] * 12 + [0] * 4], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda q, k, v: FlashAttention.apply(q, k, v, seg, 0.35), (q, k, v)
    )


@pytest.mark.parametrize("t,d", [(96, 64), (128, 32), (200, 64), (128, 96)])
def test_flash_raises_for_unsupported_shapes(t, d):
    assert not flash_supported(t, d)
    x = torch.zeros(1, 1, t, d, dtype=torch.float64)
    with pytest.raises(ValueError, match="flash"):
        scaled_dot_attention(x, x, x, None, "flash")


@pytest.mark.parametrize("seq,d_model", [(96, 128), (128, 64)])
def test_flash_model_raises_instead_of_falling_back(seq, d_model):
    """T 96 (not a multiple of 128) and head_dim 32 (d 64 over 2 heads)."""
    config = tiny_config(max_seq_len=seq, d_model=d_model, num_heads=2, attention="flash",
                         dtype=torch.float64)
    model = TransformerLM(config)
    before = naive_attention.calls
    with pytest.raises(ValueError, match="flash"):
        model(torch.ones(1, seq, dtype=torch.long))
    assert naive_attention.calls == before


def test_unknown_impl_raises():
    x = torch.zeros(1, 1, 128, 64)
    with pytest.raises(ValueError, match="impl"):
        scaled_dot_attention(x, x, x, None, "sdpa")
    with pytest.raises(ValueError, match="attention"):
        tiny_config(attention="sdpa")


def test_cpu_wrappers_take_plain_versions_without_counting():
    q, k, v, do, mask = map(torch.from_numpy, _inputs(2, 2, 128, 64, np.float32, seed=5))
    seg = segment_ids_for(mask, q)
    counts = (flash_forward.launches, flash_backward_dkv.launches, flash_backward_dq.launches)
    o, l, m = flash_forward(q, k, v, seg, 0.125)
    want = flash_forward_reference(q, k, v, seg, 0.125)
    assert all(torch.equal(a, b) for a, b in zip((o, l, m), want))
    di = (o * do).sum(-1)
    got_kv = flash_backward_dkv(q, k, v, seg, l, m, do, di, 0.125)
    want_kv = flash_backward_dkv_reference(q, k, v, seg, l, m, do, di, 0.125)
    assert all(torch.equal(a, b) for a, b in zip(got_kv, want_kv))
    assert torch.equal(flash_backward_dq(q, k, v, seg, l, m, do, di, 0.125),
                       flash_backward_dq_reference(q, k, v, seg, l, m, do, di, 0.125))
    assert counts == (flash_forward.launches, flash_backward_dkv.launches,
                      flash_backward_dq.launches)


def test_segment_ids_default_to_ones():
    q = torch.zeros(3, 2, 128, 64)
    seg = segment_ids_for(None, q)
    assert seg.dtype == torch.int32 and seg.shape == (3, 128) and bool((seg == 1).all())


def test_wrappers_reject_other_devices():
    x = torch.empty((1, 1, 128, 64), device="meta")
    seg = torch.empty((1, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        flash_forward(x, x, x, seg, 0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(64, torch.bfloat16), (128, torch.bfloat16),
                                     (256, torch.bfloat16), (64, torch.float32)])
def test_cuda_flash_kernels_match_plain_versions(d, dtype):
    """Card only: F1-F3 against their plain versions at every position. In
    bf16 (P and dS rounded to bf16 against a running rather than the final
    row max, and the outputs rounded to bf16) each element to 8 bf16 unit
    roundoffs u = 2^-8 of its row's scale, u (|plain| + max |plain| of the
    row) + u^2 max |plain|, as chip_smoke.py holds them; in fp32 to 1e-5 of
    the largest value (sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain versions only")
    g = torch.Generator("cuda").manual_seed(0)
    q, k, v, do = (torch.randn(2, 4, 256, d, generator=g, device="cuda").to(dtype)
                   for _ in range(4))
    seg = torch.ones(2, 256, dtype=torch.int32, device="cuda")
    seg[1, 200:] = 0
    scale = d ** -0.5
    before = flash_forward.launches
    o, l, m = flash_forward(q, k, v, seg, scale)
    assert flash_forward.launches == before + 1
    ro, _, _ = flash_forward_reference(q, k, v, seg, scale)
    di = (o.float() * do.float()).sum(-1)
    pairs = [(o, ro)]
    pairs += list(zip(flash_backward_dkv(q, k, v, seg, l, m, do, di, scale),
                      flash_backward_dkv_reference(q, k, v, seg, l, m, do, di, scale)))
    pairs.append((flash_backward_dq(q, k, v, seg, l, m, do, di, scale),
                  flash_backward_dq_reference(q, k, v, seg, l, m, do, di, scale)))
    torch.cuda.synchronize()
    for got, want in pairs:
        got, want = got.float(), want.float()
        size = want.abs()
        if dtype == torch.bfloat16:
            bound = 8 * (2.0 ** -8 * (size + size.amax(-1, keepdim=True)) + 2.0 ** -16 * size.max())
        else:
            bound = 1e-5 * size.max()
        assert bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_fused_plain_version_equals_split_pair(d, dtype):
    """FB's plain version computes P, dP and dS once, with the same operations
    as F2's and F3's plain versions: their results bit for bit."""
    q, k, v, do, mask = (torch.from_numpy(x) for x in _inputs(2, 2, 128, d, np.float32, seed=6))
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    seg = segment_ids_for(mask, q)
    scale = d ** -0.5
    o, l, m = flash_forward_reference(q, k, v, seg, scale)
    di = output_dot(o, do)
    dq, dk, dv = flash_backward_reference(q, k, v, seg, l, m, do, di, scale)
    want_dk, want_dv = flash_backward_dkv_reference(q, k, v, seg, l, m, do, di, scale)
    want_dq = flash_backward_dq_reference(q, k, v, seg, l, m, do, di, scale)
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    assert torch.equal(dq, want_dq) and torch.equal(dk, want_dk) and torch.equal(dv, want_dv)


@pytest.mark.parametrize("t,d,dtype", CASES)
def test_fused_wrapper_matches_jax_vjp(t, d, dtype):
    """On CPU tensors `flash_backward` (FB's wrapper) gives JAX's VJP."""
    q, k, v, do, mask = _inputs(2, 2, t, d, dtype, seed=7)
    _, want_grads = _jax_reference(q, k, v, do, mask)
    tq, tk, tv, tdo, tmask = map(torch.from_numpy, (q, k, v, do, mask))
    seg = segment_ids_for(tmask, tq)
    scale = 1.0 / math.sqrt(d)
    o, l, m = flash_forward(tq, tk, tv, seg, scale)
    grads = flash_backward(tq, tk, tv, seg, l, m, tdo, output_dot(o, tdo), scale)
    for got, want in zip(grads, want_grads):
        _close(got, want, TOL[dtype])


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16, torch.float64])
def test_backward_route_is_fused_at_bf16_d64_and_split_h_at_bf16_d128(dtype, d):
    want = {(torch.bfloat16, 64): "fused", (torch.bfloat16, 128): "split_h",
            (torch.bfloat16, 256): "split_w",
            (torch.float32, 64): "split_f32", (torch.float32, 128): "split_f32_h",
            (torch.float32, 256): "split_f32_w"}.get((dtype, d), "split")
    assert backward_route(dtype, d) == want


# The wrappers `FlashAttention.backward` calls on each route.
BACKWARD_WRAPPERS = {"fused": ["flash_backward"],
                     "split_h": ["flash_backward_dkv_d128", "flash_backward_dq_d128"],
                     "split_w": ["flash_backward_dkv_d256", "flash_backward_dq_d256"],
                     "split_f32": ["flash_backward_dkv_f32", "flash_backward_dq_f32"],
                     "split_f32_h": ["flash_backward_dkv_f32_d128", "flash_backward_dq_f32_d128"],
                     "split_f32_w": ["flash_backward_dkv_f32_d256", "flash_backward_dq_f32_d256"],
                     "split": ["flash_backward_dkv", "flash_backward_dq"]}


@pytest.mark.parametrize("d,dtype", [(64, torch.bfloat16), (128, torch.bfloat16),
                                     (64, torch.float32), (128, torch.float32),
                                     (256, torch.bfloat16), (256, torch.float32)])
def test_function_backward_follows_the_route(monkeypatch, d, dtype):
    """The Function's backward on CPU tensors calls FB's wrapper on the fused
    route, F2H's and F3H's on the split_h route, F2W's and F3W's on the
    split_w route, F2S's and F3S's on the
    split_f32 route, F2SH's and F3SH's on the split_f32_h route, F2SW's and
    F3SW's on the split_f32_w route and F2's and F3's on the split one, each
    taking its plain version: the same gradients either way."""
    q, k, v, do, mask = (torch.from_numpy(x) for x in _inputs(2, 2, 128, d, np.float32, seed=8))
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    seg = segment_ids_for(mask, q)
    scale = d ** -0.5
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    wrappers = (flash_backward, flash_backward_dkv, flash_backward_dq, flash_backward_dkv_d128,
                flash_backward_dq_d128, flash_backward_dkv_d256, flash_backward_dq_d256,
                flash_backward_dkv_f32, flash_backward_dq_f32,
                flash_backward_dkv_f32_d128, flash_backward_dq_f32_d128,
                flash_backward_dkv_f32_d256, flash_backward_dq_f32_d256)
    counts = [fn.launches for fn in wrappers]
    called = []
    for name in sum(BACKWARD_WRAPPERS.values(), []):
        wrapper = getattr(attention, name)
        monkeypatch.setattr(attention, name,
                            lambda *args, _n=name, _w=wrapper: called.append(_n) or _w(*args))
    out = FlashAttention.apply(*leaves, seg, scale)
    grads = torch.autograd.grad(out, leaves, do)
    assert called == BACKWARD_WRAPPERS[backward_route(dtype, d)]
    o, l, m = flash_forward_reference(q, k, v, seg, scale)
    di = output_dot(o, do)
    want_dk, want_dv = flash_backward_dkv_reference(q, k, v, seg, l, m, do, di, scale)
    want_dq = flash_backward_dq_reference(q, k, v, seg, l, m, do, di, scale)
    assert all(torch.equal(a, b) for a, b in zip(grads, (want_dq, want_dk, want_dv)))
    assert counts == [fn.launches for fn in wrappers]


def test_cpu_fused_wrapper_takes_plain_version_without_counting():
    q, k, v, do, mask = map(torch.from_numpy, _inputs(2, 2, 128, 64, np.float32, seed=9))
    q, k, v, do = (x.to(torch.bfloat16) for x in (q, k, v, do))
    seg = segment_ids_for(mask, q)
    o, l, m = flash_forward(q, k, v, seg, 0.125)
    di = output_dot(o, do)
    before = flash_backward.launches
    got = flash_backward(q, k, v, seg, l, m, do, di, 0.125)
    want = flash_backward_reference(q, k, v, seg, l, m, do, di, 0.125)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert flash_backward.launches == before


def test_fused_wrapper_rejects_other_devices():
    x = torch.empty((1, 1, 128, 64), dtype=torch.bfloat16, device="meta")
    seg = torch.empty((1, 128), dtype=torch.int32, device="meta")
    stat = torch.empty((1, 1, 128), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        flash_backward(x, x, x, seg, stat, stat, x, stat, 0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("t,padded", [(256, True), (128, False)])
def test_cuda_fused_backward_matches_plain_version(t, padded):
    """Card only: FB against its plain version at every position of dQ, dK and
    dV, each element to 8 bf16 unit roundoffs u = 2^-8 of its row's scale,
    u (|plain| + max |plain| of the row) + u^2 max |plain|, as chip_smoke.py
    holds it (P and dS rounded to bf16 from fp32 values that differ in the
    last bits, sums in another order, outputs rounded to bf16); the fp32 dQ
    sum's atomics add in another order each run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain versions only")
    g = torch.Generator("cuda").manual_seed(1)
    q, k, v, do = (torch.randn(2, 4, t, 64, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    seg = torch.ones(2, t, dtype=torch.int32, device="cuda")
    if padded:
        seg[1, t - 56:] = 0
    o, l, m = flash_forward(q, k, v, seg, 0.125)
    di = output_dot(o, do)
    before = flash_backward.launches
    got = flash_backward(q, k, v, seg, l, m, do, di, 0.125)
    assert flash_backward.launches == before + 1
    want = flash_backward_reference(q, k, v, seg, l, m, do, di, 0.125)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        x, y = x.float(), y.float()
        size = y.abs()
        bound = 8 * (2.0 ** -8 * (size + size.amax(-1, keepdim=True)) + 2.0 ** -16 * size.max())
        assert bool(((x - y).abs() <= bound).all())


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16, torch.float64])
def test_forward_route_is_pipelined_only_for_bf16_at_d64(dtype, d):
    """"pipelined" (FF) only for bf16 at D 64, "pipelined_h" (FFH) only for
    bf16 at D 128, "wgmma_w" (FFW) only for bf16 at D 256, "tiled_f32" (FFS)
    only for fp32 at D 128 and 256, "tiled_f32_64" (FFS64) only for fp32 at
    D 64, "generic" (F1) for every other case."""
    want = {(torch.bfloat16, 64): "pipelined", (torch.bfloat16, 128): "pipelined_h",
            (torch.bfloat16, 256): "wgmma_w", (torch.float32, 64): "tiled_f32_64",
            (torch.float32, 128): "tiled_f32", (torch.float32, 256): "tiled_f32"}
    assert forward_route(dtype, d) == want.get((dtype, d), "generic")


@pytest.mark.parametrize("d,dtype", [(64, torch.bfloat16), (128, torch.bfloat16),
                                     (64, torch.float32), (128, torch.float32),
                                     (256, torch.float32), (256, torch.bfloat16)])
def test_function_forward_follows_the_route(monkeypatch, d, dtype):
    """The Function's forward calls FF's wrapper on the "pipelined" route,
    FFH's on "pipelined_h", FFW's on "wgmma_w", FFS's on "tiled_f32", FFS64's
    on "tiled_f32_64" and F1's on "generic" (each on CPU tensors: the plain
    forward)."""
    q, k, v, _, mask = (torch.from_numpy(x) for x in _inputs(2, 2, 128, d, np.float32, seed=10))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    seg = segment_ids_for(mask, q)
    called = []
    for name in ("flash_forward", "flash_forward_pipelined", "flash_forward_d128",
                 "flash_forward_d256", "flash_forward_f32", "flash_forward_f32_d64"):
        wrapper = getattr(attention, name)
        monkeypatch.setattr(attention, name,
                            lambda *args, _n=name, _w=wrapper: called.append(_n) or _w(*args))
    out = FlashAttention.apply(q, k, v, seg, d ** -0.5)
    want = {"pipelined": "flash_forward_pipelined", "pipelined_h": "flash_forward_d128",
            "wgmma_w": "flash_forward_d256", "tiled_f32": "flash_forward_f32",
            "tiled_f32_64": "flash_forward_f32_d64", "generic": "flash_forward"}[
                forward_route(dtype, d)]
    assert called == [want]
    assert (dtype, d) != (torch.bfloat16, 128) or want == "flash_forward_d128"
    assert (dtype, d) != (torch.bfloat16, 256) or want == "flash_forward_d256"
    assert dtype != torch.float32 or d == 64 or want == "flash_forward_f32"
    assert (dtype, d) != (torch.float32, 64) or want == "flash_forward_f32_d64"
    assert torch.equal(out, flash_forward_reference(q, k, v, seg, d ** -0.5)[0])


def test_cpu_pipelined_wrapper_takes_plain_version_without_counting():
    q, k, v, _, mask = map(torch.from_numpy, _inputs(2, 2, 128, 64, np.float32, seed=11))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    seg = segment_ids_for(mask, q)
    before = flash_forward_pipelined.launches
    got = flash_forward_pipelined(q, k, v, seg, 0.125)
    want = flash_forward_reference(q, k, v, seg, 0.125)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert flash_forward_pipelined.launches == before


def test_pipelined_wrapper_rejects_other_devices():
    x = torch.empty((1, 1, 128, 64), dtype=torch.bfloat16, device="meta")
    seg = torch.empty((1, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        flash_forward_pipelined(x, x, x, seg, 0.125)


def _ff_schedule(q, k, v, seg, scale, tile):
    """FF's schedule, blocked, in the operands' dtype, with square tiles: for
    each query tile the key tiles from the diagonal down to 0; the mask only
    on the diagonal tile and on tiles whose query and key segment ids are not
    all one id (per example, as the CTA's vote decides); a base-2 online
    softmax on the raw scores, P = 2^(s c - max c) with c = scale log2 e;
    a masked P exactly 0. Returns (O, l, m), m in natural-log units."""
    b, h, t, d = q.shape
    c = scale * math.log2(math.e)
    o, l, m = torch.zeros_like(q), q.new_zeros(b, h, t), q.new_zeros(b, h, t)
    causal = torch.ones(t, t, dtype=torch.bool).tril()
    for q0 in range(0, t, tile):
        rows = slice(q0, q0 + tile)
        sq = seg[:, rows]
        acc = q.new_zeros(b, h, tile, d)
        mx = torch.full((b, h, tile), -math.inf, dtype=q.dtype)
        ls = q.new_zeros(b, h, tile)
        for kt in range(q0 // tile, -1, -1):
            cols = slice(kt * tile, kt * tile + tile)
            sk = seg[:, cols]
            s = torch.matmul(q[:, :, rows], k[:, :, cols].transpose(-1, -2))
            one = (sq == sq[:, :1]).all(1) & (sk == sq[:, :1]).all(1)
            need = ~one if kt * tile != q0 else torch.ones_like(one)
            keep = causal[rows, cols][None] & (sq[:, :, None] == sk[:, None, :])
            keep = (keep | ~need[:, None, None])[:, None]
            new_mx = torch.maximum(mx, torch.where(keep, s, -math.inf).amax(-1))
            alpha = torch.exp2((mx - new_mx) * c)
            p = torch.where(keep, torch.exp2(s * c - (new_mx * c)[..., None]), 0.0)
            ls = ls * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.matmul(p, v[:, :, cols])
            mx = new_mx
        o[:, :, rows], l[:, :, rows], m[:, :, rows] = acc / ls[..., None], ls, mx * scale
    return o, l, m


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ff_schedule_matches_jax_reference(dtype, tile):
    """The schedule FF runs, held against JAX's reference (O, l and m) on
    padded segments: in key order from tile 0, as F1 walks, a padded row's
    first key tiles are wholly masked, and the diagonal-first order never
    starts a row on such a tile. Example 2 is unpadded, so its tiles below
    the diagonal take the unmasked branch."""
    b, h, t, d = 3, 2, 128, 64
    rng = np.random.default_rng(12)
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(dtype) for _ in range(3))
    mask = np.ones((b, t), np.int32)
    mask[0, 70:] = 0
    mask[1, 100:] = 0
    # A padded row (segment 0) against key tile 0 (segment 1): fully masked.
    assert (mask[0, 70:, None] != mask[0, None, :tile]).all()
    seg = SegmentIds(q=jnp.asarray(mask), kv=jnp.asarray(mask))
    scale = 1.0 / math.sqrt(d)
    want = mha_reference_no_custom_vjp(*map(jnp.asarray, (q, k, v)), segment_ids=seg, causal=True,
                                       sm_scale=scale, save_residuals=True)
    got = _ff_schedule(*map(torch.from_numpy, (q, k, v, mask)), scale, tile)
    for x, y in zip(got, want):
        _close(x, np.asarray(y), TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("t,padded", [(256, True), (128, False)])
def test_cuda_pipelined_forward_matches_plain_version(t, padded):
    """Card only: FF against its plain version at every position of O, each
    element to 8 bf16 unit roundoffs u = 2^-8 of its row's scale, u (|plain|
    + max |plain| of the row) + u^2 max |plain|, as chip_smoke.py holds it (P
    rounded to bf16 against a running rather than the final row max, sums in
    another order, O rounded to bf16); l and m to 1e-5 of their largest
    value (fp32 on both sides)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain versions only")
    g = torch.Generator("cuda").manual_seed(2)
    q, k, v = (torch.randn(2, 4, t, 64, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    seg = torch.ones(2, t, dtype=torch.int32, device="cuda")
    if padded:
        seg[1, t - 56:] = 0
    before = flash_forward_pipelined.launches
    o, l, m = flash_forward_pipelined(q, k, v, seg, 0.125)
    assert flash_forward_pipelined.launches == before + 1
    ro, rl, rm = flash_forward_reference(q, k, v, seg, 0.125)
    torch.cuda.synchronize()
    x, y = o.float(), ro.float()
    size = y.abs()
    bound = 8 * (2.0 ** -8 * (size + size.amax(-1, keepdim=True)) + 2.0 ** -16 * size.max())
    assert bool(((x - y).abs() <= bound).all())
    for got, want in ((l, rl), (m, rm)):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
