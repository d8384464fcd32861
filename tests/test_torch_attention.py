"""The port's attention module (`kronfluence_tpu_torch/ops/attention.py`)
against JAX: the plain versions of F1-F3 and FB (the fused backward) and the
`FlashAttention` Function against JAX's flash-attention reference
(`mha_reference_no_custom_vjp` and its `jax.vjp`), and against the JAX
package's naive form at valid query rows. On the CPU the wrappers take their
plain versions; the CUDA kernels are compared with them on the card by
chip_smoke.py and the `cuda`-marked tests.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
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
from kronfluence_tpu_torch.ops.attention import output_dot
from kronfluence_tpu_torch.ops.kernels.flash import (
    backward_route,
    flash_backward,
    flash_backward_dkv,
    flash_backward_dkv_reference,
    flash_backward_dq,
    flash_backward_dq_reference,
    flash_backward_reference,
    flash_forward,
    flash_forward_reference,
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
def test_backward_route_is_fused_only_for_bf16_at_d64(dtype, d):
    want = "fused" if (dtype, d) == (torch.bfloat16, 64) else "split"
    assert backward_route(dtype, d) == want


@pytest.mark.parametrize("d,dtype", [(64, torch.bfloat16), (128, torch.bfloat16),
                                     (64, torch.float32)])
def test_function_backward_follows_the_route(d, dtype):
    """The Function's backward on CPU tensors: FB's plain version on the fused
    route, F2's and F3's on the split one; the same gradients either way."""
    q, k, v, do, mask = (torch.from_numpy(x) for x in _inputs(2, 2, 128, d, np.float32, seed=8))
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    seg = segment_ids_for(mask, q)
    scale = d ** -0.5
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    counts = (flash_backward.launches, flash_backward_dkv.launches, flash_backward_dq.launches)
    out = FlashAttention.apply(*leaves, seg, scale)
    grads = torch.autograd.grad(out, leaves, do)
    o, l, m = flash_forward_reference(q, k, v, seg, scale)
    di = output_dot(o, do)
    want_dk, want_dv = flash_backward_dkv_reference(q, k, v, seg, l, m, do, di, scale)
    want_dq = flash_backward_dq_reference(q, k, v, seg, l, m, do, di, scale)
    assert all(torch.equal(a, b) for a, b in zip(grads, (want_dq, want_dk, want_dv)))
    assert counts == (flash_backward.launches, flash_backward_dkv.launches,
                      flash_backward_dq.launches)


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
