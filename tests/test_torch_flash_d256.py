"""F2W and F3W (`kronfluence_tpu_torch/csrc/flash_backward_d256.cu`), the
bf16 D 256 backward route ("split_w"), against JAX: a blocked emulation of
each kernel's schedule (F2W's 64-key tiles, 64-query steps, S and dP formed
for each half of a step's queries and dK and dV for each half of D; F3W's
64-query tiles and 32-key steps), the wrappers on CPU tensors and the
autograd Function, held against JAX's flash-attention reference
(`mha_reference_no_custom_vjp` and its `jax.vjp`) at D 256 on padded
segments; and a tiny Llama at head_dim 256 with one KV head against the flax
model. The CUDA kernels are compared with their plain versions on the card by
the `cuda`-marked test and by chip_smoke.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from kronfluence_tpu_torch.models import llama
from kronfluence_tpu_torch.ops import attention
from kronfluence_tpu_torch.ops.attention import FlashAttention, output_dot, segment_ids_for
from kronfluence_tpu_torch.ops.kernels import flash
from kronfluence_tpu_torch.ops.kernels.flash import (
    backward_route,
    flash_backward_dkv_d256,
    flash_backward_dkv_reference,
    flash_backward_dq_d256,
    flash_backward_dq_reference,
    flash_forward_reference,
)
from tests.test_torch_flash_d128 import _close, _jax_vjp, _probabilities
from tests.test_torch_flash_f32_d256 import BACKWARD_NAMES
from tests.test_torch_llama import ATOL, RTOL, _data, _pair, _torch

D = 256
# Relative to the largest reference value, at every position: fp64 sums in
# another order agree to ~1e-15; fp32 to a few ulps of the partial sums.
TOL = {np.float64: 1e-10, np.float32: 1e-5}
# bf16, where the schedules round P and dS to bf16 before their products and
# the outputs to bf16, as the kernels do, against JAX's fp32 VJP on the same
# bf16 inputs: each element within 8 bf16 unit roundoffs u = 2^-8 of its
# row's scale, u (|want| + max |want| of its row) + u^2 max |want|, the limit
# chip_smoke.py holds the kernels to against their plain versions (each
# rounding of P or dS moves a product by at most u/2 of its size; the row
# scale covers the sums' cancellation).
BF16_UNITS = 8.0
# The kernels' tiles: F2W 64 keys a CTA and 64 queries a step, each warp of a
# 16-key pair forming S^T and dP^T for one half of the step's queries and
# holding dK and dV for one half of D; F3W 64 queries a CTA and 32 keys a step.
KEY_TILE, QUERY_STEP, QUERY_TILE, KEY_STEP, HALF = 64, 64, 64, 32, D // 2
WRAPPERS = {"F2W": flash_backward_dkv_d256, "F3W": flash_backward_dq_d256}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def _inputs(t, dtype, seed):
    """(q, k, v, do, mask) at B 3, H 2, D 256: example 0 keeps 70 tokens,
    example 1 keeps 100, example 2 is unpadded. bf16 inputs are drawn in fp32
    and rounded to bf16, and handed to JAX as those fp32 values."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((3, 2, t, D)).astype(np.float32 if dtype == "bf16"
                                                            else dtype) for _ in range(4))
    if dtype == "bf16":
        q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16).float().numpy()
                       for x in (q, k, v, do))
    mask = np.ones((3, t), np.int32)
    mask[0, 70:] = 0
    mask[1, 100:] = 0
    return q, k, v, do, mask


def _round(x, low):
    """x rounded to `low` (bf16) and back, or x itself."""
    return x if low is None else x.to(low).to(x.dtype)


def _dkv_schedule(q, k, v, seg, l, m, do, di, scale, low=None, skip=None):
    """F2W's schedule, blocked: for each 64-key tile the 64-query steps from
    the diagonal to T; the mask only on the steps the diagonal crosses and on
    steps whose key and query segment ids are not all one id (per example, as
    the CTA's vote decides); per 16-key group, the query 16-blocks wholly
    above it skipped on the masked steps, S^T and dP^T formed for each half
    of the step's queries apart (one warp of the pair a half), P^T and dS^T
    rounded to `low` and traded, then dV += P^T dO and dK += dS^T Q for each
    half of D's columns apart (one warp a half). `skip` (key tile, query
    step) is left out, as a faulty kernel would. Returns (dK, dV), rounded to
    `low`."""
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
            if (k0, q0) == skip:
                continue
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
                p_parts, ds_parts = [], []
                for half in range(2):  # the pair's two warps: a half of the queries each
                    first = max(jp_first * 16, half * QUERY_STEP // 2)
                    end = (half + 1) * QUERY_STEP // 2
                    if first >= end:
                        continue
                    live = slice(q0 + first, q0 + end)
                    st = torch.matmul(k[:, :, cols][:, :, keys], q[:, :, live].transpose(-1, -2))
                    dpt = torch.matmul(v[:, :, cols][:, :, keys], do[:, :, live].transpose(-1, -2))
                    p = _probabilities(st, False, keep[:, :, keys, first:end], l[:, :, live],
                                       m[:, :, live], scale)
                    ds = p * (dpt - di[:, :, live][:, :, None, :]) * scale
                    p_parts.append(_round(p, low))
                    ds_parts.append(_round(ds, low))
                p, ds = torch.cat(p_parts, -1), torch.cat(ds_parts, -1)
                live = slice(q0 + 16 * jp_first, q0 + QUERY_STEP)
                for c0 in (0, HALF):  # the pair's two warps: a half of D each
                    dcols = slice(c0, c0 + HALF)
                    acc_v[:, :, keys, dcols] += torch.matmul(p, do[:, :, live, dcols])
                    acc_k[:, :, keys, dcols] += torch.matmul(ds, q[:, :, live, dcols])
        dk[:, :, cols], dv[:, :, cols] = _round(acc_k, low), _round(acc_v, low)
    return dk, dv


def _dq_schedule(q, k, v, seg, l, m, do, di, scale, low=None, skip=None):
    """F3W's schedule, blocked: for each 64-query tile the 32-key steps from 0
    to the diagonal's second half; the mask only on the two diagonal steps
    and on steps whose query and key segment ids are not all one id (per
    example); on the diagonal, key 16-blocks wholly above a 16-row group
    skipped (and the second half's step for the tile's first 32 rows); dS
    rounded to `low`; `skip` (query tile, key step) left out. Returns dQ,
    rounded to `low`."""
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
            for k0 in range(0, q0 + QUERY_TILE, KEY_STEP):
                if (q0, k0) == skip:
                    continue
                masked = k0 + KEY_STEP > q0
                last = (q0 + rw - k0) // 16  # the last key 16-block at or below the rows
                if masked and last < 0:
                    continue  # the step lies wholly above these rows
                end = k0 + (min(last, KEY_STEP // 16 - 1) + 1) * 16 if masked else k0 + KEY_STEP
                cols = slice(k0, end)
                sk = seg[:, k0:k0 + KEY_STEP]
                uniform = q_one & (sk == sq[:, :1]).all(1)
                need = torch.ones_like(uniform) if masked else ~uniform
                keep = causal[own, cols][None] & (seg[:, own, None] == seg[:, None, cols])
                keep = (keep | ~need[:, None, None])[:, None]
                s = torch.matmul(q[:, :, own], k[:, :, cols].transpose(-1, -2))
                dp = torch.matmul(do[:, :, own], v[:, :, cols].transpose(-1, -2))
                p = _probabilities(s, True, keep, l[:, :, own], m[:, :, own], scale)
                ds = _round(p * (dp - di[:, :, own][..., None]) * scale, low)
                acc += torch.matmul(ds, k[:, :, cols])
            dq[:, :, own] = _round(acc, low)
    return dq


def _args(t, dtype, seed):
    """JAX's VJP (dQ, dK, dV) in `dtype` (fp32 for "bf16") and the backward's
    operands from the plain forward at B 3, H 2, T t, D 256, in fp32 for
    "bf16" (the kernels' compute type) on bf16 values."""
    q, k, v, do, mask = _inputs(t, dtype, seed)
    want = _jax_vjp(q, k, v, do, mask)
    scale = 1.0 / math.sqrt(D)
    tq, tk, tv, tdo, tmask = map(torch.from_numpy, (q, k, v, do, mask))
    seg = segment_ids_for(tmask, tq)
    o, l, m = flash_forward_reference(tq, tk, tv, seg, scale)
    return want, (tq, tk, tv, seg, l, m, tdo, output_dot(o, tdo), scale)


def _bf16_units(got, want):
    """max |got - want| in units of u (|want| + max |want| of its row) + u^2
    max |want|, u = 2^-8."""
    got, want = got.detach().double().numpy(), np.asarray(want, np.float64)
    size = np.abs(want)
    unit = 2.0 ** -8 * (size + size.max(-1, keepdims=True)) + 2.0 ** -16 * size.max()
    return float((np.abs(got - want) / unit).max())


@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("dtype", [np.float64, np.float32, "bf16"])
def test_split_w_schedules_match_jax_vjp(dtype, t):
    """Both kernels' schedules, held against JAX's VJP (dQ, dK, dV) at D 256
    on padded segments. Example 2 is unpadded, so its steps below the
    diagonal take the unmasked branch; the padded examples' steps that cross
    a padding boundary are masked, and a padded row's tiles of valid keys
    give it nothing. In bf16 the schedules round P, dS and the outputs as the
    kernels do."""
    want, args = _args(t, dtype, seed=t + 41)
    low = torch.bfloat16 if dtype == "bf16" else None
    dk, dv = _dkv_schedule(*args, low=low)
    dq = _dq_schedule(*args, low=low)
    for got, w in zip((dq, dk, dv), want):
        if low is None:
            _close(got, w, TOL[dtype])
        else:
            assert _bf16_units(got, w) <= BF16_UNITS


def test_bf16_limit_catches_a_skipped_step():
    """The bf16 limit has teeth: F2W's schedule with one 64-query step of one
    key tile left out (queries 128-191 of keys 64-127, below the diagonal)
    reads above it for dK and dV, as F3W's with one 32-key step left out
    (keys 64-95 of queries 128-191) does for dQ."""
    want, args = _args(256, "bf16", seed=45)
    low = torch.bfloat16
    dk, dv = _dkv_schedule(*args, low=low, skip=(64, 128))
    dq = _dq_schedule(*args, low=low, skip=(128, 64))
    for got, w in zip((dq, dk, dv), want):
        assert _bf16_units(got, w) > BF16_UNITS


@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_split_w_wrappers_match_jax_vjp(dtype, t):
    """On CPU tensors F2W's and F3W's wrappers take the plain versions, bit
    for bit, and give JAX's VJP, without counting a launch."""
    want, args = _args(t, dtype, seed=t + 42)
    counts = [fn.launches for fn in WRAPPERS.values()]
    dk, dv = flash_backward_dkv_d256(*args)
    dq = flash_backward_dq_d256(*args)
    assert counts == [fn.launches for fn in WRAPPERS.values()]
    plain = (*flash_backward_dkv_reference(*args), flash_backward_dq_reference(*args))
    assert all(torch.equal(a, b) for a, b in zip((dk, dv, dq), plain))
    for got, w in zip((dq, dk, dv), want):
        _close(got, w, TOL[dtype])


def test_cpu_split_w_wrappers_are_the_plain_versions_in_bf16():
    q, k, v, do, mask = _inputs(128, np.float32, seed=43)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do))
    seg = segment_ids_for(torch.from_numpy(mask), tq)
    o, l, m = flash_forward_reference(tq, tk, tv, seg, D ** -0.5)
    args = (tq, tk, tv, seg, l, m, tdo, output_dot(o, tdo), D ** -0.5)
    assert backward_route(tq.dtype, D) == "split_w"
    assert all(torch.equal(a, b) for a, b in zip(flash_backward_dkv_d256(*args),
                                                  flash_backward_dkv_reference(*args)))
    assert torch.equal(flash_backward_dq_d256(*args), flash_backward_dq_reference(*args))


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_split_w_wrappers_reject_other_devices(name):
    x = torch.empty((1, 1, 128, D), dtype=torch.bfloat16, device="meta")
    seg = torch.empty((1, 128), dtype=torch.int32, device="meta")
    stat = torch.empty((1, 1, 128), device="meta")
    before = WRAPPERS[name].launches
    with pytest.raises(ValueError, match="CPU or CUDA"):
        WRAPPERS[name](x, x, x, seg, stat, stat, x, stat, 0.0625)
    assert WRAPPERS[name].launches == before


@pytest.mark.parametrize("dtype,d", [(torch.float32, 256), (torch.float16, 256),
                                     (torch.float64, 256), (torch.bfloat16, 64),
                                     (torch.bfloat16, 128)])
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_split_w_wrappers_reject_other_dtypes_and_head_dims(monkeypatch, name, dtype, d):
    """Off the CPU a wrapper takes only its route's operands, bf16 at D 256:
    past the device and shape checks (stubbed here, where no card is), any
    other type or head dim raises rather than reaching the kernel."""
    monkeypatch.setattr(flash, "_check_cuda", lambda tensors, seg, stats=(): tuple(tensors[0].shape))
    x = torch.empty((1, 1, 128, d), dtype=dtype, device="meta")
    seg = torch.empty((1, 128), dtype=torch.int32, device="meta")
    stat = torch.empty((1, 1, 128), device="meta")
    before = WRAPPERS[name].launches
    with pytest.raises(ValueError, match="'split_w'"):
        WRAPPERS[name](x, x, x, seg, stat, stat, x, stat, 0.0625)
    assert WRAPPERS[name].launches == before


@pytest.mark.parametrize("which", ["segment ids", "l", "m", "di"])
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_split_w_wrappers_reject_misaligned_operands(monkeypatch, name, which):
    """The kernels copy the segment ids (F2W also l, m and di) with 16-byte
    cp.async: past the device and shape checks (stubbed here, where no card
    is), an operand that does not start on 16 bytes raises before any
    launch."""
    monkeypatch.setattr(flash, "_check_cuda", lambda tensors, seg, stats=(): tuple(tensors[0].shape))
    x = torch.empty((1, 1, 128, D), dtype=torch.bfloat16, device="meta")
    operands = {"segment ids": torch.zeros(1, 128, dtype=torch.int32),
                "l": torch.zeros(1, 1, 128), "m": torch.zeros(1, 1, 128),
                "di": torch.zeros(1, 1, 128)}
    shifted = torch.zeros(129, dtype=operands[which].dtype)[1:]  # 4 bytes past an aligned start
    operands[which] = shifted.view(operands[which].shape)
    assert operands[which].data_ptr() % 16
    before = WRAPPERS[name].launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        WRAPPERS[name](x, x, x, operands["segment ids"], operands["l"], operands["m"], x,
                       operands["di"], 0.0625)
    assert WRAPPERS[name].launches == before


@pytest.mark.parametrize("t", [128, 256])
def test_function_bf16_d256_gradient_goes_through_split_w_and_matches_jax_vjp(monkeypatch, t):
    """FlashAttention's bf16 D 256 gradient on CPU tensors: the backward calls
    F2W's and F3W's wrappers and no other flash backward wrapper (F2's and
    F3's never), which take the plain versions, and the gradient is JAX's
    fp32 VJP on the same bf16 values within the bf16 limit (the plain
    forward's O and the gradients are bf16 here, P and dS rounded to bf16)."""
    q, k, v, do, mask = _inputs(t, "bf16", seed=t + 44)
    want = _jax_vjp(q, k, v, do, mask)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do))
    called = []
    for name in BACKWARD_NAMES:
        wrapper = getattr(attention, name)
        monkeypatch.setattr(attention, name,
                            lambda *args, _n=name, _w=wrapper: called.append(_n) or _w(*args))
    wrappers = [getattr(flash, name) for name in BACKWARD_NAMES]
    counts = [fn.launches for fn in wrappers]
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    seg = segment_ids_for(torch.from_numpy(mask), tq)
    out = FlashAttention.apply(*leaves, seg, 1.0 / math.sqrt(D))
    dq, dk, dv = torch.autograd.grad(out, leaves, tdo)
    assert called == ["flash_backward_dkv_d256", "flash_backward_dq_d256"]
    assert counts == [fn.launches for fn in wrappers]
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == torch.bfloat16
        assert _bf16_units(got, w) <= BF16_UNITS


def test_flash_at_head_dim_256_with_one_kv_head_matches_flax_naive(monkeypatch):
    """attention="flash" at head_dim 256 with one KV head, Gemma-2B's
    attention layout, against the flax model's naive form, in fp64 at valid
    positions (padded query rows attend differently in the two forms). Then
    the same weights in bf16: the backward of the summed valid logits goes
    through F2W's and F3W's wrappers once a layer (their plain versions on
    the CPU) and never F2's or F3's, and every parameter's gradient is within
    5e-2 of its max |g| of the fp64 model's, the limit chip_smoke.py holds
    the flash form to against the naive one (bf16 roundings through two
    layers' forward and backward)."""
    overrides = dict(d_model=512, num_heads=2, max_seq_len=128, d_mlp=320)
    module, params, jconfig, tmodel = _pair(num_kv_heads=1, attention="flash", **overrides)
    assert tmodel.config.head_dim == 256
    data = _data(2, 128, jconfig.vocab_size, seed=46)
    want = np.asarray(module.apply({"params": params}, *map(jnp.asarray, data.values())))
    valid = data["attention_mask"].astype(bool)
    got = tmodel(**_torch(data))
    np.testing.assert_allclose(got.detach().numpy()[valid], want[valid], rtol=RTOL, atol=ATOL)
    got[torch.from_numpy(valid)].sum().backward()

    twin = llama.LlamaLM(llama.tiny_llama_config(num_kv_heads=1, dtype=torch.bfloat16,
                                                 attention="flash", **overrides))
    twin.load_state_dict({k: v.to(torch.bfloat16) for k, v in tmodel.state_dict().items()})
    called = []
    for name in BACKWARD_NAMES:
        wrapper = getattr(attention, name)
        monkeypatch.setattr(attention, name,
                            lambda *args, _n=name, _w=wrapper: called.append(_n) or _w(*args))
    out = twin(**_torch(data))
    out[torch.from_numpy(valid)].float().sum().backward()
    assert called == ["flash_backward_dkv_d256", "flash_backward_dq_d256"] * 2
    fp64 = dict(tmodel.named_parameters())
    for name, p in twin.named_parameters():
        g, w = p.grad.double(), fp64[name].grad
        assert float((g - w).abs().max()) <= 5e-2 * float(w.abs().max()), name


@pytest.mark.cuda
@pytest.mark.parametrize("t", [256, 512])
def test_cuda_split_w_kernels_match_plain_versions(t):
    """Card only: F2W and F3W against their plain versions at every position
    of dQ, dK and dV at (2, 4, T, 256) bf16, padded, each element within 8
    bf16 unit roundoffs of its row's scale, as chip_smoke.py holds them (P
    and dS rounded to bf16 from fp32 values that differ in the last bits,
    sums in another order, outputs rounded to bf16); two calls give the same
    bits; fp32 and D 128 raise with the launch counts unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain versions only")
    g = torch.Generator("cuda").manual_seed(11)
    q, k, v, do = (torch.randn(2, 4, t, D, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    seg = torch.ones(2, t, dtype=torch.int32, device="cuda")
    seg[1, t - 56:] = 0
    scale = D ** -0.5
    o, l, m = flash_forward_reference(q, k, v, seg, scale)
    di = output_dot(o, do)
    args = (q, k, v, seg, l, m, do, di, scale)
    before = [fn.launches for fn in WRAPPERS.values()]
    got = (flash_backward_dq_d256(*args), *flash_backward_dkv_d256(*args))
    again = (flash_backward_dq_d256(*args), *flash_backward_dkv_d256(*args))
    assert [fn.launches for fn in WRAPPERS.values()] == [n + 2 for n in before]
    want = (flash_backward_dq_reference(*args), *flash_backward_dkv_reference(*args))
    torch.cuda.synchronize()
    for x, x2, y in zip(got, again, want):
        assert torch.equal(x, x2)
        x, y = x.float(), y.float()
        size = y.abs()
        bound = 8 * (2.0 ** -8 * (size + size.amax(-1, keepdim=True)) + 2.0 ** -16 * size.max())
        assert bool(((x - y).abs() <= bound).all())
    for bad in (q.float(), torch.randn(2, 4, t, 128, device="cuda").to(torch.bfloat16)):
        for fn in WRAPPERS.values():
            counts = fn.launches
            with pytest.raises((ValueError, TypeError)):
                fn(bad, bad, bad, seg, l, m, bad, di, scale)
            assert fn.launches == counts
