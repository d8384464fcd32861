"""F2SH and F3SH (`kronfluence_tpu_torch/csrc/flash_backward_f32_d128.cu`),
the fp32 D 128 backward route ("split_f32_h"), against JAX: a blocked
emulation of each kernel's schedule, the wrappers on CPU tensors and the
autograd Function, held against JAX's flash-attention reference
(`mha_reference_no_custom_vjp` and its `jax.vjp`) at D 128 on padded
segments. The CUDA kernels are compared with their plain versions on the card
by the `cuda`-marked test and by chip_smoke.py.
"""

import math

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from kronfluence_tpu_torch.ops import attention
from kronfluence_tpu_torch.ops.attention import FlashAttention, output_dot, segment_ids_for
from kronfluence_tpu_torch.ops.kernels import flash
from kronfluence_tpu_torch.ops.kernels.flash import (
    flash_backward_dkv,
    flash_backward_dkv_f32,
    flash_backward_dkv_f32_d128,
    flash_backward_dkv_reference,
    flash_backward_dq,
    flash_backward_dq_f32,
    flash_backward_dq_f32_d128,
    flash_backward_dq_reference,
    flash_forward_reference,
)
from tests.test_torch_flash_f32 import (
    TOL,
    _close,
    _dkv_schedule,
    _dq_schedule,
    _forward,
    _jax_vjp,
)

D = 128
# F2SH and F3SH keep F2S's and F3S's tiles and steps (F2SH 64 keys a CTA and
# 32 queries a step, F3SH 64 queries a CTA and 64 keys a step), so their
# blocked schedules are `_dkv_schedule` and `_dq_schedule`. What changes at D
# 128 is the threads' share of each tile, which a blocked emulation does not
# see.
WRAPPERS = {"F2SH": flash_backward_dkv_f32_d128, "F3SH": flash_backward_dq_f32_d128}


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


@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_split_f32_h_schedules_match_jax_vjp(dtype, t):
    """Both kernels' schedules, held against JAX's VJP (dQ, dK, dV) at D 128
    on padded segments: the padded examples' steps that cross a padding
    boundary, and a padded row's tiles of valid keys, give what JAX gives."""
    q, k, v, do, mask = _inputs(t, dtype, seed=t + 21)
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
def test_split_f32_h_wrappers_match_jax_vjp(dtype, t):
    """On CPU tensors F2SH's and F3SH's wrappers take the plain versions, bit
    for bit, and give JAX's VJP, without counting a launch."""
    q, k, v, do, mask = _inputs(t, dtype, seed=t + 22)
    want = _jax_vjp(q, k, v, do, mask)
    scale = 1.0 / math.sqrt(D)
    tq, tk, tv, seg, o, l, m = _forward(q, k, v, mask, scale)
    tdo = torch.from_numpy(do)
    args = (tq, tk, tv, seg, l, m, tdo, output_dot(o, tdo), scale)
    counts = [fn.launches for fn in WRAPPERS.values()]
    dk, dv = flash_backward_dkv_f32_d128(*args)
    dq = flash_backward_dq_f32_d128(*args)
    assert counts == [fn.launches for fn in WRAPPERS.values()]
    plain = (*flash_backward_dkv_reference(*args), flash_backward_dq_reference(*args))
    assert all(torch.equal(a, b) for a, b in zip((dk, dv, dq), plain))
    for got, w in zip((dq, dk, dv), want):
        _close(got, w, TOL[dtype])


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_split_f32_h_wrappers_reject_other_devices(name):
    x = torch.empty((1, 1, 128, D), dtype=torch.float32, device="meta")
    seg = torch.empty((1, 128), dtype=torch.int32, device="meta")
    stat = torch.empty((1, 1, 128), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        WRAPPERS[name](x, x, x, seg, stat, stat, x, stat, 0.125)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128), (torch.float16, 128),
                                     (torch.float32, 64), (torch.float32, 256)])
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_split_f32_h_wrappers_reject_other_dtypes_and_head_dims(monkeypatch, name, dtype, d):
    """Off the CPU a wrapper takes only its route's operands, fp32 at D 128:
    past the device and shape checks (stubbed here, where no card is), any
    other type or head dim raises rather than reaching the kernel."""
    monkeypatch.setattr(flash, "_check_cuda", lambda tensors, seg, stats=(): tuple(tensors[0].shape))
    x = torch.empty((1, 1, 128, d), dtype=dtype, device="meta")
    seg = torch.empty((1, 128), dtype=torch.int32, device="meta")
    stat = torch.empty((1, 1, 128), device="meta")
    before = WRAPPERS[name].launches
    with pytest.raises(ValueError, match="split_f32_h"):
        WRAPPERS[name](x, x, x, seg, stat, stat, x, stat, 0.125)
    assert WRAPPERS[name].launches == before


@pytest.mark.parametrize("t", [128, 256])
def test_function_fp32_d128_gradient_goes_through_split_f32_h_and_matches_jax_vjp(monkeypatch, t):
    """FlashAttention's fp32 D 128 gradient on CPU tensors: the backward calls
    F2SH's and F3SH's wrappers (F2's, F3's, F2S's and F3S's never), which take
    the plain versions, and the gradient is JAX's VJP."""
    q, k, v, do, mask = _inputs(t, np.float32, seed=t + 23)
    want = _jax_vjp(q, k, v, do, mask)
    tq, tk, tv, tdo, tmask = map(torch.from_numpy, (q, k, v, do, mask))
    names = ("flash_backward_dkv_f32_d128", "flash_backward_dq_f32_d128", "flash_backward_dkv_f32",
             "flash_backward_dq_f32", "flash_backward_dkv", "flash_backward_dq")
    called = []
    for name in names:
        wrapper = getattr(attention, name)
        monkeypatch.setattr(attention, name,
                            lambda *args, _n=name, _w=wrapper: called.append(_n) or _w(*args))
    wrappers = (flash_backward_dkv_f32_d128, flash_backward_dq_f32_d128, flash_backward_dkv_f32,
                flash_backward_dq_f32, flash_backward_dkv, flash_backward_dq)
    counts = [fn.launches for fn in wrappers]
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = FlashAttention.apply(*leaves, segment_ids_for(tmask, tq), 1.0 / math.sqrt(D))
    dq, dk, dv = torch.autograd.grad(out, leaves, tdo)
    assert called == ["flash_backward_dkv_f32_d128", "flash_backward_dq_f32_d128"]
    assert counts == [fn.launches for fn in wrappers]
    for got, w in zip((dq, dk, dv), want):
        _close(got, w, TOL[np.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("t", [256, 512])
def test_cuda_split_f32_h_kernels_match_plain_versions(t):
    """Card only: F2SH and F3SH against their plain versions at every position
    of dQ, dK and dV at (2, 4, T, 128) fp32, padded, within 1e-5 of the
    largest plain value (the same fp32 sums in another order), as
    chip_smoke.py holds them; two calls give the same bits; bf16 and D 64
    raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain versions only")
    g = torch.Generator("cuda").manual_seed(6)
    q, k, v, do = (torch.randn(2, 4, t, D, generator=g, device="cuda") for _ in range(4))
    seg = torch.ones(2, t, dtype=torch.int32, device="cuda")
    seg[1, t - 56:] = 0
    scale = D ** -0.5
    o, l, m = flash_forward_reference(q, k, v, seg, scale)
    di = output_dot(o, do)
    args = (q, k, v, seg, l, m, do, di, scale)
    before = [fn.launches for fn in WRAPPERS.values()]
    got = (flash_backward_dq_f32_d128(*args), *flash_backward_dkv_f32_d128(*args))
    again = (flash_backward_dq_f32_d128(*args), *flash_backward_dkv_f32_d128(*args))
    assert [fn.launches for fn in WRAPPERS.values()] == [n + 2 for n in before]
    want = (flash_backward_dq_reference(*args), *flash_backward_dkv_reference(*args))
    torch.cuda.synchronize()
    for x, x2, y in zip(got, again, want):
        assert torch.equal(x, x2)
        assert float((x - y).abs().max()) <= 1e-5 * float(y.abs().max())
    for bad in (q.to(torch.bfloat16), torch.randn(2, 4, t, 64, device="cuda")):
        with pytest.raises((ValueError, TypeError)):
            flash_backward_dq_f32_d128(bad, bad, bad, seg, l, m, bad, di, scale)
