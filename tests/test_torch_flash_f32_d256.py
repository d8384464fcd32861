"""F2SW and F3SW (`kronfluence_tpu_torch/csrc/flash_backward_f32_d256.cu`),
the fp32 D 256 backward route ("split_f32_w"), against JAX: a blocked
emulation of each kernel's schedule (its 32-row tiles and steps, and D split
in two halves for S and dP), the wrappers on CPU tensors and the autograd
Function, held against JAX's flash-attention reference
(`mha_reference_no_custom_vjp` and its `jax.vjp`) at D 256 on padded
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
    flash_backward_dkv_f32_d256,
    flash_backward_dkv_reference,
    flash_backward_dq_f32_d256,
    flash_backward_dq_reference,
    flash_forward_reference,
)
from tests.test_torch_flash_f32 import TOL, _close, _forward, _jax_vjp, _keep

D = 256
# The kernels' tiles: F2SW 32 keys a CTA and 32 queries a step, F3SW 32
# queries a CTA and 32 keys a step; S and dP are summed over each half of D
# apart (one warp group a half), then the low half is added to the high half.
TILE, HALF = 32, D // 2
WRAPPERS = {"F2SW": flash_backward_dkv_f32_d256, "F3SW": flash_backward_dq_f32_d256}
# Every flash backward wrapper `FlashAttention.backward` may call.
BACKWARD_NAMES = ("flash_backward", "flash_backward_dkv", "flash_backward_dq",
                  "flash_backward_dkv_d128", "flash_backward_dq_d128", "flash_backward_dkv_d256",
                  "flash_backward_dq_d256", "flash_backward_dkv_f32",
                  "flash_backward_dq_f32", "flash_backward_dkv_f32_d128",
                  "flash_backward_dq_f32_d128", "flash_backward_dkv_f32_d256",
                  "flash_backward_dq_f32_d256")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def _inputs(t, dtype, seed):
    """(q, k, v, do, mask) at B 3, H 2, D 256: example 0 keeps 70 tokens,
    example 1 keeps 100, example 2 is unpadded."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((3, 2, t, D)).astype(dtype) for _ in range(4))
    mask = np.ones((3, t), np.int32)
    mask[0, 70:] = 0
    mask[1, 100:] = 0
    return q, k, v, do, mask


def _split_nt(a, b):
    """a bᵀ over D as the kernels sum it: each half of D apart, the low half's
    partial added to the high half's."""
    lo = torch.matmul(a[..., :HALF], b[..., :HALF].transpose(-1, -2))
    hi = torch.matmul(a[..., HALF:], b[..., HALF:].transpose(-1, -2))
    return lo + hi


def _dkv_schedule(q, k, v, seg, l, m, do, di, scale):
    """F2SW's schedule, blocked: for each 32-key tile the 32-query steps from
    the diagonal to T, every element masked (the steps at the diagonal and
    those that cross a padding boundary among them); Sᵀ and dPᵀ summed by
    halves of D; P = exp(s scale - m) times 1/l of its query, exactly 0 where
    masked; dV += Pᵀ dO and dK += dSᵀ Q a step. Returns (dK, dV)."""
    t = q.shape[2]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, t, TILE):
        cols = slice(k0, k0 + TILE)
        acc_k, acc_v = torch.zeros_like(k[:, :, cols]), torch.zeros_like(v[:, :, cols])
        for q0 in range(k0, t, TILE):
            rows = slice(q0, q0 + TILE)
            keep = _keep(seg, rows, cols).transpose(-1, -2)  # (keys, queries)
            st = _split_nt(k[:, :, cols], q[:, :, rows])
            dpt = _split_nt(v[:, :, cols], do[:, :, rows])
            rl = 1.0 / l[:, :, rows][:, :, None, :]
            p = torch.where(keep, torch.exp(st * scale - m[:, :, rows][:, :, None, :]) * rl, 0.0)
            ds = p * (dpt - di[:, :, rows][:, :, None, :]) * scale
            acc_v += torch.matmul(p, do[:, :, rows])
            acc_k += torch.matmul(ds, q[:, :, rows])
        dk[:, :, cols], dv[:, :, cols] = acc_k, acc_v
    return dk, dv


def _dq_schedule(q, k, v, seg, l, m, do, di, scale):
    """F3SW's schedule, blocked: for each 32-query tile the 32-key steps from
    0 to the diagonal, every element masked; S and dP summed by halves of D;
    dQ += dS K a step. Returns dQ."""
    t = q.shape[2]
    dq = torch.zeros_like(q)
    for q0 in range(0, t, TILE):
        rows = slice(q0, q0 + TILE)
        rl = 1.0 / l[:, :, rows][..., None]
        acc = torch.zeros_like(q[:, :, rows])
        for k0 in range(0, q0 + 1, TILE):
            cols = slice(k0, k0 + TILE)
            keep = _keep(seg, rows, cols)
            s = _split_nt(q[:, :, rows], k[:, :, cols])
            dp = _split_nt(do[:, :, rows], v[:, :, cols])
            p = torch.where(keep, torch.exp(s * scale - m[:, :, rows][..., None]) * rl, 0.0)
            ds = p * (dp - di[:, :, rows][..., None]) * scale
            acc += torch.matmul(ds, k[:, :, cols])
        dq[:, :, rows] = acc
    return dq


def _args(t, dtype, seed):
    """JAX's VJP (dQ, dK, dV) and the backward's operands from the plain
    forward at B 3, H 2, T t, D 256."""
    q, k, v, do, mask = _inputs(t, dtype, seed)
    want = _jax_vjp(q, k, v, do, mask)
    scale = 1.0 / math.sqrt(D)
    tq, tk, tv, seg, o, l, m = _forward(q, k, v, mask, scale)
    tdo = torch.from_numpy(do)
    return want, (tq, tk, tv, seg, l, m, tdo, output_dot(o, tdo), scale)


@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_split_f32_w_schedules_match_jax_vjp(dtype, t):
    """Both kernels' schedules, held against JAX's VJP (dQ, dK, dV) at D 256
    on padded segments: the padded examples' steps that cross a padding
    boundary, and a padded row's tiles of valid keys, give what JAX gives."""
    want, args = _args(t, dtype, seed=t + 31)
    dk, dv = _dkv_schedule(*args)
    dq = _dq_schedule(*args)
    for got, w in zip((dq, dk, dv), want):
        _close(got, w, TOL[dtype])


@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_split_f32_w_wrappers_match_jax_vjp(dtype, t):
    """On CPU tensors F2SW's and F3SW's wrappers take the plain versions, bit
    for bit, and give JAX's VJP, without counting a launch."""
    want, args = _args(t, dtype, seed=t + 32)
    counts = [fn.launches for fn in WRAPPERS.values()]
    dk, dv = flash_backward_dkv_f32_d256(*args)
    dq = flash_backward_dq_f32_d256(*args)
    assert counts == [fn.launches for fn in WRAPPERS.values()]
    plain = (*flash_backward_dkv_reference(*args), flash_backward_dq_reference(*args))
    assert all(torch.equal(a, b) for a, b in zip((dk, dv, dq), plain))
    for got, w in zip((dq, dk, dv), want):
        _close(got, w, TOL[dtype])


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_split_f32_w_wrappers_reject_other_devices(name):
    x = torch.empty((1, 1, 128, D), dtype=torch.float32, device="meta")
    seg = torch.empty((1, 128), dtype=torch.int32, device="meta")
    stat = torch.empty((1, 1, 128), device="meta")
    before = WRAPPERS[name].launches
    with pytest.raises(ValueError, match="CPU or CUDA"):
        WRAPPERS[name](x, x, x, seg, stat, stat, x, stat, 0.0625)
    assert WRAPPERS[name].launches == before


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 256), (torch.float16, 256),
                                     (torch.float64, 256), (torch.float32, 64),
                                     (torch.float32, 128)])
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_split_f32_w_wrappers_reject_other_dtypes_and_head_dims(monkeypatch, name, dtype, d):
    """Off the CPU a wrapper takes only its route's operands, fp32 at D 256:
    past the device and shape checks (stubbed here, where no card is), any
    other type or head dim raises rather than reaching the kernel."""
    monkeypatch.setattr(flash, "_check_cuda", lambda tensors, seg, stats=(): tuple(tensors[0].shape))
    x = torch.empty((1, 1, 128, d), dtype=dtype, device="meta")
    seg = torch.empty((1, 128), dtype=torch.int32, device="meta")
    stat = torch.empty((1, 1, 128), device="meta")
    before = WRAPPERS[name].launches
    with pytest.raises(ValueError, match="split_f32_w"):
        WRAPPERS[name](x, x, x, seg, stat, stat, x, stat, 0.0625)
    assert WRAPPERS[name].launches == before


@pytest.mark.parametrize("which", ["segment ids", "l", "m", "di"])
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_split_f32_w_wrappers_reject_misaligned_operands(monkeypatch, name, which):
    """The kernels copy the segment ids (F2SW also l, m and di) with 16-byte
    cp.async: past the device and shape checks (stubbed here, where no card
    is), an operand that does not start on 16 bytes raises before any
    launch."""
    monkeypatch.setattr(flash, "_check_cuda", lambda tensors, seg, stats=(): tuple(tensors[0].shape))
    x = torch.empty((1, 1, 128, D), dtype=torch.float32, device="meta")
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
def test_function_fp32_d256_gradient_goes_through_split_f32_w_and_matches_jax_vjp(monkeypatch, t):
    """FlashAttention's fp32 D 256 gradient on CPU tensors: the backward calls
    F2SW's and F3SW's wrappers and no other flash backward wrapper (F2's and
    F3's never), which take the plain versions, and the gradient is JAX's VJP."""
    q, k, v, do, mask = _inputs(t, np.float32, seed=t + 33)
    want = _jax_vjp(q, k, v, do, mask)
    tq, tk, tv, tdo, tmask = map(torch.from_numpy, (q, k, v, do, mask))
    called = []
    for name in BACKWARD_NAMES:
        wrapper = getattr(attention, name)
        monkeypatch.setattr(attention, name,
                            lambda *args, _n=name, _w=wrapper: called.append(_n) or _w(*args))
    wrappers = [getattr(flash, name) for name in BACKWARD_NAMES]
    counts = [fn.launches for fn in wrappers]
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = FlashAttention.apply(*leaves, segment_ids_for(tmask, tq), 1.0 / math.sqrt(D))
    dq, dk, dv = torch.autograd.grad(out, leaves, tdo)
    assert called == ["flash_backward_dkv_f32_d256", "flash_backward_dq_f32_d256"]
    assert counts == [fn.launches for fn in wrappers]
    for got, w in zip((dq, dk, dv), want):
        _close(got, w, TOL[np.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("t", [256, 512])
def test_cuda_split_f32_w_kernels_match_plain_versions(t):
    """Card only: F2SW and F3SW against their plain versions at every position
    of dQ, dK and dV at (2, 4, T, 256) fp32, padded, within 1e-5 of the
    largest plain value (the same fp32 sums in another order), as
    chip_smoke.py holds them; two calls give the same bits; bf16 and D 128
    raise with the launch counts unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain versions only")
    g = torch.Generator("cuda").manual_seed(7)
    q, k, v, do = (torch.randn(2, 4, t, D, generator=g, device="cuda") for _ in range(4))
    seg = torch.ones(2, t, dtype=torch.int32, device="cuda")
    seg[1, t - 56:] = 0
    scale = D ** -0.5
    o, l, m = flash_forward_reference(q, k, v, seg, scale)
    di = output_dot(o, do)
    args = (q, k, v, seg, l, m, do, di, scale)
    before = [fn.launches for fn in WRAPPERS.values()]
    got = (flash_backward_dq_f32_d256(*args), *flash_backward_dkv_f32_d256(*args))
    again = (flash_backward_dq_f32_d256(*args), *flash_backward_dkv_f32_d256(*args))
    assert [fn.launches for fn in WRAPPERS.values()] == [n + 2 for n in before]
    want = (flash_backward_dq_reference(*args), *flash_backward_dkv_reference(*args))
    torch.cuda.synchronize()
    for x, x2, y in zip(got, again, want):
        assert torch.equal(x, x2)
        assert float((x - y).abs().max()) <= 1e-5 * float(y.abs().max())
    for bad in (q.to(torch.bfloat16), torch.randn(2, 4, t, 128, device="cuda")):
        for fn in WRAPPERS.values():
            counts = fn.launches
            with pytest.raises((ValueError, TypeError)):
                fn(bad, bad, bad, seg, l, m, bad, di, scale)
            assert fn.launches == counts
