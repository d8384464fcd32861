"""F1-F3, FF, FFH, FFW, FFS, FFS64, FB, F2H, F3H, F2W, F3W, F2S, F3S, F2SH,
F3SH, F2SW and F3SW:
causal, segment-masked flash attention, hand-written for Hopper.

Port of the TPU kernels that `kronfluence_tpu/ops/attention.py:_flash_attention`
reaches in JAX's Pallas flash attention: `_flash_attention_impl` (F1, the
forward), `_flash_attention_bwd_dkv` (F2) and `_flash_attention_bwd_dq` (F3).
The CUDA kernels F1-F3 are in `csrc/flash_attention.cu` (bf16 or fp32, D in
{64, 128, 256}, T a multiple of 64); they are on no route: they stay callable
as the yardstick of the kernels that took their place. In bf16 at D 64 (GPT-2's heads) two kernels of their own take over: FF, F1's
work with a cp.async K/V ring (T a multiple of 64), and FB, in
`csrc/flash_backward.cu`, F2's and F3's work in one launch. In bf16 at D 128
(Llama's heads) FFH, the same pipelined body as FF instanced at D 128 (both in
`csrc/flash_forward.cu`), takes F1's work, and F2H and F3H, in
`csrc/flash_backward_d128.cu`, take F2's and F3's: two deterministic kernels
with ldmatrix fragments and cp.async rings. In bf16 at D 256 (the Gemma
family's heads) F2W and F3W, in `csrc/flash_backward_d256.cu`, take F2's and
F3's: the same design with dK and dV split over two warps a 16-key group
(each half of D), P^T and dS^T traded between them through shared memory,
and 32-key steps for dQ; and FFW, in `csrc/flash_forward_d256.cu`, takes
F1's: wgmma for both products, two warpgroups of 64 query rows, Q and a
two-stage K/V ring loaded by TMA (T a multiple of 128, deterministic). In fp32 the work goes to
deterministic kernels of register-tiled fp32 FMAs fed by 128-bit shared loads
and cp.async rings: FFS takes F1's at D 128 and D 256 (`csrc/flash_forward_f32.cu`,
one body templated over D), FFS64 at D 64 (`csrc/flash_forward_f32_d64.cu`:
outer products from transposed Q, K and P on 4 x 8 thread tiles, a
128-query tile; T a multiple of 128), F2S and F3S take F2's and F3's at D 64
(`csrc/flash_backward_f32.cu`), F2SH and F3SH at D 128
(`csrc/flash_backward_f32_d128.cu`), F2SW and F3SW at D 256
(`csrc/flash_backward_f32_d256.cu`, D split between two warp groups for S
and dP). `forward_route` picks FF ("pipelined"), FFH ("pipelined_h"), FFW
("wgmma_w"), FFS ("tiled_f32"), FFS64 ("tiled_f32_64") or F1 ("generic", which
no type and head dim the kernels take reaches); `backward_route` FB ("fused"), F2H + F3H
("split_h"), F2W + F3W ("split_w"), F2S + F3S ("split_f32"), F2SH + F3SH ("split_f32_h"), F2SW +
F3SW ("split_f32_w") or F2 + F3 ("split").

Each wrapper launches its kernel for CUDA tensors and takes its plain PyTorch
version only for CPU tensors; for a CUDA tensor it launches the kernel or
raises. Each counts its launches in `.launches`.

Semantics (JAX's `mha_reference_no_custom_vjp` / `mha_reference_bwd`):
logits = (Q Kᵀ)·scale + mask_value where the key lies above the diagonal or
in another segment; F1 returns O and the row max m and row sum l of
exp(logits − m); the backward takes di = rowsum(O∘dO) and recomputes
P = exp(logits − m) / l, dS = P∘(dP − di)·scale. The plain versions compute
in fp32 (fp64 for fp64 operands) and round P and dS to the operand type
before their products, as the kernels do.
"""

from typing import Tuple

import numpy as np
import torch

from kronfluence_tpu_torch.ops.kernels.build import check_launch, load_library

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
HEAD_DIMS = (64, 128, 256)
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
# The one operand type and head dim FF and FB take.
FUSED_DTYPE, FUSED_HEAD_DIM = torch.bfloat16, 64
# The one head dim FFH, F2H and F3H take, in FUSED_DTYPE, and F2SH and F3SH
# in SPLIT_F32_DTYPE; FFH's query tile: T must be a multiple of it.
SPLIT_H_HEAD_DIM = 128
# The one head dim F2W and F3W take, in FUSED_DTYPE, and F2SW and F3SW in
# SPLIT_F32_DTYPE.
SPLIT_W_HEAD_DIM = 256
FFH_QUERY_TILE = 128
# FFW's query tile: T must be a multiple of it.
FFW_QUERY_TILE = 128
# The one operand type and head dim F2S and F3S take.
SPLIT_F32_DTYPE, SPLIT_F32_HEAD_DIM = torch.float32, 64
# The head dims FFS takes, in SPLIT_F32_DTYPE, and its query tile: T must be
# a multiple of it.
TILED_F32_HEAD_DIMS = (128, 256)
FFS_QUERY_TILE = 64
# The one head dim FFS64 takes, in SPLIT_F32_DTYPE, and its query tile: T
# must be a multiple of it.
TILED_F32_64_HEAD_DIM = 64
FFS64_QUERY_TILE = 128


def forward_route(dtype: torch.dtype, head_dim: int) -> str:
    """"pipelined" (FF) for bf16 at D 64, "pipelined_h" (FFH) for bf16 at D
    128, "wgmma_w" (FFW) for bf16 at D 256, "tiled_f32" (FFS) for fp32 at D
    128 and 256, "tiled_f32_64" (FFS64) for fp32 at D 64, else "generic" (F1,
    which no type and head dim the kernels take reaches)."""
    if dtype == FUSED_DTYPE and head_dim == FUSED_HEAD_DIM:
        return "pipelined"
    if dtype == FUSED_DTYPE and head_dim == SPLIT_H_HEAD_DIM:
        return "pipelined_h"
    if dtype == FUSED_DTYPE and head_dim == SPLIT_W_HEAD_DIM:
        return "wgmma_w"
    if dtype == SPLIT_F32_DTYPE and head_dim in TILED_F32_HEAD_DIMS:
        return "tiled_f32"
    if dtype == SPLIT_F32_DTYPE and head_dim == TILED_F32_64_HEAD_DIM:
        return "tiled_f32_64"
    return "generic"


def backward_route(dtype: torch.dtype, head_dim: int) -> str:
    """"fused" (FB, one launch) for bf16 at D 64, "split_h" (F2H + F3H) for
    bf16 at D 128, "split_w" (F2W + F3W) for bf16 at D 256, "split_f32" (F2S
    + F3S) for fp32 at D 64, "split_f32_h" (F2SH + F3SH) for fp32 at D 128,
    "split_f32_w" (F2SW + F3SW) for fp32 at D 256, else "split" (F2 + F3)."""
    if dtype == FUSED_DTYPE and head_dim == FUSED_HEAD_DIM:
        return "fused"
    if dtype == FUSED_DTYPE and head_dim == SPLIT_H_HEAD_DIM:
        return "split_h"
    if dtype == FUSED_DTYPE and head_dim == SPLIT_W_HEAD_DIM:
        return "split_w"
    if dtype == SPLIT_F32_DTYPE and head_dim == SPLIT_F32_HEAD_DIM:
        return "split_f32"
    if dtype == SPLIT_F32_DTYPE and head_dim == SPLIT_H_HEAD_DIM:
        return "split_f32_h"
    if dtype == SPLIT_F32_DTYPE and head_dim == SPLIT_W_HEAD_DIM:
        return "split_f32_w"
    return "split"


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _logits(q, k, segment_ids, sm_scale) -> torch.Tensor:
    """Masked, scaled logits (B, H, Tq, Tk) in the compute dtype."""
    c = _compute_dtype(q.dtype)
    t = q.shape[2]
    s = torch.matmul(q.to(c), k.to(c).transpose(-1, -2)) * sm_scale
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    same = segment_ids[:, :, None] == segment_ids[:, None, :]
    mask = causal[None, None] & same[:, None]
    return torch.where(mask, s, s + MASK_VALUE)


def _probabilities(q, k, segment_ids, l, m, sm_scale) -> torch.Tensor:
    return torch.exp(_logits(q, k, segment_ids, sm_scale) - m[..., None]) / l[..., None]


def flash_forward_reference(q, k, v, segment_ids, sm_scale):
    """Plain F1: (O in q's dtype, l, m in the compute dtype)."""
    s = _logits(q, k, segment_ids, sm_scale)
    m = s.max(dim=-1).values
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    c = s.dtype
    o = torch.matmul(p.to(v.dtype).to(c), v.to(c)) / l[..., None]
    return o.to(q.dtype), l, m


def flash_backward_dkv_reference(q, k, v, segment_ids, l, m, do, di, sm_scale):
    """Plain F2: (dK, dV) in the operands' dtype."""
    p = _probabilities(q, k, segment_ids, l, m, sm_scale)
    c = p.dtype
    dv = torch.matmul(p.to(do.dtype).to(c).transpose(-1, -2), do.to(c))
    dp = torch.matmul(do.to(c), v.to(c).transpose(-1, -2))
    ds = p * (dp - di[..., None]) * sm_scale
    dk = torch.matmul(ds.to(q.dtype).to(c).transpose(-1, -2), q.to(c))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_dq_reference(q, k, v, segment_ids, l, m, do, di, sm_scale):
    """Plain F3: dQ in q's dtype."""
    p = _probabilities(q, k, segment_ids, l, m, sm_scale)
    c = p.dtype
    dp = torch.matmul(do.to(c), v.to(c).transpose(-1, -2))
    ds = p * (dp - di[..., None]) * sm_scale
    return torch.matmul(ds.to(k.dtype).to(c), k.to(c)).to(q.dtype)


def flash_backward_reference(q, k, v, segment_ids, l, m, do, di, sm_scale):
    """Plain FB: (dQ, dK, dV), with P, dP and dS computed once; the same
    operations as F2's and F3's plain versions, so bit for bit their results."""
    p = _probabilities(q, k, segment_ids, l, m, sm_scale)
    c = p.dtype
    dv = torch.matmul(p.to(do.dtype).to(c).transpose(-1, -2), do.to(c))
    dp = torch.matmul(do.to(c), v.to(c).transpose(-1, -2))
    ds = (p * (dp - di[..., None]) * sm_scale).to(q.dtype).to(c)
    dk = torch.matmul(ds.transpose(-1, -2), q.to(c))
    dq = torch.matmul(ds, k.to(c))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_cuda(tensors, segment_ids, stats=()) -> Tuple[int, int, int, int]:
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash attention takes CPU or CUDA tensors; got device {q.device}.")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the flash kernels take bf16 or fp32 operands; got {q.dtype}.")
    if q.dim() != 4:
        raise ValueError(f"flash attention takes (B, H, T, D) operands; got {tuple(q.shape)}.")
    b, h, t, d = q.shape
    if d not in HEAD_DIMS or t % 64 or t == 0:
        raise ValueError(f"the flash kernels take D in {HEAD_DIMS} and T a multiple of 64; "
                         f"got T {t}, D {d}.")
    for x in tensors:
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError("flash attention operands must share shape, dtype and device.")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("flash attention operands must be contiguous and 16-byte aligned.")
    if (segment_ids.shape != (b, t) or segment_ids.dtype != torch.int32
            or segment_ids.device != q.device or not segment_ids.is_contiguous()):
        raise ValueError("segment ids must be a contiguous int32 (B, T) tensor on q's device.")
    for x in stats:
        if (x.shape != (b, h, t) or x.dtype != torch.float32 or x.device != q.device
                or not x.is_contiguous()):
            raise ValueError("l, m and di must be contiguous fp32 (B, H, T) tensors on q's device.")
    return b, h, t, d


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def flash_forward(q, k, v, segment_ids, sm_scale: float):
    """F1: returns (O, l, m); l and m are fp32 (B, H, T) on the card."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, segment_ids, sm_scale)
    b, h, t, d = _check_cuda((q, k, v), segment_ids)
    with torch.cuda.device(q.device):
        lib = load_library()
        o = torch.empty_like(q)
        l = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
        m = torch.empty_like(l)
        err = lib.kf_flash_fwd(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            segment_ids.data_ptr(), o.data_ptr(), l.data_ptr(), m.data_ptr(),
            b, h, t, d, float(sm_scale), _stream(q.device),
        )
        check_launch(err, "flash forward (F1)")
    flash_forward.launches += 1
    return o, l, m


def _launch_pipelined(entry: str, name: str, route: str, q, k, v, segment_ids, sm_scale):
    """FF's, FFH's, FFW's, FFS's or FFS64's launch: checks the route, the segment ids'
    alignment (copied 16 bytes at a time: cp.async, or FFW's bulk copy) and
    the operands, then (O, l, m)."""
    if forward_route(q.dtype, q.shape[-1]) != route:
        raise ValueError(f"{name} takes the forward route {route!r}; got {q.dtype}, "
                         f"D {q.shape[-1]}: use the route `forward_route` gives.")
    if segment_ids.data_ptr() % 16:
        raise ValueError(f"{name} takes 16-byte aligned segment ids.")
    b, h, t, d = _check_cuda((q, k, v), segment_ids)
    with torch.cuda.device(q.device):
        lib = load_library()
        o = torch.empty_like(q)
        l = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
        m = torch.empty_like(l)
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(), o.data_ptr(),
            l.data_ptr(), m.data_ptr(), b, h, t, d, float(sm_scale), _stream(q.device),
        )
        check_launch(err, f"pipelined flash forward ({name})")
    return o, l, m


def flash_forward_pipelined(q, k, v, segment_ids, sm_scale: float):
    """FF: returns (O, l, m) like F1; CUDA operands must be bf16 at D 64
    (`forward_route` "pipelined"), T a multiple of 64 (FF's query tile)."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, segment_ids, sm_scale)
    out = _launch_pipelined("kf_flash_fwd_pipelined", "FF", "pipelined",
                            q, k, v, segment_ids, sm_scale)
    flash_forward_pipelined.launches += 1
    return out


def flash_forward_d128(q, k, v, segment_ids, sm_scale: float):
    """FFH: returns (O, l, m) like F1; CUDA operands must be bf16 at D 128
    (`forward_route` "pipelined_h"), T a multiple of 128 (FFH's query tile).
    Deterministic: two calls give the same bits."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, segment_ids, sm_scale)
    if q.dim() == 4 and q.shape[2] % FFH_QUERY_TILE:
        raise ValueError(f"FFH takes T a multiple of {FFH_QUERY_TILE}; got T {q.shape[2]}.")
    out = _launch_pipelined("kf_flash_fwd_d128", "FFH", "pipelined_h",
                            q, k, v, segment_ids, sm_scale)
    flash_forward_d128.launches += 1
    return out


def flash_forward_d256(q, k, v, segment_ids, sm_scale: float):
    """FFW: returns (O, l, m) like F1; CUDA operands must be bf16 at D 256
    (`forward_route` "wgmma_w"), T a multiple of 128 (FFW's query tile).
    Deterministic: two calls give the same bits."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, segment_ids, sm_scale)
    if q.dim() == 4 and q.shape[2] % FFW_QUERY_TILE:
        raise ValueError(f"FFW takes T a multiple of {FFW_QUERY_TILE}; got T {q.shape[2]}.")
    out = _launch_pipelined("kf_flash_fwd_d256", "FFW", "wgmma_w",
                            q, k, v, segment_ids, sm_scale)
    flash_forward_d256.launches += 1
    return out


def flash_forward_f32(q, k, v, segment_ids, sm_scale: float):
    """FFS: returns (O, l, m) like F1; CUDA operands must be fp32 at D 128 or
    256 (`forward_route` "tiled_f32"), T a multiple of 64. Deterministic: two
    calls give the same bits."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, segment_ids, sm_scale)
    if q.dim() == 4 and q.shape[2] % FFS_QUERY_TILE:
        raise ValueError(f"FFS takes T a multiple of {FFS_QUERY_TILE}; got T {q.shape[2]}.")
    out = _launch_pipelined("kf_flash_fwd_f32", "FFS", "tiled_f32",
                            q, k, v, segment_ids, sm_scale)
    flash_forward_f32.launches += 1
    return out


def flash_forward_f32_d64(q, k, v, segment_ids, sm_scale: float):
    """FFS64: returns (O, l, m) like F1; CUDA operands must be fp32 at D 64
    (`forward_route` "tiled_f32_64"), T a multiple of 128 (FFS64's query
    tile). Deterministic: two calls give the same bits."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, segment_ids, sm_scale)
    if q.dim() == 4 and q.shape[2] % FFS64_QUERY_TILE:
        raise ValueError(f"FFS64 takes T a multiple of {FFS64_QUERY_TILE}; got T {q.shape[2]}.")
    out = _launch_pipelined("kf_flash_fwd_f32_d64", "FFS64", "tiled_f32_64",
                            q, k, v, segment_ids, sm_scale)
    flash_forward_f32_d64.launches += 1
    return out


def flash_backward_dkv(q, k, v, segment_ids, l, m, do, di, sm_scale: float):
    """F2: returns (dK, dV)."""
    if q.device.type == "cpu":
        return flash_backward_dkv_reference(q, k, v, segment_ids, l, m, do, di, sm_scale)
    b, h, t, d = _check_cuda((q, k, v, do), segment_ids, (l, m, di))
    with torch.cuda.device(q.device):
        lib = load_library()
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        err = lib.kf_flash_bwd_dkv(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            segment_ids.data_ptr(), l.data_ptr(), m.data_ptr(), do.data_ptr(), di.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, t, d, float(sm_scale), _stream(q.device),
        )
        check_launch(err, "flash backward dK/dV (F2)")
    flash_backward_dkv.launches += 1
    return dk, dv


def flash_backward_dq(q, k, v, segment_ids, l, m, do, di, sm_scale: float):
    """F3: returns dQ."""
    if q.device.type == "cpu":
        return flash_backward_dq_reference(q, k, v, segment_ids, l, m, do, di, sm_scale)
    b, h, t, d = _check_cuda((q, k, v, do), segment_ids, (l, m, di))
    with torch.cuda.device(q.device):
        lib = load_library()
        dq = torch.empty_like(q)
        err = lib.kf_flash_bwd_dq(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            segment_ids.data_ptr(), l.data_ptr(), m.data_ptr(), do.data_ptr(), di.data_ptr(),
            dq.data_ptr(), b, h, t, d, float(sm_scale), _stream(q.device),
        )
        check_launch(err, "flash backward dQ (F3)")
    flash_backward_dq.launches += 1
    return dq


def flash_backward(q, k, v, segment_ids, l, m, do, di, sm_scale: float):
    """FB: returns (dQ, dK, dV) from one launch; CUDA operands must be bf16 at
    D 64 (`backward_route` "fused"). dQ is summed over key tiles with fp32
    atomics, so on the card it is not bitwise reproducible."""
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, segment_ids, l, m, do, di, sm_scale)
    if backward_route(q.dtype, q.shape[-1]) != "fused":
        raise ValueError(f"the fused flash backward takes {FUSED_DTYPE} at D {FUSED_HEAD_DIM}; "
                         f"got {q.dtype}, D {q.shape[-1]}: use F2 and F3.")
    b, h, t, d = _check_cuda((q, k, v, do), segment_ids, (l, m, di))
    # FB copies the segment ids and the statistics with 16-byte cp.async.
    if any(x.data_ptr() % 16 for x in (segment_ids, l, m, di)):
        raise ValueError("FB takes 16-byte aligned segment ids, l, m and di.")
    with torch.cuda.device(q.device):
        lib = load_library()
        dq = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        err = lib.kf_flash_bwd_fused(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(), l.data_ptr(),
            m.data_ptr(), do.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, t, d, float(sm_scale), _stream(q.device),
        )
        check_launch(err, "fused flash backward (FB)")
    flash_backward.launches += 1
    return dq.to(q.dtype), dk, dv


def _launch_split(entry: str, name: str, route: str, outputs: int,
                  q, k, v, segment_ids, l, m, do, di, sm_scale) -> list:
    """F2H's, F3H's, F2W's, F3W's, F2S's, F3S's, F2SH's, F3SH's, F2SW's or F3SW's launch
    through the C entry `entry`: checks the operands and the route, then
    returns the `outputs` tensors it writes (dK and dV, or dQ)."""
    b, h, t, d = _check_cuda((q, k, v, do), segment_ids, (l, m, di))
    if backward_route(q.dtype, d) != route:
        raise ValueError(f"{name} takes the backward route {route!r}; got {q.dtype}, D {d}: "
                         f"use the route `backward_route` gives.")
    # The kernels copy the segment ids (F2H, F2W, F2S, F2SH and F2SW also l, m and di)
    # with 16-byte cp.async.
    if any(x.data_ptr() % 16 for x in (segment_ids, l, m, di)):
        raise ValueError(f"{name} takes 16-byte aligned segment ids, l, m and di.")
    with torch.cuda.device(q.device):
        lib = load_library()
        outs = [torch.empty_like(q) for _ in range(outputs)]
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(), l.data_ptr(),
            m.data_ptr(), do.data_ptr(), di.data_ptr(), *(x.data_ptr() for x in outs),
            b, h, t, d, float(sm_scale), _stream(q.device),
        )
        check_launch(err, f"flash backward ({name})")
    return outs


def flash_backward_dkv_d128(q, k, v, segment_ids, l, m, do, di, sm_scale: float):
    """F2H: returns (dK, dV) like F2; CUDA operands must be bf16 at D 128
    (`backward_route` "split_h"). Deterministic: two calls give the same bits."""
    if q.device.type == "cpu":
        return flash_backward_dkv_reference(q, k, v, segment_ids, l, m, do, di, sm_scale)
    dk, dv = _launch_split("kf_flash_bwd_dkv_d128", "F2H", "split_h", 2,
                           q, k, v, segment_ids, l, m, do, di, sm_scale)
    flash_backward_dkv_d128.launches += 1
    return dk, dv


def flash_backward_dq_d128(q, k, v, segment_ids, l, m, do, di, sm_scale: float):
    """F3H: returns dQ like F3; CUDA operands must be bf16 at D 128
    (`backward_route` "split_h"). Deterministic: two calls give the same bits."""
    if q.device.type == "cpu":
        return flash_backward_dq_reference(q, k, v, segment_ids, l, m, do, di, sm_scale)
    (dq,) = _launch_split("kf_flash_bwd_dq_d128", "F3H", "split_h", 1,
                          q, k, v, segment_ids, l, m, do, di, sm_scale)
    flash_backward_dq_d128.launches += 1
    return dq


def flash_backward_dkv_d256(q, k, v, segment_ids, l, m, do, di, sm_scale: float):
    """F2W: returns (dK, dV) like F2; CUDA operands must be bf16 at D 256
    (`backward_route` "split_w"). Deterministic: two calls give the same bits."""
    if q.device.type == "cpu":
        return flash_backward_dkv_reference(q, k, v, segment_ids, l, m, do, di, sm_scale)
    dk, dv = _launch_split("kf_flash_bwd_dkv_d256", "F2W", "split_w", 2,
                           q, k, v, segment_ids, l, m, do, di, sm_scale)
    flash_backward_dkv_d256.launches += 1
    return dk, dv


def flash_backward_dq_d256(q, k, v, segment_ids, l, m, do, di, sm_scale: float):
    """F3W: returns dQ like F3; CUDA operands must be bf16 at D 256
    (`backward_route` "split_w"). Deterministic: two calls give the same bits."""
    if q.device.type == "cpu":
        return flash_backward_dq_reference(q, k, v, segment_ids, l, m, do, di, sm_scale)
    (dq,) = _launch_split("kf_flash_bwd_dq_d256", "F3W", "split_w", 1,
                          q, k, v, segment_ids, l, m, do, di, sm_scale)
    flash_backward_dq_d256.launches += 1
    return dq


def flash_backward_dkv_f32(q, k, v, segment_ids, l, m, do, di, sm_scale: float):
    """F2S: returns (dK, dV) like F2; CUDA operands must be fp32 at D 64
    (`backward_route` "split_f32"). Deterministic: two calls give the same bits."""
    if q.device.type == "cpu":
        return flash_backward_dkv_reference(q, k, v, segment_ids, l, m, do, di, sm_scale)
    dk, dv = _launch_split("kf_flash_bwd_dkv_f32", "F2S", "split_f32", 2,
                           q, k, v, segment_ids, l, m, do, di, sm_scale)
    flash_backward_dkv_f32.launches += 1
    return dk, dv


def flash_backward_dq_f32(q, k, v, segment_ids, l, m, do, di, sm_scale: float):
    """F3S: returns dQ like F3; CUDA operands must be fp32 at D 64
    (`backward_route` "split_f32"). Deterministic: two calls give the same bits."""
    if q.device.type == "cpu":
        return flash_backward_dq_reference(q, k, v, segment_ids, l, m, do, di, sm_scale)
    (dq,) = _launch_split("kf_flash_bwd_dq_f32", "F3S", "split_f32", 1,
                          q, k, v, segment_ids, l, m, do, di, sm_scale)
    flash_backward_dq_f32.launches += 1
    return dq


def flash_backward_dkv_f32_d128(q, k, v, segment_ids, l, m, do, di, sm_scale: float):
    """F2SH: returns (dK, dV) like F2; CUDA operands must be fp32 at D 128
    (`backward_route` "split_f32_h"). Deterministic: two calls give the same bits."""
    if q.device.type == "cpu":
        return flash_backward_dkv_reference(q, k, v, segment_ids, l, m, do, di, sm_scale)
    dk, dv = _launch_split("kf_flash_bwd_dkv_f32_d128", "F2SH", "split_f32_h", 2,
                           q, k, v, segment_ids, l, m, do, di, sm_scale)
    flash_backward_dkv_f32_d128.launches += 1
    return dk, dv


def flash_backward_dq_f32_d128(q, k, v, segment_ids, l, m, do, di, sm_scale: float):
    """F3SH: returns dQ like F3; CUDA operands must be fp32 at D 128
    (`backward_route` "split_f32_h"). Deterministic: two calls give the same bits."""
    if q.device.type == "cpu":
        return flash_backward_dq_reference(q, k, v, segment_ids, l, m, do, di, sm_scale)
    (dq,) = _launch_split("kf_flash_bwd_dq_f32_d128", "F3SH", "split_f32_h", 1,
                          q, k, v, segment_ids, l, m, do, di, sm_scale)
    flash_backward_dq_f32_d128.launches += 1
    return dq


def flash_backward_dkv_f32_d256(q, k, v, segment_ids, l, m, do, di, sm_scale: float):
    """F2SW: returns (dK, dV) like F2; CUDA operands must be fp32 at D 256
    (`backward_route` "split_f32_w"). Deterministic: two calls give the same bits."""
    if q.device.type == "cpu":
        return flash_backward_dkv_reference(q, k, v, segment_ids, l, m, do, di, sm_scale)
    dk, dv = _launch_split("kf_flash_bwd_dkv_f32_d256", "F2SW", "split_f32_w", 2,
                           q, k, v, segment_ids, l, m, do, di, sm_scale)
    flash_backward_dkv_f32_d256.launches += 1
    return dk, dv


def flash_backward_dq_f32_d256(q, k, v, segment_ids, l, m, do, di, sm_scale: float):
    """F3SW: returns dQ like F3; CUDA operands must be fp32 at D 256
    (`backward_route` "split_f32_w"). Deterministic: two calls give the same bits."""
    if q.device.type == "cpu":
        return flash_backward_dq_reference(q, k, v, segment_ids, l, m, do, di, sm_scale)
    (dq,) = _launch_split("kf_flash_bwd_dq_f32_d256", "F3SW", "split_f32_w", 1,
                          q, k, v, segment_ids, l, m, do, di, sm_scale)
    flash_backward_dq_f32_d256.launches += 1
    return dq


flash_forward.launches = 0
flash_forward_pipelined.launches = 0
flash_forward_d128.launches = 0
flash_forward_d256.launches = 0
flash_forward_f32.launches = 0
flash_forward_f32_d64.launches = 0
flash_backward_dkv.launches = 0
flash_backward_dq.launches = 0
flash_backward.launches = 0
flash_backward_dkv_d128.launches = 0
flash_backward_dq_d128.launches = 0
flash_backward_dkv_d256.launches = 0
flash_backward_dq_d256.launches = 0
flash_backward_dkv_f32.launches = 0
flash_backward_dq_f32.launches = 0
flash_backward_dkv_f32_d128.launches = 0
flash_backward_dq_f32_d128.launches = 0
flash_backward_dkv_f32_d256.launches = 0
flash_backward_dq_f32_d256.launches = 0
