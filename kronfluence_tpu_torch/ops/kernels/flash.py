"""F1-F3 and FB: causal, segment-masked flash attention, hand-written for Hopper.

Port of the TPU kernels that `kronfluence_tpu/ops/attention.py:_flash_attention`
reaches in JAX's Pallas flash attention: `_flash_attention_impl` (F1, the
forward), `_flash_attention_bwd_dkv` (F2) and `_flash_attention_bwd_dq` (F3).
The CUDA kernels F1-F3 are in `csrc/flash_attention.cu` (bf16 or fp32, D in
{64, 128, 256}, T a multiple of 64). FB, in `csrc/flash_backward.cu`, does
F2's and F3's work in one launch for bf16 at D 64; `backward_route` is the
rule that picks FB ("fused") or F2 + F3 ("split").

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
# The one operand type and head dim FB takes.
FUSED_DTYPE, FUSED_HEAD_DIM = torch.bfloat16, 64


def backward_route(dtype: torch.dtype, head_dim: int) -> str:
    """"fused" (FB, one launch) for bf16 at D 64, else "split" (F2 + F3)."""
    return "fused" if dtype == FUSED_DTYPE and head_dim == FUSED_HEAD_DIM else "split"


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


flash_forward.launches = 0
flash_backward_dkv.launches = 0
flash_backward_dq.launches = 0
flash_backward.launches = 0
