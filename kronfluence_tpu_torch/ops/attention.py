"""Causal, key-masked scaled-dot-product attention: the naive form and flash.

Port of `kronfluence_tpu/ops/attention.py`. The JAX package picks its Pallas
flash kernel with an environment switch, a live probe and a timed A/B; the
port takes the choice as an argument (`TransformerConfig.attention`), with
no switch, probe or fallback:

  * "naive" materialises the (B, H, T, T) scores and probabilities (the
    models' form, `_naive_attention`);
  * "flash" runs the `FlashAttention` autograd Function. For bf16 at
    head_dim 64 the forward is FF and the backward FB, one launch each; for
    bf16 at head_dim 128 (Llama) the forward is FFH and the backward F2H +
    F3H; for bf16 at head_dim 256 (Gemma) the forward is FFW (route
    "wgmma_w": wgmma fed by a TMA ring) and the backward F2W + F3W
    ("split_w"); for fp32 the forward is FFS64 at head_dim 64 (route
    "tiled_f32_64") and FFS at head_dim 128 and 256 ("tiled_f32"), and the
    backward F2S + F3S at head_dim 64 (route "split_f32"), F2SH + F3SH at
    head_dim 128 ("split_f32_h") and F2SW + F3SW at head_dim 256
    ("split_f32_w"); every route but FB is deterministic (`flash.forward_route`,
    `flash.backward_route`; `ops/kernels/flash.py`, `csrc/flash_forward.cu`,
    `csrc/flash_forward_d256.cu`, `csrc/flash_forward_f32.cu`,
    `csrc/flash_forward_f32_d64.cu`,
    `csrc/flash_backward.cu`, `csrc/flash_backward_d128.cu`,
    `csrc/flash_backward_d256.cu`, `csrc/flash_backward_f32.cu`,
    `csrc/flash_backward_f32_d128.cu`, `csrc/flash_backward_f32_d256.cu`,
    `csrc/flash_attention.cu`) for CUDA tensors, their plain versions for
    CPU tensors. A shape the kernels do not take raises; it never falls
    back to another kernel or to the naive form.

Mask semantics of the flash form are those of JAX's flash kernel: the
attention mask becomes segment ids (q = kv = mask) under the causal bound,
with an additive mask value of -0.7·finfo(f32).max and scale 1/√D. The two
forms agree at valid query rows and differ at padded ones (a padded row
attends to valid keys in the naive form, to padded keys in the flash form);
padded positions never reach a factor or a loss.
"""

import math
from typing import Optional

import torch

from kronfluence_tpu_torch.ops.kernels.flash import (
    HEAD_DIMS,
    backward_route,
    flash_backward,
    flash_backward_dkv,
    flash_backward_dkv_d128,
    flash_backward_dkv_d256,
    flash_backward_dkv_f32,
    flash_backward_dkv_f32_d128,
    flash_backward_dkv_f32_d256,
    flash_backward_dq,
    flash_backward_dq_d128,
    flash_backward_dq_d256,
    flash_backward_dq_f32,
    flash_backward_dq_f32_d128,
    flash_backward_dq_f32_d256,
    flash_backward_reference,
    flash_forward,
    flash_forward_d128,
    flash_forward_d256,
    flash_forward_f32,
    flash_forward_f32_d64,
    flash_forward_pipelined,
    flash_forward_reference,
    forward_route,
)

ATTENTION_IMPLS = ("naive", "flash")
# The JAX gate's sequence granularity (ops/attention.py:56): T >= 128 and a
# multiple of 128.
_SEQ_MULTIPLE = 128


def flash_supported(seq_len: int, head_dim: int) -> bool:
    """The JAX package's static shape gate, without its switch or CPU clause."""
    return seq_len >= _SEQ_MULTIPLE and seq_len % _SEQ_MULTIPLE == 0 and head_dim in HEAD_DIMS


def naive_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, attention_mask: Optional[torch.Tensor]
) -> torch.Tensor:
    """Causal, key-masked attention over (batch, heads, seq, head_dim) operands."""
    naive_attention.calls += 1
    t = q.shape[2]
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()[None, None]
    if attention_mask is not None:
        mask = mask & (attention_mask[:, None, None, :] > 0)
    scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    return torch.matmul(torch.softmax(scores, dim=-1), v)


naive_attention.calls = 0


def segment_ids_for(attention_mask: Optional[torch.Tensor], q: torch.Tensor) -> torch.Tensor:
    """int32 (B, T) segment ids: the attention mask, or all ones without one."""
    if attention_mask is None:
        return torch.ones(q.shape[0], q.shape[2], dtype=torch.int32, device=q.device)
    return attention_mask.to(device=q.device, dtype=torch.int32).contiguous()


def flash_attention_reference(q, k, v, attention_mask, sm_scale: Optional[float] = None):
    """Plain F1 with the flash semantics: (O, l, m)."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale
    return flash_forward_reference(q, k, v, segment_ids_for(attention_mask, q), scale)


def flash_attention_backward_reference(
    q, k, v, attention_mask, o, l, m, do, sm_scale: Optional[float] = None
):
    """Plain backward (FB's plain version, bit for bit F2's and F3's), with
    di = rowsum(O∘dO) in fp32 (fp64 for fp64): (dQ, dK, dV)."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale
    seg = segment_ids_for(attention_mask, q)
    return flash_backward_reference(q, k, v, seg, l, m, do, output_dot(o, do), scale)


def output_dot(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(O∘dO), in fp32 (fp64 for fp64 operands), as JAX computes it
    outside its kernels (flash_attention.py:273)."""
    c = torch.float64 if o.dtype == torch.float64 else torch.float32
    return (o.to(c) * do.to(c)).sum(dim=-1)


class FlashAttention(torch.autograd.Function):
    """Causal, segment-masked attention: FF, FFH, FFW, FFS or FFS64 forward
    as `forward_route` says; backward di, then FB, F2H + F3H, F2W + F3W,
    F2S + F3S, F2SH + F3SH or F2SW + F3SW as `backward_route` says (F1 and
    F2 + F3 on no route a supported type and head dim reaches)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, sm_scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        route = forward_route(q.dtype, q.shape[-1])
        if route == "pipelined":
            o, l, m = flash_forward_pipelined(q, k, v, segment_ids, sm_scale)
        elif route == "pipelined_h":
            o, l, m = flash_forward_d128(q, k, v, segment_ids, sm_scale)
        elif route == "wgmma_w":
            o, l, m = flash_forward_d256(q, k, v, segment_ids, sm_scale)
        elif route == "tiled_f32":
            o, l, m = flash_forward_f32(q, k, v, segment_ids, sm_scale)
        elif route == "tiled_f32_64":
            o, l, m = flash_forward_f32_d64(q, k, v, segment_ids, sm_scale)
        else:
            o, l, m = flash_forward(q, k, v, segment_ids, sm_scale)
        ctx.save_for_backward(q, k, v, segment_ids, o, l, m)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, segment_ids, o, l, m = ctx.saved_tensors
        do = do.contiguous()
        di = output_dot(o, do)
        route = backward_route(q.dtype, q.shape[-1])
        if route == "fused":
            dq, dk, dv = flash_backward(q, k, v, segment_ids, l, m, do, di, ctx.sm_scale)
        elif route == "split_h":
            dk, dv = flash_backward_dkv_d128(q, k, v, segment_ids, l, m, do, di, ctx.sm_scale)
            dq = flash_backward_dq_d128(q, k, v, segment_ids, l, m, do, di, ctx.sm_scale)
        elif route == "split_w":
            dk, dv = flash_backward_dkv_d256(q, k, v, segment_ids, l, m, do, di, ctx.sm_scale)
            dq = flash_backward_dq_d256(q, k, v, segment_ids, l, m, do, di, ctx.sm_scale)
        elif route == "split_f32":
            dk, dv = flash_backward_dkv_f32(q, k, v, segment_ids, l, m, do, di, ctx.sm_scale)
            dq = flash_backward_dq_f32(q, k, v, segment_ids, l, m, do, di, ctx.sm_scale)
        elif route == "split_f32_h":
            dk, dv = flash_backward_dkv_f32_d128(q, k, v, segment_ids, l, m, do, di, ctx.sm_scale)
            dq = flash_backward_dq_f32_d128(q, k, v, segment_ids, l, m, do, di, ctx.sm_scale)
        elif route == "split_f32_w":
            dk, dv = flash_backward_dkv_f32_d256(q, k, v, segment_ids, l, m, do, di, ctx.sm_scale)
            dq = flash_backward_dq_f32_d256(q, k, v, segment_ids, l, m, do, di, ctx.sm_scale)
        else:
            dk, dv = flash_backward_dkv(q, k, v, segment_ids, l, m, do, di, ctx.sm_scale)
            dq = flash_backward_dq(q, k, v, segment_ids, l, m, do, di, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, attention_mask: Optional[torch.Tensor]
) -> torch.Tensor:
    """Flash attention over (B, H, T, D) operands; raises for a shape the
    kernels do not take (T not a multiple of 128, D not in 64/128/256)."""
    t, head_dim = q.shape[2], q.shape[3]
    if not flash_supported(t, head_dim):
        raise ValueError(
            f'attention="flash" takes T >= 128 and a multiple of 128 and head_dim in '
            f"{HEAD_DIMS}; got T {t}, head_dim {head_dim}."
        )
    seg = segment_ids_for(attention_mask, q)
    return FlashAttention.apply(q, k, v, seg, 1.0 / math.sqrt(head_dim))


def scaled_dot_attention(q, k, v, attention_mask, impl: str = "naive") -> torch.Tensor:
    """Causal masked attention over (batch, heads, seq, head_dim) operands,
    by the form `impl` names ("naive" or "flash")."""
    if impl == "naive":
        return naive_attention(q, k, v, attention_mask)
    if impl == "flash":
        return flash_attention(q, k, v, attention_mask)
    raise ValueError(f"attention impl must be one of {ATTENTION_IMPLS}; got {impl!r}.")
