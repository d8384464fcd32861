"""Llama-family decoder LM (RMSNorm, RoPE, GQA, SwiGLU) as a torch `nn.Module`.

Port of `kronfluence_tpu/models/llama.py`, the model of the openwebtext
workload (Llama-3-8B, MLP-only tracking, the extreme-reduce-memory recipe).
Every projection is an `nn.Linear` without bias, and the module tree mirrors
the flax paths: blocks are attributes `layers_0 .. layers_{L-1}`, so the
tracked name `layers_0/mlp/gate_proj` is the same in both packages and
`mlp_tracked_modules` selects the MLP projections.

Numerics that follow the flax model:
  * RMSNorm computes its statistic in at least fp32 (fp64 for an fp64 model)
    and casts its output to the config's dtype;
  * RoPE rotates interleaved pairs (`x[..., 0::2]` against `x[..., 1::2]`),
    not the two halves of the head (Hugging Face's `rotate_half`), with the
    angles in at least fp32 and positions `arange(T)` whatever the mask;
  * GQA repeats each KV head into consecutive query heads
    (`repeat_interleave`, `jnp.repeat`), not a tiling of the heads;
  * attention goes through `ops/attention.py:scaled_dot_attention`, naive or
    flash as `LlamaConfig.attention` says (bf16 at head_dim 128 takes FFH
    and F2H + F3H).

`LlamaConfig.dtype` is both the parameter and the compute dtype.
"""

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from kronfluence_tpu_torch.ops.attention import ATTENTION_IMPLS, scaled_dot_attention


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    max_seq_len: int = 8192
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    d_model: int = 4096
    d_mlp: int = 14336
    rope_theta: float = 500_000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16  # parameter and compute dtype
    attention: str = "naive"  # or "flash": ops/attention.py

    def __post_init__(self) -> None:
        if self.attention not in ATTENTION_IMPLS:
            raise ValueError(f"attention must be one of {ATTENTION_IMPLS}; got {self.attention!r}.")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def llama3_8b_config(**overrides) -> LlamaConfig:
    """Llama-3-8B's shapes (layers, vocabulary and length can be cut)."""
    return LlamaConfig(**overrides)


def tiny_llama_config(**overrides) -> LlamaConfig:
    base = dict(
        vocab_size=128, max_seq_len=32, num_layers=2, num_heads=4, num_kv_heads=2,
        d_model=32, d_mlp=112, dtype=torch.float32,
    )
    base.update(overrides)
    return LlamaConfig(**base)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype, device=None) -> None:
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stat_dtype = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(stat_dtype)
        norm = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        return (norm * self.weight.to(stat_dtype)).to(self.dtype)


def _rope(q: torch.Tensor, k: torch.Tensor, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary position embedding on (b, h, t, d) queries and keys, rotating
    the interleaved pairs (2i, 2i+1) by position x theta^(-2i/d)."""
    d, t = q.shape[-1], q.shape[-2]
    angle_dtype = torch.promote_types(q.dtype, torch.float32)
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=angle_dtype, device=q.device) / d))
    angles = torch.arange(t, dtype=angle_dtype, device=q.device)[:, None] * freqs[None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)

    def rot(x: torch.Tensor) -> torch.Tensor:
        x = x.to(angle_dtype)
        x1, x2 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(x.shape)

    return rot(q).to(q.dtype), rot(k).to(k.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, device=None) -> None:
        super().__init__()
        kw = dict(bias=False, device=device, dtype=config.dtype)
        hd = config.head_dim
        self.config = config
        self.q_proj = nn.Linear(config.d_model, config.num_heads * hd, **kw)
        self.k_proj = nn.Linear(config.d_model, config.num_kv_heads * hd, **kw)
        self.v_proj = nn.Linear(config.d_model, config.num_kv_heads * hd, **kw)
        self.o_proj = nn.Linear(config.num_heads * hd, config.d_model, **kw)

    def forward(self, x: torch.Tensor, attention_mask: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.config
        b, t, d = x.shape
        hd = cfg.head_dim

        def heads(z, n):
            return z.reshape(b, t, n, hd).transpose(1, 2)

        q = heads(self.q_proj(x), cfg.num_heads)
        k = heads(self.k_proj(x), cfg.num_kv_heads)
        v = heads(self.v_proj(x), cfg.num_kv_heads)
        q, k = _rope(q, k, cfg.rope_theta)
        group = cfg.num_heads // cfg.num_kv_heads
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
        out = scaled_dot_attention(q, k, v, attention_mask, cfg.attention)
        return self.o_proj(out.transpose(1, 2).reshape(b, t, d))


class LlamaMLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, config: LlamaConfig, device=None) -> None:
        super().__init__()
        kw = dict(bias=False, device=device, dtype=config.dtype)
        self.gate_proj = nn.Linear(config.d_model, config.d_mlp, **kw)
        self.up_proj = nn.Linear(config.d_model, config.d_mlp, **kw)
        self.down_proj = nn.Linear(config.d_mlp, config.d_model, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, config: LlamaConfig, device=None) -> None:
        super().__init__()
        norm = dict(eps=config.rms_eps, dtype=config.dtype, device=device)
        self.input_norm = RMSNorm(config.d_model, **norm)
        self.attn = LlamaAttention(config, device)
        self.post_attn_norm = RMSNorm(config.d_model, **norm)
        self.mlp = LlamaMLP(config, device)

    def forward(self, x: torch.Tensor, attention_mask: Optional[torch.Tensor]) -> torch.Tensor:
        x = x + self.attn(self.input_norm(x), attention_mask)
        return x + self.mlp(self.post_attn_norm(x))


class LlamaLM(nn.Module):
    """Decoder-only Llama; returns logits (b, t, vocab)."""

    def __init__(self, config: LlamaConfig, device=None) -> None:
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=config.dtype)
        self.embed = nn.Embedding(config.vocab_size, config.d_model, **kw)
        for i in range(config.num_layers):
            self.add_module(f"layers_{i}", LlamaBlock(config, device))
        self.final_norm = RMSNorm(config.d_model, config.rms_eps, config.dtype, device)
        self.lm_head = nn.Linear(config.d_model, config.vocab_size, bias=False, **kw)

    def forward(
        self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        x = self.embed(input_ids)
        for i in range(self.config.num_layers):
            x = getattr(self, f"layers_{i}")(x, attention_mask)
        return self.lm_head(self.final_norm(x))


def mlp_tracked_modules(num_layers: int) -> List[str]:
    """The openwebtext recipe's MLP-only tracking: gate, up and down of every layer."""
    return [
        f"layers_{i}/mlp/{proj}"
        for i in range(num_layers)
        for proj in ("gate_proj", "up_proj", "down_proj")
    ]


@torch.no_grad()
def init_llama(config: LlamaConfig, seed: int = 0, device=None) -> LlamaLM:
    """Builds a LlamaLM with random weights drawn from a seeded
    `torch.Generator` on `device` (the card unless the caller names another),
    at flax's initializer scales: 1/sqrt(fan_in) for Linear weights,
    1/sqrt(d) for the embedding, unit RMSNorm weights."""
    device = torch.device("cuda" if device is None else device)
    model = LlamaLM(config, device=device)
    gen = torch.Generator(device).manual_seed(seed)
    for module in model.modules():
        if isinstance(module, nn.Linear):
            module.weight.normal_(0.0, 1.0 / math.sqrt(module.in_features), generator=gen)
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(0.0, 1.0 / math.sqrt(module.embedding_dim), generator=gen)
        elif isinstance(module, RMSNorm):
            module.weight.fill_(1.0)
    return model
