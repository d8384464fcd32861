"""Decoder-only transformer LM (GPT-2 class) as a torch `nn.Module`.

Port of `kronfluence_tpu/models/transformer.py`. Every projection is an
`nn.Linear`, so capture tracks it. The module tree mirrors the flax paths:
blocks are attributes `h_0 .. h_{L-1}` (not a ModuleList), so a tracked
module's qualified name `h_0.attn.c_attn` maps to the flax name
`h_0/attn/c_attn` and factor keys match between the two packages.

Numerics that follow the flax model rather than torch's defaults:
  * LayerNorm eps is 1e-6 (flax), not 1e-5 (torch);
  * GELU is the tanh form (`jax.nn.gelu`'s default);
  * attention is causal AND key-masked, masked scores set to finfo.min
    (`kronfluence_tpu/ops/attention.py:_naive_attention`), unless
    `TransformerConfig.attention` is "flash" (`ops/attention.py`).

The port computes in its parameters' dtype: `TransformerConfig.dtype` is both
the parameter and the compute dtype (bf16 on the GPU main path).
"""

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from kronfluence_tpu_torch.ops.attention import (  # noqa: F401 (naive_attention re-exported)
    ATTENTION_IMPLS,
    naive_attention,
    scaled_dot_attention,
)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50257
    max_seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_mlp: Optional[int] = None  # defaults to 4*d_model
    dtype: torch.dtype = torch.float32  # parameter and compute dtype
    attention: str = "naive"  # or "flash": ops/attention.py, F1-F3

    def __post_init__(self) -> None:
        if self.attention not in ATTENTION_IMPLS:
            raise ValueError(f"attention must be one of {ATTENTION_IMPLS}; got {self.attention!r}.")

    @property
    def mlp_dim(self) -> int:
        return self.d_mlp or 4 * self.d_model


def gpt2_small(**overrides) -> TransformerConfig:
    return TransformerConfig(**overrides)


def tiny_config(**overrides) -> TransformerConfig:
    base = dict(vocab_size=128, max_seq_len=32, num_layers=2, num_heads=2, d_model=32)
    base.update(overrides)
    return TransformerConfig(**base)


class Attention(nn.Module):
    def __init__(self, config: TransformerConfig, device=None) -> None:
        super().__init__()
        d = config.d_model
        kw = dict(device=device, dtype=config.dtype)
        self.num_heads = config.num_heads
        self.impl = config.attention
        self.c_attn = nn.Linear(d, 3 * d, **kw)
        self.c_proj = nn.Linear(d, d, **kw)

    def forward(self, x: torch.Tensor, attention_mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, t, d = x.shape
        head_dim = d // self.num_heads
        q, k, v = self.c_attn(x).split(d, dim=-1)

        def heads(z):
            return z.reshape(b, t, self.num_heads, head_dim).transpose(1, 2)

        out = scaled_dot_attention(heads(q), heads(k), heads(v), attention_mask, self.impl)
        return self.c_proj(out.transpose(1, 2).reshape(b, t, d))


class MLPBlock(nn.Module):
    def __init__(self, config: TransformerConfig, device=None) -> None:
        super().__init__()
        kw = dict(device=device, dtype=config.dtype)
        self.c_fc = nn.Linear(config.d_model, config.mlp_dim, **kw)
        self.c_proj = nn.Linear(config.mlp_dim, config.d_model, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))


class Block(nn.Module):
    def __init__(self, config: TransformerConfig, device=None) -> None:
        super().__init__()
        kw = dict(eps=1e-6, device=device, dtype=config.dtype)
        self.ln_1 = nn.LayerNorm(config.d_model, **kw)
        self.attn = Attention(config, device)
        self.ln_2 = nn.LayerNorm(config.d_model, **kw)
        self.mlp = MLPBlock(config, device)

    def forward(self, x: torch.Tensor, attention_mask: Optional[torch.Tensor]) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), attention_mask)
        return x + self.mlp(self.ln_2(x))


class TransformerLM(nn.Module):
    """Decoder-only LM; returns logits (b, t, vocab)."""

    def __init__(self, config: TransformerConfig, device=None) -> None:
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=config.dtype)
        self.wte = nn.Embedding(config.vocab_size, config.d_model, **kw)
        self.wpe = nn.Embedding(config.max_seq_len, config.d_model, **kw)
        for i in range(config.num_layers):
            self.add_module(f"h_{i}", Block(config, device))
        self.ln_f = nn.LayerNorm(config.d_model, eps=1e-6, **kw)
        self.lm_head = nn.Linear(config.d_model, config.vocab_size, bias=False, **kw)

    def forward(
        self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        t = input_ids.shape[1]
        pos = torch.arange(t, device=input_ids.device)
        x = self.wte(input_ids) + self.wpe(pos)[None]
        for i in range(self.config.num_layers):
            x = getattr(self, f"h_{i}")(x, attention_mask)
        return self.lm_head(self.ln_f(x))


@torch.no_grad()
def init_transformer(
    config: TransformerConfig, seed: int = 0, device=None
) -> TransformerLM:
    """Builds a TransformerLM with random weights drawn from a seeded
    `torch.Generator` on `device` (the card unless the caller names another): flax's initializer scales (lecun-normal
    scale for Linear weights, 1/sqrt(d) for embeddings, zero biases, unit
    LayerNorm scales). The weights are not flax's: tests that compare the two
    packages convert flax params with `models/convert.py`."""
    device = torch.device("cuda" if device is None else device)
    model = TransformerLM(config, device=device)
    gen = torch.Generator(device).manual_seed(seed)
    for module in model.modules():
        if isinstance(module, nn.Linear):
            module.weight.normal_(0.0, 1.0 / math.sqrt(module.in_features), generator=gen)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(0.0, 1.0 / math.sqrt(module.embedding_dim), generator=gen)
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    return model
