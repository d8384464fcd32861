"""Compact encoder-decoder transformer (T5-class) for seq2seq influence tasks.

Port of `kronfluence_tpu/models/encoder_decoder.py`, the role of the
reference's T5/CNN-DailyMail workload (examples/dailymail). Separate encoder
and decoder masks reach the modules through the dict form of
`Task.get_attention_mask`. Attention is the naive form, as in the JAX
package: non-causal self-attention in the encoder, causal self-attention and
cross-attention in the decoder, masked scores set to finfo.min.

Module names are the flax paths (`encoder_0/attn/q`, `decoder_1/cross_attn/k`,
`lm_head`), so `models/convert.py:state_dict_from_flax` carries flax params
over. LayerNorm eps is flax's 1e-6. The port computes in its parameters'
dtype (`EncDecConfig.dtype`).
"""

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from kronfluence_tpu_torch.models.transformer import init_flax_scales_


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    vocab_size: int = 128
    max_seq_len: int = 32
    num_layers: int = 2
    num_heads: int = 2
    d_model: int = 32
    dtype: torch.dtype = torch.float32  # parameter and compute dtype

    @property
    def mlp_dim(self) -> int:
        return 4 * self.d_model


def _layer_norm(config: EncDecConfig, device) -> nn.LayerNorm:
    return nn.LayerNorm(config.d_model, eps=1e-6, device=device, dtype=config.dtype)


class MultiHeadAttention(nn.Module):
    def __init__(self, config: EncDecConfig, causal: bool = False, device=None) -> None:
        super().__init__()
        d = config.d_model
        kw = dict(device=device, dtype=config.dtype)
        self.num_heads = config.num_heads
        self.causal = causal
        self.q = nn.Linear(d, d, **kw)
        self.k = nn.Linear(d, d, **kw)
        self.v = nn.Linear(d, d, **kw)
        self.o = nn.Linear(d, d, **kw)

    def forward(
        self, x: torch.Tensor, kv: Optional[torch.Tensor] = None,
        kv_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        kv = x if kv is None else kv
        b, tq, d = x.shape
        tk = kv.shape[1]
        head_dim = d // self.num_heads

        def heads(z, t):
            return z.reshape(b, t, self.num_heads, head_dim).transpose(1, 2)

        q, k, v = heads(self.q(x), tq), heads(self.k(kv), tk), heads(self.v(kv), tk)
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(head_dim)
        mask = torch.ones((1, 1, tq, tk), dtype=torch.bool, device=x.device)
        if self.causal:
            mask = mask & torch.ones((tq, tk), dtype=torch.bool, device=x.device).tril()
        if kv_mask is not None:
            mask = mask & (kv_mask[:, None, None, :] > 0)
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
        out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1), v)
        return self.o(out.transpose(1, 2).reshape(b, tq, d))


class FeedForward(nn.Module):
    def __init__(self, config: EncDecConfig, device=None) -> None:
        super().__init__()
        kw = dict(device=device, dtype=config.dtype)
        self.wi = nn.Linear(config.d_model, config.mlp_dim, **kw)
        self.wo = nn.Linear(config.mlp_dim, config.d_model, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(F.relu(self.wi(x)))


class EncoderBlock(nn.Module):
    def __init__(self, config: EncDecConfig, device=None) -> None:
        super().__init__()
        self.ln_1 = _layer_norm(config, device)
        self.attn = MultiHeadAttention(config, device=device)
        self.ln_2 = _layer_norm(config, device)
        self.mlp = FeedForward(config, device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), kv_mask=mask)
        return x + self.mlp(self.ln_2(x))


class DecoderBlock(nn.Module):
    def __init__(self, config: EncDecConfig, device=None) -> None:
        super().__init__()
        self.ln_1 = _layer_norm(config, device)
        self.self_attn = MultiHeadAttention(config, causal=True, device=device)
        self.ln_2 = _layer_norm(config, device)
        self.cross_attn = MultiHeadAttention(config, device=device)
        self.ln_3 = _layer_norm(config, device)
        self.mlp = FeedForward(config, device)

    def forward(
        self, x: torch.Tensor, enc: torch.Tensor, dec_mask: Optional[torch.Tensor],
        enc_mask: Optional[torch.Tensor],
    ) -> torch.Tensor:
        x = x + self.self_attn(self.ln_1(x), kv_mask=dec_mask)
        x = x + self.cross_attn(self.ln_2(x), kv=enc, kv_mask=enc_mask)
        return x + self.mlp(self.ln_3(x))


class EncDecLM(nn.Module):
    """Seq2seq LM: returns decoder logits (b, t_dec, vocab)."""

    def __init__(self, config: EncDecConfig, device=None) -> None:
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=config.dtype)
        self.shared = nn.Embedding(config.vocab_size, config.d_model, **kw)
        self.wpe = nn.Embedding(config.max_seq_len, config.d_model, **kw)
        for i in range(config.num_layers):
            self.add_module(f"encoder_{i}", EncoderBlock(config, device))
        self.encoder_ln = _layer_norm(config, device)
        for i in range(config.num_layers):
            self.add_module(f"decoder_{i}", DecoderBlock(config, device))
        self.decoder_ln = _layer_norm(config, device)
        self.lm_head = nn.Linear(config.d_model, config.vocab_size, bias=False, **kw)

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(ids.shape[1], device=ids.device)
        return self.shared(ids) + self.wpe(pos)[None]

    def forward(
        self, input_ids: torch.Tensor, decoder_input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        decoder_attention_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        enc = self._embed(input_ids)
        for i in range(self.config.num_layers):
            enc = getattr(self, f"encoder_{i}")(enc, attention_mask)
        enc = self.encoder_ln(enc)
        dec = self._embed(decoder_input_ids)
        for i in range(self.config.num_layers):
            dec = getattr(self, f"decoder_{i}")(dec, enc, decoder_attention_mask, attention_mask)
        return self.lm_head(self.decoder_ln(dec))


@torch.no_grad()
def init_encdec(config: EncDecConfig, seed: int = 0, device=None) -> EncDecLM:
    """An EncDecLM with random weights from a seeded `torch.Generator` on
    `device` (the card unless the caller names another), at flax's
    initializer scales as `models/transformer.py:init_transformer` draws
    them. The weights are not flax's: tests that compare the two packages
    convert flax params with `models/convert.py`."""
    device = torch.device("cuda" if device is None else device)
    model = EncDecLM(config, device=device)
    init_flax_scales_(model, torch.Generator(device).manual_seed(seed))
    return model
