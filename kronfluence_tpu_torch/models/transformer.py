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
from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from kronfluence_tpu_torch.capture.functional import linear, scan_layers
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
    init_flax_scales_(model, torch.Generator(device).manual_seed(seed))
    return model


@torch.no_grad()
def init_flax_scales_(model: nn.Module, generator: torch.Generator) -> None:
    """Draws every Linear, Embedding and LayerNorm of `model`, in module
    order, at flax's initializer scales from `generator`."""
    for module in model.modules():
        if isinstance(module, nn.Linear):
            module.weight.normal_(0.0, 1.0 / math.sqrt(module.in_features), generator=generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(0.0, 1.0 / math.sqrt(module.embedding_dim), generator=generator)
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()


# ---------------------------------------------------------------------------
# Scanned form: one block applied over stacked (L, ...) layer parameters.
#
# The JAX package scans ONE block over a stacked parameter pytree so that the
# traced program holds one block whatever the depth (`scanned_lm_apply`,
# `capture.functional.scan_layers`). Eager torch traces nothing, so the
# port's `scan_layers` is a loop; the form is kept because users hold
# stacked checkpoints, and its tracked names are the module form's.
# ---------------------------------------------------------------------------


def _nested(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, tensor in state_dict.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = tensor
    return tree


def _stacked(layers):
    if isinstance(layers[0], Mapping):
        return {k: _stacked([layer[k] for layer in layers]) for k in layers[0]}
    return torch.stack(layers)


def stack_layer_params(state_dict: Mapping[str, torch.Tensor], num_layers: int) -> Dict[str, Any]:
    """The scanned layout of a TransformerLM `state_dict` (the port's, or one
    converted from flax by `models/convert.py:state_dict_from_flax`): the
    blocks `h_0 .. h_{L-1}` stacked leaf by leaf into `blocks`, each leaf with
    a leading (L,) axis; the embeddings, final norm and head as nested dicts
    (`{"wte": {"weight": ...}, "blocks": {"attn": {"c_attn": {"weight":
    (L, 3d, d), ...}}}, ...}`)."""
    tree = _nested(state_dict)
    layers = [tree.pop(f"h_{i}") for i in range(num_layers)]
    extra = sorted(k for k in tree if k.startswith("h_"))
    if extra:
        raise ValueError(f"state_dict holds blocks {extra} beyond num_layers={num_layers}.")
    return {"blocks": _stacked(layers), **tree}


def scanned_lm_apply(config: TransformerConfig, remat: bool = False):
    """The GPT-2 forward over `stack_layer_params` params, as a function.

    The same op sequence and dtype promotions as `TransformerLM.forward`,
    with every tracked projection a tagged `linear` and the layer stack under
    `scan_layers(..., name_format="h_{i}")`: the tracked names are the module
    form's (`h_0/attn/c_attn` ...; the head is untracked, as in the JAX
    package's scanned form), and on the same weights the two give the same
    bits. Attention goes through `ops/attention.py:scaled_dot_attention`
    with `config.attention`; `remat=True` checkpoints each block
    (`checkpoint_block`).

    Returns `apply(params, input_ids, attention_mask=None) -> logits`; bind
    it with `prepare.FunctionalModel(apply, params)`.
    """
    d = config.d_model

    def layer_norm(x, p):
        return F.layer_norm(x, (d,), p["weight"], p["bias"], eps=1e-6)

    def attention(x, p, attention_mask):
        b, t, _ = x.shape
        head_dim = d // config.num_heads
        qkv = linear(x, p["c_attn"]["weight"], p["c_attn"]["bias"], name="attn/c_attn")
        q, k, v = qkv.split(d, dim=-1)

        def heads(z):
            return z.reshape(b, t, config.num_heads, head_dim).transpose(1, 2)

        out = scaled_dot_attention(heads(q), heads(k), heads(v), attention_mask, config.attention)
        out = out.transpose(1, 2).reshape(b, t, d)
        return linear(out, p["c_proj"]["weight"], p["c_proj"]["bias"], name="attn/c_proj")

    def mlp(x, p):
        h = linear(x, p["c_fc"]["weight"], p["c_fc"]["bias"], name="mlp/c_fc")
        h = F.gelu(h, approximate="tanh")
        return linear(h, p["c_proj"]["weight"], p["c_proj"]["bias"], name="mlp/c_proj")

    def apply(params, input_ids, attention_mask=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = F.embedding(input_ids, params["wte"]["weight"])
        x = x + F.embedding(pos, params["wpe"]["weight"])[None]

        def body(h, layer):
            h = h + attention(layer_norm(h, layer["ln_1"]), layer["attn"], attention_mask)
            return h + mlp(layer_norm(h, layer["ln_2"]), layer["mlp"]), None

        x, _ = scan_layers(body, x, params["blocks"], name_format="h_{i}", remat=remat)
        return F.linear(layer_norm(x, params["ln_f"]), params["lm_head"]["weight"])

    return apply
