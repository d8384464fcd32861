"""WikiText-2 language-modeling pipeline: data, GPT-2-class model and task.

Port of `examples/wikitext/pipeline.py`. The data is a synthetic token stream
with WikiText-2's chunk shapes, made with numpy from a seed; nothing is
fetched (the JAX example's `--real`, a locally cached dataset, is not
ported).
"""

from typing import Dict, List, Optional

import numpy as np

from kronfluence_tpu_torch.examples.common import lm_loss, synthetic_tokens
from kronfluence_tpu_torch.models.transformer import TransformerConfig, init_transformer
from kronfluence_tpu_torch.task import Task


class LanguageModelingTask(Task):
    """Summed next-token cross-entropy (sampled labels with `sample`, the true
    Fisher); the measurement is the same loss. Tracks the attention and MLP
    projections of every layer ("all") or the MLP's alone ("mlp")."""

    def __init__(self, num_layers: int, track: str = "all"):
        self.num_layers = num_layers
        self.track = track

    def compute_train_loss(self, batch, model, sample=False, generator=None):
        return lm_loss(batch, model, sample, generator)

    def compute_measurement(self, batch, model):
        return self.compute_train_loss(batch, model)

    def get_influence_tracked_modules(self) -> Optional[List[str]]:
        names = []
        for i in range(self.num_layers):
            if self.track == "all":
                names += [f"h_{i}/attn/c_attn", f"h_{i}/attn/c_proj"]
            names += [f"h_{i}/mlp/c_fc", f"h_{i}/mlp/c_proj"]
        return names

    def get_attention_mask(self, batch):
        return batch["attention_mask"]


def get_wikitext_dataset(
    split: str,
    num: int,
    seq_len: int = 512,
    vocab: int = 50257,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """`num` chunks of `seq_len` synthetic tokens; the train split from
    `seed`, every other split from `seed + 1`."""
    return synthetic_tokens(num, seq_len, vocab, seed=seed + (0 if split == "train" else 1))


def construct_gpt2(
    num_layers: int = 12,
    d_model: int = 768,
    num_heads: int = 12,
    seq_len: int = 512,
    vocab: int = 50257,
    seed: int = 0,
    device=None,
):
    """GPT-2-small-shaped fp32 TransformerLM, weights from `seed`, on
    `device` (the card unless the caller names another)."""
    config = TransformerConfig(
        vocab_size=vocab, max_seq_len=seq_len,
        num_layers=num_layers, num_heads=num_heads, d_model=d_model,
    )
    return init_transformer(config, seed=seed, device=device)
