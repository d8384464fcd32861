"""GLUE (SST-2-style) pipeline: data, encoder classifier and task.

Port of `examples/glue/pipeline.py`. The data is synthetic padded token
sequences with a learnable label, made with numpy from a seed; nothing is
fetched (the JAX example's `real=True`, a locally cached dataset and
tokenizer, is not ported). The model is the GPT-2 block stack of
`models/transformer.py` (causal, with the key mask) under a mean pool over the
mask and a `classifier` head; its module names are the flax paths, so
`models/convert.py:state_dict_from_flax(params, module)` carries flax weights
over.
"""

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kronfluence_tpu_torch.examples.common import sample_labels
from kronfluence_tpu_torch.models.transformer import Block, TransformerConfig, init_flax_scales_
from kronfluence_tpu_torch.task import Task


def masked_mean_pool(x: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """The mean of `x` (b, t, d) over the positions the (b, t) mask keeps."""
    mask = attention_mask[:, :, None].to(x.dtype)
    return torch.sum(x * mask, dim=1) / torch.sum(mask, dim=1)


class EncoderClassifier(nn.Module):
    """Transformer trunk, mean pool over the mask and a classifier (a
    BERT-style workload); returns logits (b, num_classes)."""

    def __init__(self, config: TransformerConfig, num_classes: int = 2, device=None) -> None:
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=config.dtype)
        self.wte = nn.Embedding(config.vocab_size, config.d_model, **kw)
        self.wpe = nn.Embedding(config.max_seq_len, config.d_model, **kw)
        for i in range(config.num_layers):
            self.add_module(f"h_{i}", Block(config, device))
        self.ln_f = nn.LayerNorm(config.d_model, eps=1e-6, **kw)
        self.classifier = nn.Linear(config.d_model, num_classes, **kw)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = self.wte(input_ids) + self.wpe(pos)[None]
        for i in range(self.config.num_layers):
            x = getattr(self, f"h_{i}")(x, attention_mask)
        return self.classifier(masked_mean_pool(self.ln_f(x), attention_mask))


def margin_measurement(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Minus the summed margin: the correct logit less the logsumexp of the
    others (the correct one set to -inf)."""
    rows = torch.arange(logits.shape[0], device=logits.device)
    correct = logits[rows, labels]
    cloned = logits.clone()
    cloned[rows, labels] = float("-inf")
    return -torch.sum(correct - torch.logsumexp(cloned, dim=-1))


class TextClassificationTask(Task):
    """Summed cross-entropy (labels drawn from the model with `sample`, the
    true Fisher) on logits of at least fp32; the measurement is the margin."""

    def _logits(self, batch, model) -> torch.Tensor:
        logits = model(batch["input_ids"], batch["attention_mask"])
        return logits.to(torch.promote_types(logits.dtype, torch.float32))

    def compute_train_loss(self, batch, model, sample=False, generator=None):
        logits = self._logits(batch, model)
        labels = sample_labels(logits, generator) if sample else batch["label"].long()
        return F.cross_entropy(logits, labels, reduction="sum")

    def compute_measurement(self, batch, model):
        return margin_measurement(self._logits(batch, model), batch["label"].long())

    def get_attention_mask(self, batch):
        return batch["attention_mask"]


def synthetic_sst2(num: int, seq_len: int = 64, vocab: int = 4096, seed: int = 0
                   ) -> Dict[str, np.ndarray]:
    """SST-2-shaped rows: token ids in [2, vocab) zeroed past a length drawn
    in [8, seq_len], the mask, and a label that is 1 where the median kept
    token id is below vocab / 2 (a learnable signal). Every row keeps at
    least 8 tokens, so the mean pool never divides by 0."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, vocab, size=(num, seq_len)).astype(np.int32)
    lengths = rng.integers(8, seq_len + 1, size=num)
    mask = (np.arange(seq_len)[None] < lengths[:, None]).astype(np.int32)
    ids *= mask
    label = (np.median(np.where(mask, ids, vocab), axis=1) < vocab // 2).astype(np.int32)
    return {"input_ids": ids, "attention_mask": mask, "label": label}


def get_sst2_dataset(split: str, num: int, seq_len: int = 64, vocab: int = 4096,
                     seed: int = 0) -> Dict[str, np.ndarray]:
    """SST-2 as a column store {input_ids, attention_mask: (N, T) int32,
    label: (N,) int32}: synthetic; as in the JAX package, the split does not
    change the draw (the seed does)."""
    del split
    return synthetic_sst2(num, seq_len=seq_len, vocab=vocab, seed=seed)


def construct_classifier(seq_len: int = 64, vocab: int = 4096, num_layers: int = 2,
                         num_heads: int = 4, d_model: int = 128, seed: int = 0,
                         num_classes: int = 2, device=None
                         ) -> Tuple[EncoderClassifier, TextClassificationTask]:
    """The fp32 encoder classifier with its weights drawn from `seed` at
    flax's initializer scales, on `device` (the card unless the caller names
    another), and the task. Prepare the module with `prepare_model` to
    analyse it."""
    config = TransformerConfig(vocab_size=vocab, max_seq_len=seq_len, num_layers=num_layers,
                               num_heads=num_heads, d_model=d_model)
    device = torch.device("cuda" if device is None else device)
    module = EncoderClassifier(config, num_classes, device=device)
    with torch.no_grad():
        init_flax_scales_(module, torch.Generator(device).manual_seed(seed))
    return module, TextClassificationTask()
