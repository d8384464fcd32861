"""SWAG multiple-choice pipeline: data, choice-scoring model and task.

Port of `examples/swag/pipeline.py`. The data is synthetic (context, 4
endings) token tensors made with numpy from a seed; nothing is fetched (the
JAX example's `real=True`, a locally cached dataset and tokenizer, is not
ported).

The workload's signature: the encoder runs 4 times an example (the choices
folded into the batch), so a module's per-sample gradients come in 4 rows an
example, and `MultipleChoiceTask.post_process_per_sample_gradient` sums them
back to one; and query batching with low-rank query gradients. A loader
batch holds whole examples, so a batch of b examples is 4b rows a module.
"""

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kronfluence_tpu_torch.examples.common import sample_labels
from kronfluence_tpu_torch.examples.glue.pipeline import margin_measurement, masked_mean_pool
from kronfluence_tpu_torch.models.transformer import Block, TransformerConfig, init_flax_scales_
from kronfluence_tpu_torch.task import Task

NUM_CHOICES = 4


class ChoiceScorer(nn.Module):
    """Scores each (context, ending) pair with a shared encoder: input_ids and
    attention_mask (b, choices, t), folded to (b * choices, t), the GPT-2
    block stack, a mean pool over the mask and a one-unit `scorer`; returns
    (b, choices) logits."""

    def __init__(self, config: TransformerConfig, device=None) -> None:
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=config.dtype)
        self.wte = nn.Embedding(config.vocab_size, config.d_model, **kw)
        self.wpe = nn.Embedding(config.max_seq_len, config.d_model, **kw)
        for i in range(config.num_layers):
            self.add_module(f"h_{i}", Block(config, device))
        self.ln_f = nn.LayerNorm(config.d_model, eps=1e-6, **kw)
        self.scorer = nn.Linear(config.d_model, 1, **kw)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        b, c, t = input_ids.shape
        ids = input_ids.reshape(b * c, t)
        mask = attention_mask.reshape(b * c, t)
        pos = torch.arange(t, device=ids.device)
        x = self.wte(ids) + self.wpe(pos)[None]
        for i in range(self.config.num_layers):
            x = getattr(self, f"h_{i}")(x, mask)
        return self.scorer(masked_mean_pool(self.ln_f(x), mask)).reshape(b, c)


class MultipleChoiceTask(Task):
    """Summed cross-entropy over the choices (labels drawn from the model
    with `sample`, the true Fisher) on logits of at least fp32; the
    measurement is the margin. Per-sample gradients come NUM_CHOICES rows an
    example and are summed back to one an example."""

    enable_post_process_per_sample_gradient = True

    def post_process_per_sample_gradient(self, module_name, gradient):
        del module_name
        return gradient.reshape(gradient.shape[0] // NUM_CHOICES, NUM_CHOICES,
                                *gradient.shape[1:]).sum(dim=1)

    def _logits(self, batch, model) -> torch.Tensor:
        logits = model(batch["input_ids"], batch["attention_mask"])
        return logits.to(torch.promote_types(logits.dtype, torch.float32))

    def compute_train_loss(self, batch, model, sample=False, generator=None):
        logits = self._logits(batch, model)
        labels = sample_labels(logits, generator) if sample else batch["label"].long()
        return F.cross_entropy(logits, labels, reduction="sum")

    def compute_measurement(self, batch, model):
        return margin_measurement(self._logits(batch, model), batch["label"].long())


def synthetic_swag(num: int, num_choices: int = NUM_CHOICES, seq_len: int = 32,
                   vocab: int = 2048, seed: int = 0) -> Dict[str, np.ndarray]:
    """`num` examples of `num_choices` unpadded sequences of token ids in
    [1, vocab), and a label in [0, num_choices)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, size=(num, num_choices, seq_len)).astype(np.int32)
    mask = np.ones((num, num_choices, seq_len), dtype=np.int32)
    label = rng.integers(0, num_choices, size=num).astype(np.int32)
    return {"input_ids": ids, "attention_mask": mask, "label": label}


def get_swag_dataset(split: str, num: int, seq_len: int = 32, vocab: int = 2048,
                     seed: int = 0) -> Dict[str, np.ndarray]:
    """SWAG as a column store {input_ids, attention_mask: (N, 4, T) int32,
    label: (N,) int32}: synthetic; as in the JAX package, the split does not
    change the draw (the seed does)."""
    del split
    return synthetic_swag(num, seq_len=seq_len, vocab=vocab, seed=seed)


def construct_choice_model(seq_len: int = 32, vocab: int = 2048, num_layers: int = 2,
                           num_heads: int = 4, d_model: int = 128, seed: int = 0, device=None
                           ) -> Tuple[ChoiceScorer, MultipleChoiceTask]:
    """The fp32 choice scorer with its weights drawn from `seed` at flax's
    initializer scales, on `device` (the card unless the caller names
    another), and the task. Prepare the module with `prepare_model` to
    analyse it."""
    config = TransformerConfig(vocab_size=vocab, max_seq_len=seq_len, num_layers=num_layers,
                               num_heads=num_heads, d_model=d_model)
    device = torch.device("cuda" if device is None else device)
    module = ChoiceScorer(config, device=device)
    with torch.no_grad():
        init_flax_scales_(module, torch.Generator(device).manual_seed(seed))
    return module, MultipleChoiceTask()
