"""CNN/DailyMail pipeline: seq2seq data, encoder-decoder model and task.

Port of `examples/dailymail/pipeline.py`. The data is synthetic padded
article / summary pairs made with numpy from a seed; nothing is fetched (the
JAX example's `real=True`, a locally cached dataset and the T5 tokenizer, is
not ported). The model is `models/encoder_decoder.py:EncDecLM`, whose module
names are the flax paths.
"""

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from kronfluence_tpu_torch.examples.common import sample_labels
from kronfluence_tpu_torch.models.encoder_decoder import EncDecConfig, EncDecLM, init_encdec
from kronfluence_tpu_torch.task import Task

ENCODER_MODULES = ("attn/q", "attn/k", "attn/v", "attn/o", "mlp/wi", "mlp/wo")
# A decoder layer's modules that read the decoder stream; its cross-attention
# keys and values read the encoder's.
DECODER_MODULES = ("self_attn/q", "self_attn/k", "self_attn/v", "self_attn/o",
                   "cross_attn/q", "cross_attn/o", "mlp/wi", "mlp/wo")
CROSS_KV_MODULES = ("cross_attn/k", "cross_attn/v")


class SummarizationTask(Task):
    """Summed cross-entropy over the masked decoder positions on fp32 logits,
    as the JAX task casts them (labels drawn from the model with `sample`,
    the true Fisher); the measurement is the same loss. Dict attention
    masks: encoder modules take the article mask, decoder modules the
    summary mask, the cross-attention's keys and values the article mask."""

    def __init__(self, num_layers: int):
        self.num_layers = num_layers

    def compute_train_loss(self, batch, model, sample=False, generator=None):
        logits = model(batch["input_ids"], batch["decoder_input_ids"],
                       batch["attention_mask"], batch["decoder_attention_mask"])[:, :-1].float()
        mask = batch["decoder_attention_mask"][:, 1:].to(torch.float32)
        if sample:
            labels = sample_labels(logits, generator)
        else:
            labels = batch["decoder_input_ids"][:, 1:].long()
        losses = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                                 reduction="none").reshape(mask.shape)
        return torch.sum(losses * mask)

    def compute_measurement(self, batch, model):
        return self.compute_train_loss(batch, model)

    def _streams(self):
        """(module name, "enc" or "dec") for every tracked module."""
        for i in range(self.num_layers):
            yield from ((f"encoder_{i}/{sub}", "enc") for sub in ENCODER_MODULES)
            yield from ((f"decoder_{i}/{sub}", "dec") for sub in DECODER_MODULES)
            yield from ((f"decoder_{i}/{sub}", "enc") for sub in CROSS_KV_MODULES)
        yield "lm_head", "dec"

    def get_attention_mask(self, batch):
        masks = {"enc": batch["attention_mask"], "dec": batch["decoder_attention_mask"]}
        return {name: masks[stream] for name, stream in self._streams()}


def synthetic_pairs(num: int, seq_len: int = 32, vocab: int = 1024, seed: int = 0
                    ) -> Dict[str, np.ndarray]:
    """Article / summary pairs shaped like tokenized cnn_dailymail: ids in
    [1, vocab) zeroed past a length drawn in [seq_len / 2, seq_len] (articles)
    or [seq_len / 4, seq_len] (summaries), and their masks."""
    rng = np.random.default_rng(seed)
    enc_ids = rng.integers(1, vocab, size=(num, seq_len)).astype(np.int32)
    dec_ids = rng.integers(1, vocab, size=(num, seq_len)).astype(np.int32)
    enc_len = rng.integers(seq_len // 2, seq_len + 1, size=num)
    dec_len = rng.integers(seq_len // 4, seq_len + 1, size=num)
    enc_mask = (np.arange(seq_len)[None] < enc_len[:, None]).astype(np.int32)
    dec_mask = (np.arange(seq_len)[None] < dec_len[:, None]).astype(np.int32)
    return {
        "input_ids": enc_ids * enc_mask,
        "decoder_input_ids": dec_ids * dec_mask,
        "attention_mask": enc_mask,
        "decoder_attention_mask": dec_mask,
    }


def get_dailymail_dataset(split: str, num: int, enc_len: int = 32, dec_len: int = 32,
                          vocab: int = 1024, seed: int = 0) -> Dict[str, np.ndarray]:
    """cnn_dailymail as a column store {input_ids, decoder_input_ids,
    attention_mask, decoder_attention_mask: (N, T) int32}: synthetic, both
    sides `enc_len` tokens (as in the JAX package, `dec_len` and the split
    do not change the draw; the seed does)."""
    del split, dec_len
    return synthetic_pairs(num, seq_len=enc_len, vocab=vocab, seed=seed)


def construct_seq2seq(seq_len: int = 32, vocab: int = 1024, num_layers: int = 2,
                      num_heads: int = 4, d_model: int = 128, seed: int = 0, device=None
                      ) -> Tuple[EncDecLM, SummarizationTask]:
    """The fp32 encoder-decoder LM with its weights drawn from `seed` at
    flax's initializer scales (`init_encdec`), on `device` (the card unless
    the caller names another), and the task. Prepare the module with
    `prepare_model` to analyse it."""
    config = EncDecConfig(vocab_size=vocab, max_seq_len=seq_len, num_layers=num_layers,
                          num_heads=num_heads, d_model=d_model)
    return init_encdec(config, seed=seed, device=device), SummarizationTask(num_layers)
