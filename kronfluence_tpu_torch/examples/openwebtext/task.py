"""OpenWebText task: margin measurement and MLP-only tracking.

Port of `examples/openwebtext/task.py`: the summed token cross-entropy on
fp32 logits over the shifted mask (labels sampled from the model by
Gumbel-max with the stage's explicit generator when `sample`), the margin
measurement (the label's logit against the logsumexp of the others), and the
MLP projections of every layer as the tracked modules.
"""

import torch

from kronfluence_tpu_torch.examples.common import lm_loss
from kronfluence_tpu_torch.models.llama import mlp_tracked_modules
from kronfluence_tpu_torch.task import Task


class MLPOnlyLMTask(Task):
    """Margin-style measurement and MLP-only tracking over GPT-2 module paths."""

    def __init__(self, num_layers: int):
        self.num_layers = num_layers

    def compute_train_loss(self, batch, model, sample=False, generator=None):
        return lm_loss(batch, model, sample, generator)

    def compute_measurement(self, batch, model):
        logits = model(batch["input_ids"], batch["attention_mask"])[:, :-1].float()
        labels = batch["input_ids"][:, 1:].long()[..., None]
        mask = batch["attention_mask"][:, 1:].to(torch.float32)
        correct = logits.gather(-1, labels)[..., 0]
        others = logits.scatter(-1, labels, float("-inf"))
        return -torch.sum((correct - torch.logsumexp(others, dim=-1)) * mask)

    def get_influence_tracked_modules(self):
        names = []
        for i in range(self.num_layers):
            names += [f"h_{i}/mlp/c_fc", f"h_{i}/mlp/c_proj"]
        return names

    def get_attention_mask(self, batch):
        return batch["attention_mask"]


class LlamaMLPOnlyTask(MLPOnlyLMTask):
    """The same task over Llama module paths: gate, up and down of every layer."""

    def get_influence_tracked_modules(self):
        return mlp_tracked_modules(self.num_layers)
