"""Torch twin of language_modeling.py for the port's parity tests.

The same summed next-token cross-entropy under the attention mask, on the
port's TransformerLM, with weights converted from the flax model by
`kronfluence_tpu_torch.models.convert.state_dict_from_flax`, so both
packages see the same model and the same data.
"""

import numpy as np
import torch
import torch.nn.functional as F

from kronfluence_tpu_torch.models.convert import state_dict_from_flax
from kronfluence_tpu_torch.models.transformer import TransformerLM, tiny_config
from kronfluence_tpu_torch.prepare import prepare_model
from kronfluence_tpu_torch.task import Task


class TorchLanguageModelingTask(Task):
    def compute_train_loss(self, batch, model, sample=False, generator=None):
        logits = model(batch["input_ids"], batch["attention_mask"])[:, :-1]
        mask = batch["attention_mask"][:, 1:].to(logits.dtype)
        vocab = logits.shape[-1]
        if sample:
            probs = torch.softmax(logits.detach().reshape(-1, vocab), dim=-1)
            labels = torch.multinomial(probs, 1, generator=generator).reshape(mask.shape)
        else:
            labels = batch["input_ids"][:, 1:].long()
        losses = F.cross_entropy(
            logits.reshape(-1, vocab), labels.reshape(-1), reduction="none"
        ).reshape(mask.shape)
        return torch.sum(losses * mask)

    def compute_measurement(self, batch, model):
        return self.compute_train_loss(batch, model, sample=False)

    def get_attention_mask(self, batch):
        return batch["attention_mask"]


class TorchMLPOnlyLanguageModelingTask(TorchLanguageModelingTask):
    def __init__(self, num_layers: int):
        self.num_layers = num_layers

    def get_influence_tracked_modules(self):
        names = []
        for i in range(self.num_layers):
            names.append(f"h_{i}/mlp/c_fc")
            names.append(f"h_{i}/mlp/c_proj")
        return names


def torch_config_like(jax_config, dtype=torch.float64, attention="naive"):
    """The port's TransformerConfig with the flax config's sizes."""
    return tiny_config(
        vocab_size=jax_config.vocab_size,
        max_seq_len=jax_config.max_seq_len,
        num_layers=jax_config.num_layers,
        num_heads=jax_config.num_heads,
        d_model=jax_config.d_model,
        d_mlp=jax_config.d_mlp,
        dtype=dtype,
        attention=attention,
    )


def make_torch_lm(jax_params, jax_config, dtype=torch.float64, mlp_only=False, attention="naive"):
    """(PreparedModel, task, config) of the port holding the flax weights."""
    import jax  # here, so that torch-only processes can import the tasks above

    config = torch_config_like(jax_config, dtype, attention)
    module = TransformerLM(config)
    host_params = jax.tree_util.tree_map(np.asarray, jax_params)
    module.load_state_dict(state_dict_from_flax(host_params, config))
    task = (
        TorchMLPOnlyLanguageModelingTask(config.num_layers)
        if mlp_only
        else TorchLanguageModelingTask()
    )
    return prepare_model(module, task), task, config
