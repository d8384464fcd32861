"""Torch twin of classification.py for the port's conv parity tests.

The same summed cross-entropy and margin measurement, on the port's NCHW
vision models, with weights (and BatchNorm statistics) converted from the
flax model by `kronfluence_tpu_torch.models.convert.state_dict_from_flax`,
so both packages see the same model and the same data.
"""

import jax
import numpy as np
import torch
import torch.nn.functional as F

from kronfluence_tpu_torch.models.convert import state_dict_from_flax
from kronfluence_tpu_torch.task import Task


class TorchClassificationTask(Task):
    def __init__(self, tracked=None):
        self.tracked = tracked

    def compute_train_loss(self, batch, model, sample=False, generator=None):
        logits = model(batch["x"])
        if sample:
            probs = torch.softmax(logits.detach(), dim=-1)
            labels = torch.multinomial(probs, 1, generator=generator).squeeze(-1)
        else:
            labels = batch["y"].long()
        return F.cross_entropy(logits, labels, reduction="sum")

    def compute_measurement(self, batch, model):
        # Margin: the correct-class logit minus logsumexp of the rest.
        logits = model(batch["x"])
        labels = batch["y"].long()
        rows = torch.arange(logits.shape[0], device=logits.device)
        correct = logits[rows, labels]
        others = logits.index_put(
            (rows, labels), torch.full((), float("-inf"), dtype=logits.dtype, device=logits.device)
        )
        return -torch.sum(correct - torch.logsumexp(others, dim=-1))

    def get_influence_tracked_modules(self):
        return self.tracked


def nchw(data: dict) -> dict:
    """The torch side of a classification dataset: NHWC images as NCHW."""
    return {"x": np.ascontiguousarray(data["x"].transpose(0, 3, 1, 2)), "y": data["y"]}


def load_flax(module: torch.nn.Module, variables) -> torch.nn.Module:
    """`module` holding the flax variables (params, and batch_stats if any)."""
    host = jax.tree_util.tree_map(np.asarray, variables)
    module.load_state_dict(state_dict_from_flax(host, module))
    return module


def fp64_variables(flax_module, size: int, seed: int, stats: bool = True):
    """A flax vision module's variables as fp64 numpy, from `init` at a
    (1, size, size, 3) input; with `stats` every BatchNorm's scale, bias,
    running mean and running variance and every Dense bias drawn from a
    numpy seed (init leaves them 1, 0, 0, 1 and 0)."""
    variables = jax.device_get(flax_module.init(jax.random.PRNGKey(seed),
                                                np.zeros((1, size, size, 3))))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        leaf = np.asarray(leaf, np.float64)
        name = str(path[-1].key)
        if not stats or leaf.ndim != 1 or name not in ("scale", "bias", "mean", "var"):
            return leaf
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape)
        return (name == "scale") + 0.1 * rng.standard_normal(leaf.shape)

    return jax.tree_util.tree_map_with_path(draw, variables)
