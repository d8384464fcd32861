"""Torch twin of regression.py for the port's parity tests: the same
sum-MSE loss and summed-prediction measurement, and the port's MLP and
RepeatedMLP holding the flax weights (models/convert.py)."""

import numpy as np
import torch

from kronfluence_tpu_torch.models.convert import state_dict_from_flax
from kronfluence_tpu_torch.models.mlp import MLP, RepeatedMLP
from kronfluence_tpu_torch.task import Task


class TorchRegressionTask(Task):
    def __init__(self, tracked=None):
        self.tracked = tracked

    def compute_train_loss(self, batch, model, sample=False, generator=None):
        preds = model(batch["x"])
        if not sample:
            return torch.sum((preds - batch["y"]) ** 2)
        noise = torch.randn(preds.shape, generator=generator, dtype=preds.dtype,
                            device=preds.device)
        return torch.sum((preds - (preds.detach() + noise)) ** 2)

    def compute_measurement(self, batch, model):
        return torch.sum(model(batch["x"]))

    def get_influence_tracked_modules(self):
        return self.tracked


def torch_mlp(params, in_dim: int = 8, out_dim: int = 1, shared: bool = False,
              dtype=torch.float64) -> torch.nn.Module:
    """The port's twin of regression.py:make_mlp's module, holding `params`."""
    module = (RepeatedMLP(in_dim, hidden_dim=16, out_dim=out_dim, dtype=dtype) if shared
              else MLP(in_dim, hidden_dims=(16, 12), out_dim=out_dim, dtype=dtype))
    import jax  # here, so that torch-only processes can import the task above

    host = jax.tree_util.tree_map(np.asarray, params)
    module.load_state_dict(state_dict_from_flax(host, module))
    return module
