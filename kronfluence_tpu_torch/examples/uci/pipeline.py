"""UCI regression pipeline: dataset, MLP and task.

Port of `examples/uci/pipeline.py`. The data is a synthetic mirror of UCI
Concrete (8 features, 1 target, a nonlinear ground truth) made with numpy from
a seed, or the real Concrete CSV where `UCI_CONCRETE_CSV` names a local copy;
nothing is fetched.
"""

import os
from typing import Dict, Optional

import numpy as np
import torch

from kronfluence_tpu_torch.examples.common import model_inputs
from kronfluence_tpu_torch.models.mlp import MLP
from kronfluence_tpu_torch.models.resnet import init_vision
from kronfluence_tpu_torch.task import Task

CONCRETE_CSV = os.environ.get("UCI_CONCRETE_CSV", "")


class RegressionTask(Task):
    """Summed squared error; the sampled loss draws its targets around the
    detached predictions with `generator`'s standard normal noise. The
    measurement is the query batch's summed squared error."""

    def compute_train_loss(self, batch, model, sample=False, generator=None):
        preds = model(model_inputs(model, batch["x"]))
        if not sample:
            return torch.sum((preds - batch["y"]) ** 2)
        noise = torch.randn(preds.shape, generator=generator, dtype=preds.dtype,
                            device=preds.device)
        return torch.sum((preds - (preds.detach() + noise)) ** 2)

    def compute_measurement(self, batch, model):
        return torch.sum((model(model_inputs(model, batch["x"])) - batch["y"]) ** 2)


def synthetic_concrete(num: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """8 features -> 1 target with a nonlinear ground truth, like UCI Concrete."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(num, 8)).astype(np.float32)
    w = rng.normal(size=(8,))
    y = np.tanh(x @ w) + 0.5 * (x[:, 0] * x[:, 1]) + 0.1 * rng.normal(size=num)
    return {"x": x, "y": y[:, None].astype(np.float32)}


def _load_concrete_csv(path: str) -> Dict[str, np.ndarray]:
    raw = np.genfromtxt(path, delimiter=",", skip_header=1).astype(np.float32)
    x, y = raw[:, :-1], raw[:, -1:]
    mean, std = x.mean(axis=0), x.std(axis=0) + 1e-8
    return {"x": (x - mean) / std, "y": (y - y.mean()) / (y.std() + 1e-8)}


def get_regression_dataset(
    split: str,
    num: Optional[int] = None,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """A column store for `split` in {'train', 'eval'}: the first 90% of the
    Concrete CSV's rows (train) or the rest when `UCI_CONCRETE_CSV` names
    one, synthetic data otherwise (512 train or 64 eval rows by default)."""
    if CONCRETE_CSV and os.path.exists(CONCRETE_CSV):
        data = _load_concrete_csv(CONCRETE_CSV)
        n = len(data["x"])
        cut = int(0.9 * n)
        sl = slice(0, cut) if split == "train" else slice(cut, n)
        data = {k: v[sl] for k, v in data.items()}
        if num is not None:
            data = {k: v[:num] for k, v in data.items()}
        return data
    base_seed = 0 if split == "train" else 1
    return synthetic_concrete(num or (512 if split == "train" else 64), seed=seed + base_seed)


def construct_regression_mlp(seed: int = 0, device=None) -> MLP:
    """The 8 -> 64 -> 64 -> 1 ReLU MLP, its weights drawn from `seed` (normal
    with std 1/sqrt(fan_in), zero biases), on `device` (the card unless the
    caller names another)."""
    return init_vision(MLP(8, hidden_dims=(64, 64), out_dim=1), seed=seed, device=device)
