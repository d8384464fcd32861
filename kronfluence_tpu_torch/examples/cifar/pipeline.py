"""CIFAR-10 pipeline: data, ResNet-9 and the classification task.

Port of `examples/cifar/pipeline.py`. The data is synthetic images with
class-dependent means (learnable, CIFAR-10's shapes), made with numpy from a
seed in the JAX package's NHWC order and handed to the model as NCHW; nothing
is fetched (the JAX example's `real=True`, a locally cached dataset, is not
ported).
"""

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from kronfluence_tpu_torch.examples.common import model_inputs, sample_labels
from kronfluence_tpu_torch.models.resnet import ResNet9, init_vision
from kronfluence_tpu_torch.prepare import prepare_model
from kronfluence_tpu_torch.task import Task


class ClassificationTask(Task):
    """Summed cross-entropy (labels drawn from the model with `sample`, the
    true Fisher) on logits of at least fp32; the measurement is the margin:
    minus the sum of the correct logit less the logsumexp of the others."""

    def _logits(self, batch, model) -> torch.Tensor:
        logits = model(model_inputs(model, batch["x"]))
        return logits.to(torch.promote_types(logits.dtype, torch.float32))

    def compute_train_loss(self, batch, model, sample=False, generator=None):
        logits = self._logits(batch, model)
        labels = sample_labels(logits, generator) if sample else batch["y"].long()
        return F.cross_entropy(logits, labels, reduction="sum")

    def compute_measurement(self, batch, model):
        logits = self._logits(batch, model)
        labels = batch["y"].long()
        rows = torch.arange(logits.shape[0], device=logits.device)
        correct = logits[rows, labels]
        cloned = logits.clone()
        cloned[rows, labels] = float("-inf")
        return -torch.sum(correct - torch.logsumexp(cloned, dim=-1))


def synthetic_cifar(
    num: int, corrupt_frac: float = 0.0, seed: int = 0
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Learnable synthetic CIFAR-shaped data, NCHW fp32 images and int64
    labels; a `corrupt_frac` share of the labels moved to another class, and
    their indices. Drawn in the JAX package's NHWC order, then transposed."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=num)
    means = rng.normal(size=(10, 1, 1, 3))
    x = 0.5 * rng.normal(size=(num, 32, 32, 3)) + means[labels]
    y = labels.copy()
    corrupt_idx = np.array([], dtype=np.int64)
    if corrupt_frac > 0:
        num_corrupt = int(num * corrupt_frac)
        corrupt_idx = rng.choice(num, num_corrupt, replace=False)
        y[corrupt_idx] = (y[corrupt_idx] + rng.integers(1, 10, num_corrupt)) % 10
    x = np.ascontiguousarray(x.astype(np.float32).transpose(0, 3, 1, 2))
    return {"x": x, "y": y}, corrupt_idx


def get_cifar10_dataset(
    split: str, num: Optional[int] = None, corrupt_frac: float = 0.0, seed: int = 0,
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """CIFAR-10 as a column store {x: (N, 3, 32, 32) fp32, y: (N,) int64} and
    the corrupted labels' indices: synthetic, 1024 examples by default. As in
    the JAX package, the split does not change the synthetic draw."""
    del split
    return synthetic_cifar(num or 1024, corrupt_frac, seed)


def construct_resnet9(num_classes: int = 10, seed: int = 0, device=None) -> ResNet9:
    """ResNet-9 with its weights and BatchNorm statistics drawn from `seed`
    (`models/resnet.py:init_vision`), on `device` (the card unless the caller
    names another)."""
    return init_vision(ResNet9(num_classes=num_classes), seed=seed, device=device)


def train_resnet9(
    train_data: Dict[str, np.ndarray],
    epochs: int = 10,
    batch_size: int = 64,
    learning_rate: float = 1e-3,
    weight_decay: float = 1e-4,
    seed: int = 0,
    verbose: bool = True,
    device=None,
):
    """AdamW on the mean cross-entropy, BatchNorm in training mode (batch
    statistics, running statistics updated as flax updates them); returns
    the trained module, back in eval mode and prepared, and the task."""
    module = construct_resnet9(seed=seed, device=device)
    task = ClassificationTask()
    device = next(module.parameters()).device
    optimizer = torch.optim.AdamW(module.parameters(), lr=learning_rate,
                                  weight_decay=weight_decay)
    rng = np.random.default_rng(seed)
    num = len(train_data["y"])
    module.train()
    t0 = time.time()
    for epoch in range(epochs):
        order = rng.permutation(num)
        losses = []
        for start in range(0, num - batch_size + 1, batch_size):
            idx = order[start : start + batch_size]
            x = model_inputs(module, torch.as_tensor(train_data["x"][idx], device=device))
            y = torch.as_tensor(train_data["y"][idx], device=device).long()
            optimizer.zero_grad(set_to_none=True)
            loss = F.cross_entropy(module(x), y)
            loss.backward()
            optimizer.step()
            losses.append(float(loss.detach()))
        if verbose:
            print(f"epoch {epoch}: loss {np.mean(losses) if losses else float('nan'):.4f} "
                  f"({time.time() - t0:.1f}s)")
    module.zero_grad(set_to_none=True)
    # prepare_model puts the module back in eval mode: every stage normalises
    # with the running statistics and leaves them as they are.
    return module, prepare_model(module, task), task
