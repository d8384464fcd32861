"""ImageNet pipeline: data, ResNet-50 and the classification task.

Port of `examples/imagenet/pipeline.py`. The data is synthetic standard-normal
images made with numpy from a seed in the JAX package's NHWC order and handed
to the model as NCHW; nothing is fetched (the JAX example's `real=True`, a
locally cached dataset, is not ported). The task is CIFAR's
(`examples/cifar/pipeline.py:ClassificationTask`): summed cross-entropy and
the margin measurement, the same code in the JAX package's two pipelines.
"""

from typing import Dict

import numpy as np

from kronfluence_tpu_torch.examples.cifar.pipeline import ClassificationTask
from kronfluence_tpu_torch.models.resnet import ResNet9, init_vision, resnet50
from kronfluence_tpu_torch.prepare import prepare_model

__all__ = ["ClassificationTask", "construct_resnet", "get_imagenet_dataset", "synthetic_imagenet"]


def synthetic_imagenet(num: int, size: int, classes: int = 1000, seed: int = 0
                       ) -> Dict[str, np.ndarray]:
    """`num` standard-normal (3, size, size) fp32 images and int64 labels in
    [0, classes), drawn in NHWC order, then transposed."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(num, size, size, 3)).astype(np.float32)
    return {
        "x": np.ascontiguousarray(x.transpose(0, 3, 1, 2)),
        "y": rng.integers(0, classes, size=num),
    }


def get_imagenet_dataset(split: str, num: int, size: int = 64, classes: int = 1000,
                         seed: int = 0) -> Dict[str, np.ndarray]:
    """ImageNet as a column store: synthetic; as in the JAX package, the
    split does not change the draw (the seed does)."""
    del split
    return synthetic_imagenet(num, size, classes, seed)


def construct_resnet(arch: str = "resnet50", num_classes: int = 1000, seed: int = 0,
                     device=None):
    """The ResNet classifier (`resnet9` is the CI smoke-test size) with its
    weights and BatchNorm statistics drawn from `seed` (`init_vision`: the
    init's zero `bn3` scale would zero every residual branch's gradients),
    on `device`; returns the prepared model and the task."""
    module = ResNet9(num_classes=num_classes) if arch == "resnet9" else resnet50(num_classes)
    task = ClassificationTask()
    return prepare_model(init_vision(module, seed=seed, device=device), task), task
