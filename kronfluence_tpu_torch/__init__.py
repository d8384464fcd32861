"""kronfluence_tpu_torch: the PyTorch / CUDA port of kronfluence_tpu.

Influence functions with (EK-)FAC curvature on one NVIDIA H100. Module paths
mirror the JAX package's (`factor/covariance.py` <-> `factor/covariance.py`).
The port imports torch and numpy, never jax; its hand-written Hopper kernels
live in `csrc/` and are built with nvcc at first use (`ops/kernels/`), never
when the package is imported.
"""

from kronfluence_tpu_torch import nn
from kronfluence_tpu_torch.analyzer import Analyzer
from kronfluence_tpu_torch.arguments import FactorArguments, ScoreArguments
from kronfluence_tpu_torch.prepare import FunctionalModel, prepare_model
from kronfluence_tpu_torch.task import Task
from kronfluence_tpu_torch.version import __version__

__all__ = [
    "Analyzer",
    "FunctionalModel",
    "nn",
    "prepare_model",
    "FactorArguments",
    "ScoreArguments",
    "Task",
    "__version__",
]
