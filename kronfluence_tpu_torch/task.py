"""Task abstraction: the user contract for loss and measurement computation.

Port of `kronfluence_tpu/task.py` on torch tensors. The model handle is the
`nn.Module` itself, losses are *summed* (not averaged) over the batch, and a
sampled-label (true Fisher) loss draws from the `torch.Generator` it is given.
"""

from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Union

import torch
from torch import nn


class Task(ABC):
    """Abstract base class for task definitions.

    Attributes:
        enable_post_process_per_sample_gradient (bool):
            Flag to enable post-processing of per-sample gradients.
    """

    enable_post_process_per_sample_gradient: bool = False

    @abstractmethod
    def compute_train_loss(
        self,
        batch: Any,
        model: nn.Module,
        sample: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Computes the *summed* training loss for a batch.

        Args:
            batch: A batch of data (dict of tensors on the model's device).
            model: The model; call it like its forward,
                e.g. `logits = model(batch["input_ids"])`.
            sample: If True, draw labels from the model's output distribution
                (true Fisher), from detached logits, with `generator`.
            generator: Generator on the model's device, given when `sample`.

        Returns:
            Scalar summed loss.
        """
        raise NotImplementedError

    @abstractmethod
    def compute_measurement(self, batch: Any, model: nn.Module) -> torch.Tensor:
        """Computes the scalar measurable quantity f(θ) for a batch (summed)."""
        raise NotImplementedError

    def get_influence_tracked_modules(self) -> Optional[List[str]]:
        """Returns module names to track, or None to track all supported."""
        return None

    def get_attention_mask(
        self, batch: Any
    ) -> Optional[Union[Dict[str, torch.Tensor], torch.Tensor]]:
        """Returns a binary (batch, seq) mask, a dict module-name -> mask, or None."""
        return None

    def post_process_per_sample_gradient(
        self, module_name: str, gradient: torch.Tensor
    ) -> torch.Tensor:
        """Post-processes a per-sample gradient of shape (batch, out_dim, in_dim[+1])."""
        del module_name
        return gradient
