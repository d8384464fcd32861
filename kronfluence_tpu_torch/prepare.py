"""Model preparation: port of `kronfluence_tpu/prepare.py`.

`prepare_model(module, task)` freezes the module's parameters, puts it in eval
mode (as the reference's `prepare_model` does) and wraps it with the tracked
module names. Every `nn.Linear` and `nn.Conv2d` is trackable; its name is the
torch qualified name with '/' for '.', e.g. `h_0/attn/c_attn` or
`res1/block_0/conv`.
"""

from typing import Any, Dict, Optional, Sequence, Union

import torch
from torch import nn

from kronfluence_tpu_torch.task import Task


class PreparedModel:
    """An analyzable model: the `nn.Module` plus its tracked-name filter."""

    def __init__(self, module: nn.Module, tracked_names: Optional[Sequence[str]] = None) -> None:
        self.module = module
        self.tracked_names = list(tracked_names) if tracked_names is not None else None

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    def tracked_modules(self) -> Dict[str, Union[nn.Linear, nn.Conv2d]]:
        """{flax-style name: module} for every tracked Linear and Conv2d."""
        tracked = set(self.tracked_names) if self.tracked_names is not None else None
        out = {}
        for qualified, sub in self.module.named_modules():
            if isinstance(sub, (nn.Linear, nn.Conv2d)):
                name = qualified.replace(".", "/")
                if tracked is None or name in tracked:
                    out[name] = sub
        return out


def prepare_model(model: Any, task: Optional[Task] = None) -> PreparedModel:
    """Prepares an `nn.Module` (or re-filters a PreparedModel) for analysis."""
    tracked = task.get_influence_tracked_modules() if task is not None else None
    if isinstance(model, PreparedModel):
        if tracked is not None:
            model.tracked_names = list(tracked)
        return model
    if isinstance(model, nn.Module):
        model.eval()
        model.requires_grad_(False)
        return PreparedModel(model, tracked_names=tracked)
    raise TypeError(f"Cannot prepare model of type {type(model)}: expected an nn.Module.")

