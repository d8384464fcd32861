"""Model preparation: port of `kronfluence_tpu/prepare.py`.

`prepare_model(module, task)` freezes the module's parameters, puts it in eval
mode (as the reference's `prepare_model` does) and wraps it with the tracked
module names. Two model forms, as in the JAX package:

  * an `nn.Module`: every `nn.Linear`, `nn.Conv2d` and HF GPT-2 `Conv1D` is
    trackable; its name is the torch qualified name with '/' for '.', e.g.
    `h_0/attn/c_attn` or `res1/block_0/conv`;
  * a plain function `apply_fn(params, *args, **kwargs)` that routes its
    layers through the tagged ops of `kronfluence_tpu_torch.nn`, bound to
    its nested dict of tensors by `FunctionalModel(apply_fn, params)`; its
    tracked names are the ones its ops tap (`name=`, under `scan_layers`'
    scopes).

Both may mix: a module's forward may call tagged ops beside its hooked
layers. The task's `get_influence_tracked_modules` filters both.
"""

from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from kronfluence_tpu_torch.capture.context import is_trackable
from kronfluence_tpu_torch.task import Task


class _ParamTree(nn.Module):
    """A nested dict of tensors as a module tree: floating tensors become
    frozen parameters, others buffers, dicts child modules."""

    def __init__(self, tree: Mapping[str, Any]) -> None:
        super().__init__()
        for key, value in tree.items():
            if not isinstance(key, str) or not key or "." in key:
                raise ValueError(f"Parameter key {key!r} must be a non-empty str without '.'.")
            if isinstance(value, Mapping):
                self.add_module(key, _ParamTree(value))
            elif not isinstance(value, torch.Tensor):
                raise TypeError(f"{key!r}: expected a tensor or a dict, got {type(value)}.")
            elif value.is_floating_point() or value.is_complex():
                self.register_parameter(key, nn.Parameter(value, requires_grad=False))
            else:
                self.register_buffer(key, value)

    def tree(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self.named_parameters(recurse=False))
        out.update(self.named_buffers(recurse=False))
        out.update((name, child.tree()) for name, child in self.named_children())
        return out


class FunctionalModel(nn.Module):
    """A plain function `apply_fn(params, *args, **kwargs)` bound to its
    nested dict of tensors as an `nn.Module`: `module(*args)` calls
    `apply_fn(params, *args)`. The tensors are the module's parameters (and
    buffers, for non-floating ones), so `.to(device)`, `state_dict()` and the
    stages' dtype casts act on them; the dict handed to `apply_fn` is
    rebuilt from them at every call."""

    def __init__(self, apply_fn: Callable[..., Any], params: Mapping[str, Any]) -> None:
        super().__init__()
        self.apply_fn = apply_fn
        self.params = _ParamTree(params)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        return self.apply_fn(self.params.tree(), *args, **kwargs)


class PreparedModel:
    """An analyzable model: the `nn.Module` plus its tracked-name filter."""

    def __init__(self, module: nn.Module, tracked_names: Optional[Sequence[str]] = None) -> None:
        self.module = module
        self.tracked_names = list(tracked_names) if tracked_names is not None else None

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    def tracked_modules(self) -> Dict[str, nn.Module]:
        """{flax-style name: module} for every tracked module (Linear,
        Conv2d, HF Conv1D). Tagged functional ops are named at their call and
        filtered by `tracked_names` there (capture/context.py)."""
        tracked = set(self.tracked_names) if self.tracked_names is not None else None
        out = {}
        for qualified, sub in self.module.named_modules():
            if is_trackable(sub):
                name = qualified.replace(".", "/")
                if tracked is None or name in tracked:
                    out[name] = sub
        return out


def prepare_model(model: Any, task: Optional[Task] = None) -> PreparedModel:
    """Prepares an `nn.Module` (a `FunctionalModel` among them), or
    re-filters a PreparedModel, for analysis."""
    tracked = task.get_influence_tracked_modules() if task is not None else None
    if isinstance(model, PreparedModel):
        if tracked is not None:
            model.tracked_names = list(tracked)
        return model
    if isinstance(model, nn.Module):
        model.eval()
        model.requires_grad_(False)
        return PreparedModel(model, tracked_names=tracked)
    hint = (
        " Bind a plain apply function to its parameters first: "
        "`prepare_model(FunctionalModel(apply_fn, params), task)`."
        if callable(model) else ""
    )
    raise TypeError(f"Cannot prepare model of type {type(model)}: expected an nn.Module.{hint}")
