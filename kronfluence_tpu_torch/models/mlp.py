"""MLP test and example models. Port of `kronfluence_tpu/models/mlp.py`:
a plain ReLU MLP and a shared-parameter variant whose middle layer is applied
several times per forward (the reference's tests/testable_tasks/regression.py).

Module names are the flax paths (`layers_0`, `output`, `input_layer`,
`shared_layer`), so `models/convert.py:state_dict_from_flax` carries flax
params over. torch needs the input width that flax infers at init.
"""

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class MLP(nn.Module):
    """Simple ReLU MLP for regression/classification tasks."""

    def __init__(
        self, in_dim: int, hidden_dims: Sequence[int] = (32, 32), out_dim: int = 1,
        use_bias: bool = True, device=None, dtype=None,
    ) -> None:
        super().__init__()
        kw = dict(bias=use_bias, device=device, dtype=dtype)
        self.num_hidden = len(hidden_dims)
        width = in_dim
        for i, hidden in enumerate(hidden_dims):
            self.add_module(f"layers_{i}", nn.Linear(width, hidden, **kw))
            width = hidden
        self.output = nn.Linear(width, out_dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_hidden):
            x = F.relu(getattr(self, f"layers_{i}")(x))
        return self.output(x)


class RepeatedMLP(nn.Module):
    """MLP whose shared middle layer runs `num_repeats` times per forward:
    one tracked name with `num_repeats` uses a forward."""

    def __init__(
        self, in_dim: int, hidden_dim: int = 32, out_dim: int = 1, num_repeats: int = 3,
        device=None, dtype=None,
    ) -> None:
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_repeats = num_repeats
        self.input_layer = nn.Linear(in_dim, hidden_dim, **kw)
        self.shared_layer = nn.Linear(hidden_dim, hidden_dim, **kw)
        self.output = nn.Linear(hidden_dim, out_dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.input_layer(x))
        for _ in range(self.num_repeats):
            x = F.relu(self.shared_layer(x))
        return self.output(x)
