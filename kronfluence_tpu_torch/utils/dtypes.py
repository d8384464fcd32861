"""dtype plumbing: user-facing dtype specs are strings or torch dtypes.

Port of `kronfluence_tpu/utils/dtypes.py`. Strings ("float32", "bfloat16",
reference-style "torch.float32", ...), numpy dtypes and torch dtypes are
accepted everywhere and normalized to a canonical name for JSON round trips.
"""

from typing import Any, Optional

import numpy as np
import torch

_CANONICAL = {
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
    "int32": torch.int32,
    "int64": torch.int64,
}

_ALIASES = {
    "torch.float16": "float16",
    "torch.bfloat16": "bfloat16",
    "torch.float32": "float32",
    "torch.float64": "float64",
    "torch.int32": "int32",
    "torch.int64": "int64",
    "half": "float16",
    "float": "float32",
    "double": "float64",
}

_TORCH_NAMES = {dtype: name for name, dtype in _CANONICAL.items()}


def canonical_dtype_name(dtype: Any) -> Optional[str]:
    """Normalizes a dtype spec to a canonical string name (or None)."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        name = _TORCH_NAMES.get(dtype)
    elif isinstance(dtype, str):
        name = _ALIASES.get(dtype, dtype)
    else:
        name = np.dtype(dtype).name
    if name not in _CANONICAL:
        raise ValueError(f"Unsupported dtype spec: {dtype!r}")
    return name


def resolve_dtype(dtype: Any) -> Optional[torch.dtype]:
    """Resolves a dtype spec to a torch dtype (or None)."""
    name = canonical_dtype_name(dtype)
    return None if name is None else _CANONICAL[name]


def accumulation_dtype(dtype: Any) -> Optional[torch.dtype]:
    """Running-sum dtype for a per-batch compute dtype: bf16 and fp16 inputs
    accumulate into float32, wider types into themselves."""
    d = resolve_dtype(dtype)
    if d in (torch.bfloat16, torch.float16):
        return torch.float32
    return d
