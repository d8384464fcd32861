"""Scaled low-precision storage for preconditioned query gradients.

Port of `kronfluence_tpu/ops/quantize.py`. The pairwise stage keeps one block
of preconditioned query gradients resident for a whole pass over the train
loader; storing it in float8 with one fp32 scale per query halves its bytes
against bf16, so about twice the queries fit in a block and the train pass
runs about half as often. Compute stays in the score dtypes: a block is
dequantized one module at a time, right before its contraction.

Plain torch ops, no kernel (XLA ops in the JAX package). The payload is
bit-identical to the JAX package's on the same input.
"""

from typing import Any, Sequence

import numpy as np
import torch

from kronfluence_tpu_torch.utils.dtypes import resolve_dtype

# Per-format (clip bound, scale target): values are scaled so each query's
# max-abs lands at `target`, then clipped to the finite max before the cast.
# For the fp8 formats the target is the finite max; for bf16 / fp16 it sits
# well inside the range (a scale of amax / 3.4e38 would underflow fp32).
_FORMAT = {
    torch.float8_e4m3fn: (448.0, 448.0),
    torch.float8_e5m2: (57344.0, 57344.0),
    torch.bfloat16: (float(torch.finfo(torch.bfloat16).max), 1.0),
    torch.float16: (float(torch.finfo(torch.float16).max), 256.0),
}
# Scales below fp32's min normal lose precision (and can round to 0).
_MIN_SCALE = float(np.finfo(np.float32).tiny)


class QuantizedGradient:
    """A (q, o, i) gradient block stored as `data * scale`: `data` in the
    storage dtype, `scale` one fp32 factor per query, shape (q, 1, 1)."""

    def __init__(self, data: torch.Tensor, scale: torch.Tensor):
        self.data = data
        self.scale = scale

    def dequantize(self, dtype) -> torch.Tensor:
        dtype = resolve_dtype(dtype)
        return self.data.to(dtype) * self.scale.to(dtype)

    @property
    def shape(self):
        return self.data.shape


def quantize_gradient(psg: torch.Tensor, storage_dtype) -> QuantizedGradient:
    """Quantizes a (q, o, i) block with one scale per query. A zero query
    gets scale 1 (its payload stays zero)."""
    dt = resolve_dtype(storage_dtype)
    fmax, target = _FORMAT[dt]
    amax = psg.abs().amax(dim=tuple(range(1, psg.dim())), keepdim=True)
    scale = torch.where(amax > 0, torch.clamp_min(amax / target, _MIN_SCALE), 1.0)
    scale = scale.to(torch.float32)
    # The fp32-rounded scale can leave `psg / scale` a hair above fmax, which
    # the cast would turn into inf (NaN for the inf-less e4m3fn): clip first.
    data = torch.clamp(psg / scale.to(psg.dtype), -fmax, fmax).to(dt)
    return QuantizedGradient(data, scale)


def dequantize_gradient(pg: Any, dtype) -> Any:
    """Dequantizes a QuantizedGradient; returns anything else as it is."""
    if isinstance(pg, QuantizedGradient):
        return pg.dequantize(dtype)
    return pg


def concat_quantized(chunks: Sequence[QuantizedGradient]) -> QuantizedGradient:
    """Concatenates quantized chunks along the query axis, staying quantized:
    each chunk keeps its per-query scales, so the merge is exact."""
    return QuantizedGradient(
        torch.cat([c.data for c in chunks], dim=0),
        torch.cat([c.scale for c in chunks], dim=0),
    )
