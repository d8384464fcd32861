"""Tagged functional layers (public alias for capture.functional), as
`kronfluence_tpu.nn` is for the JAX package."""

from kronfluence_tpu_torch.capture.functional import (
    checkpoint_block,
    conv2d,
    linear,
    scan_layers,
)

__all__ = ["linear", "conv2d", "scan_layers", "checkpoint_block"]
