"""Layer specifications: static metadata describing a tracked layer call.

Port of `kronfluence_tpu/capture/specs.py`, unchanged: a LayerSpec is what the
per-layer math needs to flatten activations and output gradients into the
Kronecker-factored form. The port tracks `nn.Linear` (kind 'linear') and
`nn.Conv2d` (kind 'conv2d') layers; a conv spec's geometry is in the JAX
package's form, so specs compare equal across the two packages.
"""

from dataclasses import dataclass
from typing import Optional, Tuple, Union

PaddingSpec = Union[str, Tuple[Tuple[int, int], ...]]


def normalize_padding(padding) -> PaddingSpec:
    """A conv padding in the JAX package's form: "SAME" / "VALID", or
    explicit ((lo, hi), (lo, hi)) pairs (an int p is (p, p) on both dims).
    torch's 'same' (stride 1 only) pads (total // 2, total - total // 2),
    as XLA's "SAME" does."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    return tuple((p, p) if isinstance(p, int) else tuple(p) for p in padding)


@dataclass(frozen=True)
class LayerSpec:
    """Static description of one tracked layer.

    Attributes:
        name: Unique module name: the torch qualified name with '/' for '.',
            which is the flax path of the JAX package's model.
        kind: 'linear' or 'conv2d'.
        has_bias: Whether a ones-column is appended to flattened activations
            so the bias gradient is folded into the weight gradient
            (reference: linear.py:39-43).
        in_dim: Flattened activation feature dimension (without bias column).
            For conv2d this is C_in/groups * K_h * K_w.
        out_dim: Output feature dimension (C_out for conv2d).
        kernel_size / strides / padding / kernel_dilation / feature_group_count:
            Conv-only geometry, in the JAX package's NHWC / HWIO layout.
    """

    name: str
    kind: str
    has_bias: bool
    in_dim: int
    out_dim: int
    kernel_size: Optional[Tuple[int, int]] = None
    strides: Optional[Tuple[int, int]] = None
    padding: Optional[PaddingSpec] = None
    kernel_dilation: Optional[Tuple[int, int]] = None
    feature_group_count: int = 1

    @property
    def activation_dim(self) -> int:
        """Flattened activation dim including the bias ones-column."""
        return self.in_dim + (1 if self.has_bias else 0)

    @property
    def gradient_dim(self) -> int:
        return self.out_dim
