"""Small CNN test model and the conv building blocks of the port's vision
models (NCHW). Port of `kronfluence_tpu/models/cnn.py`.

`Conv2d` is `nn.Conv2d` with flax's padding rules, so that a stride-2 "SAME"
conv pads as the JAX package's does (see `ops/flatten.py:same_pads`), and
`max_pool` is flax's `nn.max_pool` (padding with -inf). `SmallCNN`'s head
flattens its features in flax's NHWC order (h, w, c), so its Dense kernel
carries over by a plain transpose (`models/convert.py`).
"""

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from kronfluence_tpu_torch.capture.functional import padded_conv2d
from kronfluence_tpu_torch.capture.specs import normalize_padding
from kronfluence_tpu_torch.ops.flatten import conv_pads

PaddingLike = Union[str, int, Sequence]


def _pair(value) -> Tuple[int, int]:
    return (value, value) if isinstance(value, int) else tuple(value)


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` with flax's padding at any stride: "SAME", "VALID" or
    explicit (lo, hi) pairs, which may differ. `self.padding` holds that
    form, which the capture spec reads; the forward is the functional
    `conv2d`'s (`capture/functional.py:padded_conv2d`)."""

    def __init__(
        self, in_channels: int, out_channels: int, kernel_size, stride=1,
        padding: PaddingLike = "SAME", dilation=1, groups: int = 1, bias: bool = True,
        device=None, dtype=None,
    ) -> None:
        super().__init__(
            in_channels, out_channels, kernel_size, stride=stride, padding=0,
            dilation=dilation, groups=groups, bias=bias, device=device, dtype=dtype,
        )
        self.padding = normalize_padding(padding)

    def _conv_forward(self, input, weight, bias):
        return padded_conv2d(input, weight, bias, self.stride, self.padding, self.dilation,
                             self.groups)

    def output_size(self, size: Sequence[int]) -> Tuple[int, int]:
        """Spatial output size for an input of spatial `size`."""
        pads = conv_pads(self.padding, size, self.kernel_size, self.stride, self.dilation)
        return tuple(
            (n + lo + hi - (k - 1) * d - 1) // s + 1
            for n, (lo, hi), k, s, d in zip(size, pads, self.kernel_size, self.stride,
                                            self.dilation)
        )


def max_pool(x: torch.Tensor, window, strides, padding: PaddingLike = "VALID") -> torch.Tensor:
    """flax's `nn.max_pool` on an NCHW input: padded with -inf, so that a
    "SAME" pool at stride 2 on an even input pads (0, 1) and takes no zero."""
    window, strides = _pair(window), _pair(strides)
    (top, bottom), (left, right) = conv_pads(
        normalize_padding(padding), x.shape[-2:], window, strides, (1, 1)
    )
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, window, strides)


class SmallCNN(nn.Module):
    """Conv -> ReLU stack with a dense classifier head. The first conv has one
    group, the others `groups`. `image_size` (H, W) fixes the head's width,
    which flax infers at init."""

    def __init__(
        self,
        num_classes: int = 10,
        channels: Sequence[int] = (8, 16),
        kernel: Tuple[int, int] = (3, 3),
        use_bias: bool = True,
        padding: PaddingLike = "SAME",
        strides: Tuple[int, int] = (1, 1),
        groups: int = 1,
        in_channels: int = 3,
        image_size: Tuple[int, int] = (8, 8),
        device=None,
        dtype: Optional[torch.dtype] = None,
    ) -> None:
        super().__init__()
        size = tuple(image_size)
        for i, ch in enumerate(channels):
            conv = Conv2d(
                in_channels, ch, kernel, stride=strides, padding=padding, bias=use_bias,
                groups=groups if i > 0 else 1, device=device, dtype=dtype,
            )
            size = conv.output_size(size)
            setattr(self, f"conv_{i}", conv)
            in_channels = ch
        self.num_convs = len(channels)
        self.head = nn.Linear(size[0] * size[1] * in_channels, num_classes, device=device,
                              dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"conv_{i}")(x))
        return self.head(x.permute(0, 2, 3, 1).flatten(1))
