"""ResNet family (NCHW) for the vision workloads. Port of
`kronfluence_tpu/models/resnet.py`.

ResNet-9 is the reference's CIFAR example model, and `resnet50` the ImageNet
workload's. The attribute names are the flax module names (`stem`, `layer1`,
`res1/block_0/conv`, `stage3_block2/conv2`, `classifier`, ...), so module
names and factor artifacts line up with the JAX package's. BatchNorm uses its
running statistics in eval mode, which `prepare_model` sets (the reference
does the same); its eps is flax's 1e-5 and its momentum flax's 0.99 (torch's
0.01). In training mode (the examples' `train_resnet9`) it normalises by the
batch statistics and updates the running variance with the biased batch
variance, as flax does (`BatchNorm2d`).

Every conv pads as flax's does (`models/cnn.py:Conv2d`): a "SAME" 3x3 conv at
stride 2 on an even input pads (0, 1), not torch's (1, 1), and the stem's
"SAME" 3x3 max-pool at stride 2 pads (0, 1) with -inf.
"""

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from kronfluence_tpu_torch.models.cnn import Conv2d, max_pool


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` whose training mode updates the running variance as
    flax's BatchNorm does, with the biased batch variance (torch's own takes
    the unbiased one, n / (n - 1) times larger). The output in either mode
    and the eval mode as a whole are `nn.BatchNorm2d`'s."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(1 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1 - self.momentum).add_(var, alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


def _batch_norm(channels: int, device, dtype) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5, momentum=0.01, device=device, dtype=dtype)


class ConvBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int, pool: bool = False, device=None,
                 dtype=None) -> None:
        super().__init__()
        self.conv = Conv2d(in_channels, channels, 3, padding="SAME", bias=False,
                           device=device, dtype=dtype)
        self.bn = _batch_norm(channels, device, dtype)
        self.pool = pool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn(self.conv(x)))
        if self.pool:
            x = max_pool(x, 2, 2)
        return x


class Residual(nn.Module):
    def __init__(self, channels: int, device=None, dtype=None) -> None:
        super().__init__()
        self.block_0 = ConvBlock(channels, channels, device=device, dtype=dtype)
        self.block_1 = ConvBlock(channels, channels, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.block_1(self.block_0(x))


class ResNet9(nn.Module):
    """CIFAR-scale ResNet-9 (the reference's examples/cifar model)."""

    def __init__(self, num_classes: int = 10, in_channels: int = 3, device=None,
                 dtype=None) -> None:
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.stem = ConvBlock(in_channels, 64, **kw)
        self.layer1 = ConvBlock(64, 128, pool=True, **kw)
        self.res1 = Residual(128, **kw)
        self.layer2 = ConvBlock(128, 256, pool=True, **kw)
        self.layer3 = ConvBlock(256, 512, pool=True, **kw)
        self.res2 = Residual(512, **kw)
        self.classifier = nn.Linear(512, num_classes, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer1(self.stem(x))
        x = self.res1(x)
        x = self.res2(self.layer3(self.layer2(x)))
        return self.classifier(x.amax(dim=(2, 3)))


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 bottleneck; `proj` (a strided 1x1 conv and
    its BatchNorm) carries the residual where the shapes differ. `bn3`'s scale
    starts at 0, as flax's `scale_init=zeros` does."""

    def __init__(self, in_channels: int, channels: int, strides: int = 1, device=None,
                 dtype=None) -> None:
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv1 = Conv2d(in_channels, channels, 1, bias=False, **kw)
        self.bn1 = _batch_norm(channels, **kw)
        self.conv2 = Conv2d(channels, channels, 3, stride=strides, padding="SAME", bias=False,
                            **kw)
        self.bn2 = _batch_norm(channels, **kw)
        self.conv3 = Conv2d(channels, channels * 4, 1, bias=False, **kw)
        self.bn3 = _batch_norm(channels * 4, **kw)
        nn.init.zeros_(self.bn3.weight)
        if in_channels != channels * 4 or strides != 1:
            self.proj = Conv2d(in_channels, channels * 4, 1, stride=strides, bias=False, **kw)
            self.proj_bn = _batch_norm(channels * 4, **kw)
        else:
            self.proj = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.proj is None else self.proj_bn(self.proj(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """Bottleneck ResNet; stage_sizes (3, 4, 6, 3) is ResNet-50. Blocks are the
    attributes `stage{s}_block{b}`, as the flax module names them."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), num_classes: int = 1000,
                 in_channels: int = 3, device=None, dtype=None) -> None:
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.stem = Conv2d(in_channels, 64, 7, stride=2, padding=((3, 3), (3, 3)), bias=False,
                           **kw)
        self.stem_bn = _batch_norm(64, **kw)
        self.blocks = []
        channels_in = 64
        for stage, size in enumerate(stage_sizes):
            channels = 64 * 2**stage
            for block in range(size):
                strides = 2 if stage > 0 and block == 0 else 1
                name = f"stage{stage}_block{block}"
                setattr(self, name, BottleneckBlock(channels_in, channels, strides, **kw))
                self.blocks.append(name)
                channels_in = channels * 4
        self.classifier = nn.Linear(channels_in, num_classes, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.stem_bn(self.stem(x)))
        x = max_pool(x, 3, 2, padding="SAME")
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.classifier(x.mean(dim=(2, 3)))


def resnet50(num_classes: int = 1000, device=None, dtype=None) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), num_classes=num_classes, device=device, dtype=dtype)


@torch.no_grad()
def init_vision(model: nn.Module, seed: int = 0, device=None) -> nn.Module:
    """Moves `model` to `device` (the card unless the caller names another)
    and draws its weights from a seeded `torch.Generator` there (any model
    of Conv2d, Linear and BatchNorm2d layers: the examples' MLP too): conv
    and Dense kernels normal with std 1/sqrt(fan_in) (flax's lecun scale),
    zero biases, and every BatchNorm's scale and bias (1 + 0.1 z and 0.1 z),
    running mean (0.1 z) and running variance (uniform in [0.5, 1.5]) in
    place of the init's 1, 0, 0 and 1: the init's `bn3` scale of 0 would
    zero every residual branch of a ResNet and, with it, those convs'
    gradients and factors."""
    device = torch.device("cuda" if device is None else device)
    model.to(device)
    gen = torch.Generator(device).manual_seed(seed)
    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            fan_in = module.weight[0].numel()
            module.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.BatchNorm2d):
            module.weight.normal_(1.0, 0.1, generator=gen)
            module.bias.normal_(0.0, 0.1, generator=gen)
            module.running_mean.normal_(0.0, 0.1, generator=gen)
            module.running_var.uniform_(0.5, 1.5, generator=gen)
    return model
