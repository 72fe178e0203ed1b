"""ResNet / ResNeXt backbones with torchvision's topology and key names.

Port of ``gloria_tpu.models.resnet``: the same blocks, strides and
BatchNorm placement (stride on the 3×3 conv of a Bottleneck), with
torchvision's module names (``layer1.0.conv1``, ``layer1.0.downsample.0``)
so reference state dicts load as they are.  One pass returns both the pooled
layer4 feature and the layer3 local-feature map.  Inputs are NCHW; the
image encoder hands them over in ``channels_last`` memory.  DenseNet is not
ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .norm import FrozenBatchNorm2d


def _conv(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, groups=groups, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.downsample = (nn.Sequential(_conv(inplanes, planes, 1, stride), FrozenBatchNorm2d(planes))
                           if downsample else None)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = self.downsample(x) if self.downsample is not None else x
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out = planes * self.expansion
        self.conv1 = _conv(inplanes, width, 1)
        self.bn1 = FrozenBatchNorm2d(width)
        self.conv2 = _conv(width, width, 3, stride, groups)
        self.bn2 = FrozenBatchNorm2d(width)
        self.conv3 = _conv(width, out, 1)
        self.bn3 = FrozenBatchNorm2d(out)
        self.downsample = (nn.Sequential(_conv(inplanes, out, 1, stride), FrozenBatchNorm2d(out))
                           if downsample else None)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.downsample(x) if self.downsample is not None else x
        return torch.relu(out + identity)


class ResNet(nn.Module):
    """Torchvision-topology ResNet returning (pooled layer4 [B, C4],
    layer3 map [B, C3, h, w])."""

    def __init__(self, block: type, layers: Sequence[int], groups: int = 1,
                 width_per_group: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes, planes = 64, 64
        for stage, num_blocks in enumerate(layers):
            stride = 1 if stage == 0 else 2
            blocks = []
            for i in range(num_blocks):
                out = planes * block.expansion
                blocks.append(block(
                    inplanes, planes, stride=stride if i == 0 else 1,
                    downsample=(i == 0 and (stride != 1 or inplanes != out)),
                    groups=groups, base_width=width_per_group))
                inplanes = out
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            planes *= 2

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        x = self.layer1(x)
        x = self.layer2(x)
        local = self.layer3(x)
        pooled = self.layer4(local).mean(dim=(2, 3))  # AdaptiveAvgPool2d(1)
        return pooled, local


# name → (constructor kwargs, global feature dim, layer3 feature dim)
BACKBONES: dict[str, tuple[dict, int, int]] = {
    "resnet_18": (dict(block=BasicBlock, layers=(2, 2, 2, 2)), 512, 256),
    "resnet_34": (dict(block=BasicBlock, layers=(3, 4, 6, 3)), 512, 256),
    "resnet_50": (dict(block=Bottleneck, layers=(3, 4, 6, 3)), 2048, 1024),
    "resnet_101": (dict(block=Bottleneck, layers=(3, 4, 23, 3)), 2048, 1024),
    "resnext_50": (dict(block=Bottleneck, layers=(3, 4, 6, 3), groups=32, width_per_group=4), 2048, 1024),
    "resnext_101": (dict(block=Bottleneck, layers=(3, 4, 23, 3), groups=32, width_per_group=8), 2048, 1024),
}


def make_backbone(name: str) -> tuple[ResNet, int, int]:
    if name not in BACKBONES:
        raise NotImplementedError(f"backbone {name!r} is not ported; choose from {sorted(BACKBONES)}")
    spec, feature_dim, interm_dim = BACKBONES[name]
    return ResNet(**spec), feature_dim, interm_dim
