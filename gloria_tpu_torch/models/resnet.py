"""ResNet / ResNeXt backbones with torchvision's topology and key names.

Port of ``gloria_tpu.models.resnet``: the same blocks, strides and
BatchNorm placement (stride on the 3×3 conv of a Bottleneck), with
torchvision's module names (``layer1.0.conv1``, ``layer1.0.downsample.0``)
so reference state dicts load as they are.  BatchNorm is the port's own
(``norm.BatchNorm2d``): ``train()`` and ``eval()`` switch it between batch
and running statistics.  One pass returns both the pooled
layer4 feature and the layer3 local-feature map, or every stage's output
for the U-Net (``return_features``).  Inputs are NCHW; the
image encoder hands them over in ``channels_last`` memory.  DenseNet is not
ported yet.

``dtype`` is the compute dtype (JAX ``resnet.py:101-107``): the input is cast
to it at the stem, every convolution runs in it on its f32 kernel cast at
use, and BatchNorm returns it; the pooled feature and the layer3 map come
back f32 (``resnet.py:132,135``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from .norm import BatchNorm2d
from .precision import Conv2d, round_to, widen


def _conv(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
          dtype: torch.dtype = torch.float32) -> Conv2d:
    # JAX resnet.py:101: nn.Conv(dtype=dtype, param_dtype=float32)
    return Conv2d(cin, cout, k, stride=stride, padding=k // 2, groups=groups, compute_dtype=dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 groups: int = 1, base_width: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, dtype=dtype)
        self.bn1 = BatchNorm2d(planes, dtype=dtype)
        self.conv2 = _conv(planes, planes, 3, dtype=dtype)
        self.bn2 = BatchNorm2d(planes, dtype=dtype)
        self.downsample = (nn.Sequential(_conv(inplanes, planes, 1, stride, dtype=dtype),
                                         BatchNorm2d(planes, dtype=dtype))
                           if downsample else None)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = self.downsample(x) if self.downsample is not None else x
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 groups: int = 1, base_width: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out = planes * self.expansion
        self.conv1 = _conv(inplanes, width, 1, dtype=dtype)
        self.bn1 = BatchNorm2d(width, dtype=dtype)
        self.conv2 = _conv(width, width, 3, stride, groups, dtype=dtype)
        self.bn2 = BatchNorm2d(width, dtype=dtype)
        self.conv3 = _conv(width, out, 1, dtype=dtype)
        self.bn3 = BatchNorm2d(out, dtype=dtype)
        self.downsample = (nn.Sequential(_conv(inplanes, out, 1, stride, dtype=dtype),
                                         BatchNorm2d(out, dtype=dtype))
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
                 width_per_group: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.conv1 = _conv(3, 64, 7, stride=2, dtype=dtype)
        self.bn1 = BatchNorm2d(64, dtype=dtype)
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
                    groups=groups, base_width=width_per_group, dtype=dtype))
                inplanes = out
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            planes *= 2

    def forward(self, x: torch.Tensor, return_features: bool = False):
        """(pooled, layer3 map), or with ``return_features`` (pooled, the
        dict of the U-Net's skips: ``input``, ``stem`` (after the ReLU,
        before the maxpool), ``layer1``-``layer4``)."""
        # JAX resnet.py:107: x.astype(dtype) at the stem
        stem = torch.relu(self.bn1(self.conv1(round_to(x, self.compute_dtype))))
        layer1 = self.layer1(self.maxpool(stem))
        layer2 = self.layer2(layer1)
        layer3 = self.layer3(layer2)
        layer4 = self.layer4(layer3)
        # AdaptiveAvgPool2d(1); JAX resnet.py:132,135: the pooled feature and
        # the layer3 map leave the backbone in f32
        pooled = widen(layer4.mean(dim=(2, 3)), self.compute_dtype)
        if return_features:
            return pooled, {"input": x, "stem": stem, "layer1": layer1, "layer2": layer2,
                            "layer3": layer3, "layer4": layer4}
        return pooled, widen(layer3, self.compute_dtype)


# name → (constructor kwargs, global feature dim, layer3 feature dim)
BACKBONES: dict[str, tuple[dict, int, int]] = {
    "resnet_18": (dict(block=BasicBlock, layers=(2, 2, 2, 2)), 512, 256),
    "resnet_34": (dict(block=BasicBlock, layers=(3, 4, 6, 3)), 512, 256),
    "resnet_50": (dict(block=Bottleneck, layers=(3, 4, 6, 3)), 2048, 1024),
    "resnet_101": (dict(block=Bottleneck, layers=(3, 4, 23, 3)), 2048, 1024),
    "resnext_50": (dict(block=Bottleneck, layers=(3, 4, 6, 3), groups=32, width_per_group=4), 2048, 1024),
    "resnext_101": (dict(block=Bottleneck, layers=(3, 4, 23, 3), groups=32, width_per_group=8), 2048, 1024),
}


def make_backbone(name: str, dtype: torch.dtype = torch.float32) -> tuple[ResNet, int, int]:
    if name not in BACKBONES:
        raise NotImplementedError(f"backbone {name!r} is not ported (DenseNet: queued in "
                                  f"ROADMAP.md A5.1); choose from {sorted(BACKBONES)}")
    spec, feature_dim, interm_dim = BACKBONES[name]
    return ResNet(**spec, dtype=dtype), feature_dim, interm_dim


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights in place, drawn from ``generator`` in module order;
    they keep activations finite and O(1) at full depth with eval-mode
    BatchNorm (identity running stats): He-normal convolutions (a 2×2
    stride-2 transposed convolution's fan-in is its input channels), zero
    conv biases, the last BatchNorm of every residual branch scaled to 0.25
    so the residual sums grow slowly; BERT-style N(0, 0.02) for dense layers
    and embeddings."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.ConvTranspose2d):
            m.weight.normal_(0.0, math.sqrt(2.0 / m.in_channels), generator=generator)
            m.bias.zero_()
        elif isinstance(m, (nn.Linear, nn.Embedding)):
            m.weight.normal_(0.0, 0.02, generator=generator)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, nn.MultiheadAttention):
            m.in_proj_weight.normal_(0.0, 0.02, generator=generator)
            m.in_proj_bias.zero_()
        elif isinstance(m, (BasicBlock, Bottleneck)):
            last = m.bn3 if isinstance(m, Bottleneck) else m.bn2
            last.weight.fill_(0.25)
    return model
