"""ResNet-encoder U-Net for pneumothorax segmentation.

Port of ``gloria_tpu.models.unet``: a ResNet encoder (``backbone``, the
torchvision names of ``resnet.py``) with skips at its input, its stem (after
the ReLU, before the maxpool) and layer1-layer3, a bridge of two 3×3
ConvBlocks at 2048 channels on layer4, five UpBlocks (a 2×2 stride-2
transposed convolution, the skip concatenated after it, two 3×3 ConvBlocks)
to 1024, 512, 256, 128 and 64 channels, and a 1×1 output head.  A GLoRIA
image encoder's backbone grafts straight into ``backbone``
(``training.checkpoints.graft_subtree``).

BatchNorm is the port's own (``norm.BatchNorm2d``: flax's momentum 0.9 on
the old average, which is torch's 0.1, eps 1e-5, the biased batch
variance).  Input [B, H, W, 3] NHWC with H and W divisible by 32; output
[B, H, W, n_classes] NHWC, as in the JAX package.  Module names follow the
JAX package's (``bridge_1.conv``, ``up1.upsample``, ``up1.conv_block_1.bn``,
``out``), so ``utils.weights.unet_state_dict_from_jax`` is a renaming.
"""

from __future__ import annotations

import torch
from torch import nn

from .norm import BatchNorm2d
from .resnet import make_backbone


class ConvBlock(nn.Module):
    """3×3 conv (with bias) → BatchNorm → ReLU."""

    def __init__(self, in_channels: int, out_channels: int, with_nonlinearity: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.bn = BatchNorm2d(out_channels)
        self.with_nonlinearity = with_nonlinearity

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return torch.relu(x) if self.with_nonlinearity else x


class UpBlock(nn.Module):
    """2× transposed-conv upsample, concat the skip, two ConvBlocks."""

    def __init__(self, in_channels: int, skip_channels: int, out_channels: int,
                 up_out_channels: int | None = None):
        super().__init__()
        up_out = up_out_channels or out_channels
        self.upsample = nn.ConvTranspose2d(in_channels, up_out, 2, stride=2)
        self.conv_block_1 = ConvBlock(up_out + skip_channels, out_channels)
        self.conv_block_2 = ConvBlock(out_channels, out_channels)

    def forward(self, up_x: torch.Tensor, skip_x: torch.Tensor) -> torch.Tensor:
        x = torch.cat([self.upsample(up_x), skip_x], dim=1)
        return self.conv_block_2(self.conv_block_1(x))


class ResnetUNet(nn.Module):
    def __init__(self, model_name: str = "resnet_50", n_classes: int = 1):
        super().__init__()
        if "resnet" not in model_name:
            raise ValueError("Resnet UNet only accepts resnet backbones")
        self.backbone, c4, c3 = make_backbone(model_name)
        c2, c1 = c3 // 2, c3 // 4  # layer2 and layer1 outputs
        self.bridge_1 = ConvBlock(c4, 2048)
        self.bridge_2 = ConvBlock(2048, 2048)
        self.up1 = UpBlock(2048, c3, 1024)
        self.up2 = UpBlock(1024, c2, 512)
        self.up3 = UpBlock(512, c1, 256)
        self.up4 = UpBlock(256, 64, 128, up_out_channels=128)  # skip: the stem's 64
        self.up5 = UpBlock(128, 3, 64, up_out_channels=64)     # skip: the input image
        self.out = nn.Conv2d(64, n_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, 3] → logits [B, H, W, n_classes]."""
        _, feats = self.backbone(x.permute(0, 3, 1, 2), return_features=True)
        h = self.bridge_2(self.bridge_1(feats["layer4"]))
        h = self.up1(h, feats["layer3"])
        h = self.up2(h, feats["layer2"])
        h = self.up3(h, feats["layer1"])
        h = self.up4(h, feats["stem"])
        h = self.up5(h, feats["input"])
        return self.out(h).permute(0, 2, 3, 1)
