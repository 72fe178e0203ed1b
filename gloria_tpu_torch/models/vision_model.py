"""Image encoder: ResNet backbone + global and local embedders.

Port of ``gloria_tpu.models.vision_model.ImageEncoder``: the fixed bilinear
299×299 upsample (align_corners=True) when the input is not already at
``input_size``, the backbone's pooled layer4 feature through a linear
global embedder, and its layer3 map through a 1×1-conv local embedder.

Input is NHWC (the JAX layout).  The permute to NCHW is a view, so the
backbone runs in ``channels_last`` memory.  The local embedding comes back
as ``[B, R, D]`` with R = h·w row-major, equal to the JAX package's NHWC
``reshape(b, h*w, d)``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.resize import resize_bilinear
from .resnet import make_backbone


class ImageEncoder(nn.Module):
    def __init__(self, model_name: str = "resnet_50", output_dim: int = 768,
                 norm: bool = False, input_size: int | None = 299):
        super().__init__()
        self.model, feature_dim, interm_dim = make_backbone(model_name)
        self.global_embedder = nn.Linear(feature_dim, output_dim)
        self.local_embedder = nn.Conv2d(interm_dim, output_dim, 1, bias=False)
        self.norm = norm
        self.input_size = input_size

    def forward(self, x: torch.Tensor):
        """x: [B, H, W, 3] normalized images → (global_emb [B, D],
        local_emb [B, R, D], (h, w))."""
        if self.input_size and x.shape[1] != self.input_size:
            x = resize_bilinear(x, (self.input_size, self.input_size), align_corners=True)
        global_ft, local_ft = self.model(x.permute(0, 3, 1, 2))
        global_emb = self.global_embedder(global_ft)
        local_emb = self.local_embedder(local_ft)  # [B, D, h, w]
        if self.norm:
            local_emb = local_emb / torch.linalg.vector_norm(local_emb, dim=1, keepdim=True)
            global_emb = global_emb / torch.linalg.vector_norm(global_emb, dim=-1, keepdim=True)
        h, w = local_emb.shape[-2:]
        return global_emb, local_emb.flatten(2).transpose(1, 2), (h, w)
