"""Image encoder and the classifier heads.

Port of ``gloria_tpu.models.vision_model``:

- ``ImageEncoder``: the fixed bilinear 299×299 upsample (align_corners=True)
  when the input is not already at ``input_size``, the backbone's pooled
  layer4 feature through a linear global embedder, and its layer3 map
  through a 1×1-conv local embedder; ``get_embeddings=False`` returns the
  backbone's raw (pooled feature, layer3 map) instead;
- ``ImageClassifier``: the same upsample, a backbone trained from scratch
  and a linear head;
- ``PretrainedImageClassifier``: a linear head over the 2048-d pooled
  feature of an ``ImageEncoder`` (not its 768-d projection), the encoder
  grafted from a GLoRIA checkpoint.  Its embedders are kept, unused, so the
  GLoRIA image encoder loads whole, as the JAX package grafts the whole
  subtree; freezing is the optimizer's (``training.optim.freeze_wrap``).

Input is NHWC (the JAX layout).  The permute to NCHW is a view, so the
backbone runs in ``channels_last`` memory.  The local embedding comes back
as ``[B, R, D]`` with R = h·w row-major, equal to the JAX package's NHWC
``reshape(b, h*w, d)``; the raw layer3 map stays NCHW.

``ImageEncoder(dtype=...)`` is the compute dtype of the upsample and the
backbone (JAX ``vision_model.py:48-50``); the two embedders run in f32 on
the backbone's f32 outputs (``vision_model.py:55-57``).  The classifiers
are the downstream tasks', which run in f32.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.resize import resize_bilinear
from .resnet import make_backbone


def _upsample(x: torch.Tensor, input_size: int | None,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if input_size and x.shape[1] != input_size:
        # JAX vision_model.py:48-50: compute_dtype=dtype
        x = resize_bilinear(x, (input_size, input_size), align_corners=True,
                            compute_dtype=dtype)
    return x


class ImageEncoder(nn.Module):
    def __init__(self, model_name: str = "resnet_50", output_dim: int = 768,
                 norm: bool = False, input_size: int | None = 299,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.model, feature_dim, interm_dim = make_backbone(model_name, dtype=dtype)
        self.compute_dtype = dtype
        self.global_embedder = nn.Linear(feature_dim, output_dim)
        self.local_embedder = nn.Conv2d(interm_dim, output_dim, 1, bias=False)
        self.norm = norm
        self.input_size = input_size

    def forward(self, x: torch.Tensor, get_embeddings: bool = True):
        """x: [B, H, W, 3] normalized images → (global_emb [B, D],
        local_emb [B, R, D], (h, w)); with ``get_embeddings=False`` the raw
        (pooled feature [B, C4], layer3 map [B, C3, h, w])."""
        global_ft, local_ft = self.model(
            _upsample(x, self.input_size, self.compute_dtype).permute(0, 3, 1, 2))
        if not get_embeddings:
            return global_ft, local_ft
        global_emb = self.global_embedder(global_ft)
        local_emb = self.local_embedder(local_ft)  # [B, D, h, w]
        if self.norm:
            local_emb = local_emb / torch.linalg.vector_norm(local_emb, dim=1, keepdim=True)
            global_emb = global_emb / torch.linalg.vector_norm(global_emb, dim=-1, keepdim=True)
        h, w = local_emb.shape[-2:]
        return global_emb, local_emb.flatten(2).transpose(1, 2), (h, w)


class ImageClassifier(nn.Module):
    """Backbone + linear head trained from scratch: [B, H, W, 3] → logits
    [B, num_classes]."""

    def __init__(self, model_name: str = "resnet_50", num_classes: int = 5,
                 input_size: int | None = 299):
        super().__init__()
        self.backbone, feature_dim, _ = make_backbone(model_name)
        self.classifier = nn.Linear(feature_dim, num_classes)
        self.input_size = input_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled, _ = self.backbone(_upsample(x, self.input_size).permute(0, 3, 1, 2))
        return self.classifier(pooled)


class PretrainedImageClassifier(nn.Module):
    """Linear head over a (frozen or finetuned) pretrained ``ImageEncoder``'s
    pooled feature: [B, H, W, 3] → logits [B, num_classes].
    ``output_dim`` is the GLoRIA embedders' width, so the encoder loads."""

    def __init__(self, model_name: str = "resnet_50", output_dim: int = 768,
                 num_classes: int = 1):
        super().__init__()
        self.img_encoder = ImageEncoder(model_name, output_dim)
        self.classifier = nn.Linear(self.img_encoder.global_embedder.in_features, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled, _ = self.img_encoder(x, get_embeddings=False)
        return self.classifier(pooled)
