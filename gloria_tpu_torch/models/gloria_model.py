"""GLoRIA core model: the two encoders, the optional grounding extras, the loss.

Port of ``gloria_tpu.models.gloria_model.GLoRIA``:

- text encoder (BERT, last-4-layer aggregation) and image encoder (ResNet
  with the layer3 local-feature tap);
- optional 2-D factorized position embeddings added to the local image
  features;
- optional post-LN transformer encoder over the flattened local features;
- optional learnable no-attention sink vector ``no_attn_vec``;
- the uint8 input branch: raw pixels (C=3, or C=1 broadcast to 3) are
  normalized on the device in f32, exactly as the host pipeline does;
- ``calc_loss``: the weighted local, global, no-attention and
  attention-supervision terms.

``train()`` / ``eval()`` switch BatchNorm between batch and running
statistics and BERT's dropout on and off; train-mode dropout draws from the
``generator`` given to ``forward``.

Module names follow the reference's torch keys (``img_encoder.model.*``,
``text_encoder.model.*``, ``position_embeddings.image_position_embeddings``,
``image_transformer.layers.{i}``, ``no_attn_vec``), so a reference state
dict with ``gloria.`` stripped loads with ``strict=True``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..configs import Config
from ..data.transforms import norm_constants
from ..ops import gloria_loss
from ..ops.resize import resize_maps_nearest
from .bert import BertConfig
from .resnet import BasicBlock, Bottleneck
from .text_model import TextEncoder
from .vision_model import ImageEncoder


class PositionEmbeddings2D(nn.Module):
    """Factorized 2-D position table: the row and column embeddings of one
    shared table, concatenated (+ zero pad to ``hidden_size``)."""

    def __init__(self, num_positions: int, hidden_size: int, num_spatial_dims: int = 2):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_spatial_dims = num_spatial_dims
        self.image_position_embeddings = nn.Embedding(num_positions, hidden_size // num_spatial_dims)

    def forward(self, h: int, w: int) -> torch.Tensor:
        table = self.image_position_embeddings.weight
        pos_dim = table.shape[1]
        row = table[:h, None, :].expand(h, w, pos_dim)
        col = table[None, :w, :].expand(h, w, pos_dim)
        parts = [row, col]
        pad = self.hidden_size - self.num_spatial_dims * pos_dim
        if pad:
            parts.append(table.new_zeros(h, w, pad))
        return torch.cat(parts, dim=-1)  # [h, w, hidden]


class TransformerEncoderLayer(nn.Module):
    """Post-LN layer with ``nn.TransformerEncoderLayer``'s key names
    (dim_feedforward=2048, relu).  LayerNorm eps is 1e-6, the flax default
    the JAX package uses.  It has no dropout: the port does not train it yet
    (``training.train.make_pretrain_steps`` refuses such a config)."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int = 2048):
        super().__init__()
        self.self_attn = nn.MultiheadAttention(d_model, num_heads, batch_first=True)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn = self.self_attn(x, x, x, need_weights=False)[0]
        x = self.norm1(x + attn)
        return self.norm2(x + self.linear2(torch.relu(self.linear1(x))))


class ImageTransformer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(TransformerEncoderLayer(d_model, num_heads)
                                    for _ in range(num_layers))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


def bert_config_from_cfg(cfg: Config) -> BertConfig:
    overrides = (cfg.model.text.bert_config or {}) if cfg.model and cfg.model.text else {}
    return BertConfig(**dict(overrides))


class GLoRIA(nn.Module):
    """``cfg`` follows the reference experiment-yaml schema (``configs/*.yaml``)."""

    def __init__(self, cfg: Config):
        super().__init__()
        cfg = Config(cfg)
        if cfg.model is None:
            cfg.model = Config()
        for node in ("text", "vision", "gloria"):
            if cfg.model[node] is None:
                cfg.model[node] = Config()
        self.cfg = cfg
        dim = cfg.model.text.embedding_dim or 768
        self.text_encoder = TextEncoder(
            bert_config_from_cfg(cfg),
            last_n_layers=cfg.model.text.last_n_layers or 4,
            aggregate_method=cfg.model.text.aggregate_method or "sum",
            norm=bool(cfg.model.text.norm),
            agg_tokens=bool(cfg.model.text.agg_tokens),
        )
        self.img_encoder = ImageEncoder(
            model_name=cfg.model.vision.model_name or "resnet_50",
            output_dim=dim,
            norm=bool(cfg.model.norm),
            input_size=299 if cfg.model.vision.encoder_input_size is None
            else (cfg.model.vision.encoder_input_size or None),
        )
        self.position_embeddings = (
            PositionEmbeddings2D(cfg.model.image_position_embeddings.num, dim)
            if cfg.model.image_position_embeddings else None)
        self.image_transformer = (
            ImageTransformer(dim, cfg.model.image_transformer.num_heads,
                             cfg.model.image_transformer.num_layers)
            if cfg.model.image_transformer else None)
        self.no_attn_vec = nn.Parameter(torch.empty(dim)) if cfg.model.gloria.no_attn_vec else None
        mean, std = norm_constants(cfg.transforms.norm if cfg.transforms else None)
        self.register_buffer("norm_mean", torch.tensor(mean, dtype=torch.float32), persistent=False)
        self.register_buffer("norm_std", torch.tensor(std, dtype=torch.float32), persistent=False)

    def image_encoder_forward(self, imgs: torch.Tensor):
        """imgs [B, H, W, 3] float (host-normalized) or uint8 (raw pixels,
        C=3 or C=1) → (img_emb_l [B, R, D], img_emb_g [B, D], (h, w))."""
        if imgs.dtype == torch.uint8:
            x = imgs.float()
            if x.shape[-1] == 1:  # grayscale: replicate like the host's to_rgb
                x = x.expand(*x.shape[:-1], 3)
            imgs = (x / 255.0 - self.norm_mean) / self.norm_std
        img_emb_g, img_emb_l, (h, w) = self.img_encoder(imgs)
        if self.position_embeddings is not None:
            img_emb_l = img_emb_l + self.position_embeddings(h, w).reshape(1, h * w, -1)
        if self.image_transformer is not None:
            img_emb_l = self.image_transformer(img_emb_l)
        return img_emb_l, img_emb_g, (h, w)

    def text_encoder_forward(self, caption_ids, attention_mask, token_type_ids, word_assignment,
                             generator=None):
        return self.text_encoder(caption_ids, attention_mask, token_type_ids, word_assignment,
                                 generator)

    def forward(self, batch: dict, generator: torch.Generator | None = None):
        """batch keys: imgs [B,H,W,3], caption_ids/attention_mask/token_type_ids
        [B,T], word_assignment [B,W,T].  Returns the embedding 4-tuple + grid."""
        img_emb_l, img_emb_g, grid = self.image_encoder_forward(batch["imgs"])
        text_emb_l, text_emb_g = self.text_encoder_forward(
            batch["caption_ids"], batch["attention_mask"], batch["token_type_ids"],
            batch.get("word_assignment"), generator)
        return img_emb_l, img_emb_g, text_emb_l, text_emb_g, grid

    def calc_loss(self, img_emb_l, img_emb_g, text_emb_l, text_emb_g, cap_lens,
                  grid: tuple[int, int] | None = None, segmentation_labels=None):
        """Weighted multi-term loss.  Returns (loss, metrics dict, attn [B, W, R]).

        Ported: the local InfoNCE pair (its similarity matrix through the
        local-similarity kernels on a card), the global pair, the
        no-attention term and the attention-supervision term, which needs
        the local features' ``grid`` (h, w) and ``segmentation_labels``
        [B, H, W].  The flat-attention ablation losses are not, and configs
        that ask for them raise."""
        g = self.cfg.model.gloria
        for key in ("attention_divergence_loss_weight", "attention_entropy_loss_weight"):
            if g[key] is not None:
                raise NotImplementedError(
                    f"model.gloria.{key}: the flat-attention ablation losses are not ported yet "
                    "(queued in ROADMAP.md A1)")
        supervise = segmentation_labels is not None and bool(g.segmentation_loss_weight)
        if supervise and grid is None:
            raise ValueError("the attention-supervision loss needs the local features' grid (h, w)")
        local_w = 1.0 if g.local_loss_weight is None else g.local_loss_weight
        global_w = 1.0 if g.global_loss_weight is None else g.global_loss_weight
        temp3 = g.temp3 or 10.0
        l0, l1, no_attn_l, attn = gloria_loss.local_loss(
            img_emb_l, text_emb_l, cap_lens, temp1=g.temp1 or 4.0, temp2=g.temp2 or 5.0,
            temp3=temp3, sink=self.no_attn_vec, no_attn_loss_weight=g.no_attn_loss_weight)
        loss = 0.0
        metrics = {"local_loss0": l0, "local_loss1": l1}
        if local_w != 0:
            loss = loss + (l0 + l1) * local_w
        if global_w != 0:
            g0, g1 = gloria_loss.global_loss(img_emb_g, text_emb_g, temp3=temp3)
            metrics.update(global_loss0=g0, global_loss1=g1)
            loss = loss + (g0 + g1) * global_w
        if supervise:
            # attention-supervision NLL: the mean attention map over the valid
            # words, resized nearest to the label size and normalized to a
            # distribution; −log of its mass inside the bbox-union mask
            h, w = grid
            B, W, _ = attn.shape
            mask = gloria_loss.make_word_mask(cap_lens.to(attn.device), W, "train")[..., None]
            mean_maps = torch.where(mask, attn, 0.0).sum(1) / mask.sum(1).clamp_min(1)
            up = resize_maps_nearest(mean_maps.reshape(B, h, w),
                                     tuple(segmentation_labels.shape[1:3]))
            up = up / up.sum(dim=(-1, -2), keepdim=True).clamp_min(1e-12)
            inside = (segmentation_labels * up).sum(dim=(-1, -2))
            seg_loss = -torch.log(inside.clamp_min(1e-12)).mean() * g.segmentation_loss_weight
            metrics["attn_seg_loss"] = seg_loss
            loss = loss + seg_loss
        if g.no_attn_loss_weight is not None:
            metrics["no_attn_loss"] = no_attn_l
        loss = loss + no_attn_l
        metrics["loss"] = loss
        return loss, metrics, attn


@torch.no_grad()
def init_gloria(cfg: Config, seed: int = 0) -> GLoRIA:
    """A GLoRIA with random weights drawn from ``torch.Generator(seed)``.

    ``no_grad`` covers the init only: the returned model (in train mode, the
    ``nn.Module`` default) trains as it is.  The init keeps activations finite and O(1) at full depth with eval-mode
    BatchNorm (identity running stats): He-normal convolutions, and the last
    BatchNorm of every residual branch scaled to 0.25 so the residual sums
    grow slowly; BERT-style N(0, 0.02) for dense layers and embeddings."""
    model = GLoRIA(cfg)
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=g)
        elif isinstance(m, (nn.Linear, nn.Embedding)):
            m.weight.normal_(0.0, 0.02, generator=g)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, nn.MultiheadAttention):
            m.in_proj_weight.normal_(0.0, 0.02, generator=g)
            m.in_proj_bias.zero_()
        elif isinstance(m, (BasicBlock, Bottleneck)):
            last = m.bn3 if isinstance(m, Bottleneck) else m.bn2
            last.weight.fill_(0.25)
    if model.no_attn_vec is not None:
        model.no_attn_vec.normal_(0.0, 1.0, generator=g)
    return model
