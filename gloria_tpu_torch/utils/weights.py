"""Weights bridge between JAX ``variables`` (nested numpy dicts) and the port's state dict.

The port's own copy of the layout rules of
``gloria_tpu.utils.torch_export``: conv kernels HWIO → OIHW, dense kernels
``[in, out]`` → ``[out, in]``, flax ``batch_stats`` → BatchNorm running
stats, and flax multi-head attention's per-head kernels packed into
``in_proj_weight``.  The keys are the reference's torch keys without the
``gloria.`` prefix, so the result loads into
:class:`gloria_tpu_torch.models.gloria_model.GLoRIA` with ``strict=True``.
:func:`classifier_state_dict_from_jax` and :func:`unet_state_dict_from_jax`
do the same for the downstream task models (``models/vision_model.py``,
``models/unet.py``).  A flax ``ConvTranspose((2, 2), strides=(2, 2))``
equals ``nn.ConvTranspose2d`` only with its kernel flipped in both spatial
axes, then ``[kh, kw, in, out]`` → ``[in, out, kh, kw]``.
:func:`batch_stats_from_state_dict` takes the BatchNorm running statistics
the other way, so a model trained in the port hands its ``batch_stats``
back in the JAX layout.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _np(x: Any) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _conv(w) -> np.ndarray:
    return _np(w).transpose(3, 2, 0, 1)  # HWIO → OIHW


def _dense(w) -> np.ndarray:
    return _np(w).T


def _conv_transpose(w) -> np.ndarray:
    return np.ascontiguousarray(_np(w)[::-1, ::-1].transpose(2, 3, 0, 1))


def _prefixed(prefix: str, d: dict) -> dict:
    return {f"{prefix}{k}": v for k, v in d.items()}


def resnet_state_dict(params: dict, stats: dict) -> dict:
    """JAX ``ResNet`` (params, batch_stats) → torchvision-keyed arrays."""
    out: dict = {}

    def bn(p: dict, s: dict, dst: str):
        out[f"{dst}.weight"] = _np(p["scale"])
        out[f"{dst}.bias"] = _np(p["bias"])
        out[f"{dst}.running_mean"] = _np(s["mean"])
        out[f"{dst}.running_var"] = _np(s["var"])

    if "conv0" in params:
        raise NotImplementedError("DenseNet backbones are not ported yet "
                                  "(queued in ROADMAP.md A5.1)")
    out["conv1.weight"] = _conv(params["conv1"]["kernel"])
    bn(params["bn1"], stats["bn1"], "bn1")
    for name in sorted(k for k in params if k.startswith("layer")):
        stage, block = name[len("layer"):].split("_")
        p, s = params[name], stats[name]
        dst = f"layer{stage}.{block}"
        k = 1
        while f"conv{k}" in p:
            out[f"{dst}.conv{k}.weight"] = _conv(p[f"conv{k}"]["kernel"])
            bn(p[f"bn{k}"], s[f"bn{k}"], f"{dst}.bn{k}")
            k += 1
        if "downsample_conv" in p:
            out[f"{dst}.downsample.0.weight"] = _conv(p["downsample_conv"]["kernel"])
            bn(p["downsample_bn"], s["downsample_bn"], f"{dst}.downsample.1")
    return out


def bert_state_dict(params: dict) -> dict:
    """JAX ``BertModel`` params → HF-keyed arrays (``position_ids`` included)."""
    out: dict = {}

    def ln(src: dict, dst: str):
        out[f"{dst}.weight"] = _np(src["scale"])
        out[f"{dst}.bias"] = _np(src["bias"])

    def dense(src: dict, dst: str):
        out[f"{dst}.weight"] = _dense(src["kernel"])
        out[f"{dst}.bias"] = _np(src["bias"])

    pos = _np(params["position_embeddings"]["embedding"])
    out["embeddings.word_embeddings.weight"] = _np(params["word_embeddings"]["embedding"])
    out["embeddings.position_embeddings.weight"] = pos
    out["embeddings.position_ids"] = np.arange(pos.shape[0], dtype=np.int64)[None, :]
    out["embeddings.token_type_embeddings.weight"] = _np(params["token_type_embeddings"]["embedding"])
    ln(params["embeddings_ln"], "embeddings.LayerNorm")
    dense(params["pooler"], "pooler.dense")
    i = 0
    while f"layer_{i}" in params:
        src, dst = params[f"layer_{i}"], f"encoder.layer.{i}"
        dense(src["attention"]["query"], f"{dst}.attention.self.query")
        dense(src["attention"]["key"], f"{dst}.attention.self.key")
        dense(src["attention"]["value"], f"{dst}.attention.self.value")
        dense(src["attention"]["out"], f"{dst}.attention.output.dense")
        ln(src["attention"]["ln"], f"{dst}.attention.output.LayerNorm")
        dense(src["intermediate"], f"{dst}.intermediate.dense")
        dense(src["output"], f"{dst}.output.dense")
        ln(src["ln"], f"{dst}.output.LayerNorm")
        i += 1
    return out


def _transformer_layer(params: dict, prefix: str) -> dict:
    attn = params["self_attn"]
    d = _np(attn["out"]["bias"]).shape[0]
    # per-head [D, H, hd] kernels → packed [3D, D] in_proj (torch rows = out)
    qkv_w = np.concatenate([_np(attn[k]["kernel"]).reshape(d, d).T for k in ("query", "key", "value")])
    qkv_b = np.concatenate([_np(attn[k]["bias"]).reshape(d) for k in ("query", "key", "value")])
    return {
        f"{prefix}.self_attn.in_proj_weight": qkv_w,
        f"{prefix}.self_attn.in_proj_bias": qkv_b,
        f"{prefix}.self_attn.out_proj.weight": _np(attn["out"]["kernel"]).reshape(d, d).T,
        f"{prefix}.self_attn.out_proj.bias": _np(attn["out"]["bias"]),
        f"{prefix}.linear1.weight": _dense(params["linear1"]["kernel"]),
        f"{prefix}.linear1.bias": _np(params["linear1"]["bias"]),
        f"{prefix}.linear2.weight": _dense(params["linear2"]["kernel"]),
        f"{prefix}.linear2.bias": _np(params["linear2"]["bias"]),
        f"{prefix}.norm1.weight": _np(params["norm1"]["scale"]),
        f"{prefix}.norm1.bias": _np(params["norm1"]["bias"]),
        f"{prefix}.norm2.weight": _np(params["norm2"]["scale"]),
        f"{prefix}.norm2.bias": _np(params["norm2"]["bias"]),
    }


def _backbone_stats(stats: dict | None, *path: str) -> dict:
    for key in path:
        stats = (stats or {}).get(key)
    if not stats:
        raise ValueError("variables carry no batch_stats for the image backbone; BN running "
                         "stats are part of the model")
    return stats


def _image_encoder_state_dict(params: dict, stats: dict | None) -> dict:
    """JAX ``ImageEncoder`` (``params["img_encoder"]``) → ``img_encoder.*``
    keys; the embedders when the tree has them."""
    enc = params["img_encoder"]
    out = _prefixed("img_encoder.model.", resnet_state_dict(
        enc["backbone"], _backbone_stats(stats, "img_encoder", "backbone")))
    if "global_embedder" in enc:
        out["img_encoder.global_embedder.weight"] = _dense(enc["global_embedder"]["kernel"])
        out["img_encoder.global_embedder.bias"] = _np(enc["global_embedder"]["bias"])
        out["img_encoder.local_embedder.weight"] = _conv(enc["local_embedder"]["kernel"])
    return out


def _to_torch(d: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}  # owned, writable copies


def classifier_state_dict_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """JAX ``ImageClassifier`` (``backbone``, ``classifier``) or
    ``PretrainedImageClassifier`` (``img_encoder``, ``classifier``)
    variables → the port's state dict."""
    params, stats = variables["params"], variables.get("batch_stats")
    if "img_encoder" in params:
        out = _image_encoder_state_dict(params, stats)
    else:
        out = _prefixed("backbone.", resnet_state_dict(params["backbone"],
                                                       _backbone_stats(stats, "backbone")))
    out["classifier.weight"] = _dense(params["classifier"]["kernel"])
    out["classifier.bias"] = _np(params["classifier"]["bias"])
    return _to_torch(out)


def unet_state_dict_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """JAX ``ResnetUNet`` variables → the port's state dict, transposed
    convolutions flipped (module docstring)."""
    params, stats = variables["params"], variables.get("batch_stats")
    out = _prefixed("backbone.", resnet_state_dict(params["backbone"],
                                                   _backbone_stats(stats, "backbone")))

    def conv_block(p: dict, s: dict, dst: str):
        out[f"{dst}.conv.weight"] = _conv(p["conv"]["kernel"])
        out[f"{dst}.conv.bias"] = _np(p["conv"]["bias"])
        out[f"{dst}.bn.weight"] = _np(p["bn"]["scale"])
        out[f"{dst}.bn.bias"] = _np(p["bn"]["bias"])
        out[f"{dst}.bn.running_mean"] = _np(s["bn"]["mean"])
        out[f"{dst}.bn.running_var"] = _np(s["bn"]["var"])

    for name in ("bridge_1", "bridge_2"):
        conv_block(params[name], stats[name], name)
    for i in range(1, 6):
        name = f"up{i}"
        p, s = params[name], stats[name]
        out[f"{name}.upsample.weight"] = _conv_transpose(p["upsample"]["kernel"])
        out[f"{name}.upsample.bias"] = _np(p["upsample"]["bias"])
        conv_block(p["conv_block_1"], s["conv_block_1"], f"{name}.conv_block_1")
        conv_block(p["conv_block_2"], s["conv_block_2"], f"{name}.conv_block_2")
    out["out.weight"] = _conv(params["out"]["kernel"])
    out["out.bias"] = _np(params["out"]["bias"])
    return _to_torch(out)


def state_dict_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """JAX ``{"params": ..., "batch_stats": ...}`` as nested numpy dicts →
    the port's state dict (reference keys, no ``gloria.`` prefix)."""
    params = variables["params"]
    out = _image_encoder_state_dict(params, variables.get("batch_stats"))
    for k, v in bert_state_dict(params["text_encoder"]["bert"]).items():
        out[f"text_encoder.model.{k}"] = v
    if "position_embeddings" in params:
        out["position_embeddings.image_position_embeddings.weight"] = _np(
            params["position_embeddings"]["table"]["embedding"])
    i = 0
    while f"image_transformer_{i}" in params:
        out.update(_transformer_layer(params[f"image_transformer_{i}"], f"image_transformer.layers.{i}"))
        i += 1
    if "no_attn_vec" in params:
        out["no_attn_vec"] = _np(params["no_attn_vec"])
    return _to_torch(out)


def batch_stats_from_state_dict(state_dict: dict) -> dict:
    """The port's BatchNorm running statistics → JAX ``batch_stats``
    (``{"img_encoder": {"backbone": {"bn1": {"mean", "var"}, "layer1_0":
    {"bn1": ..., "downsample_bn": ...}, ...}}}``, numpy f32): the inverse of
    :func:`state_dict_from_jax`'s BatchNorm rule."""
    prefix, suffix = "img_encoder.model.", ".running_mean"
    backbone: dict = {}
    for key, mean in state_dict.items():
        if not (key.startswith(prefix) and key.endswith(suffix)):
            continue
        path = key[len(prefix):-len(suffix)]  # bn1 | layer1.0.bn2 | layer1.0.downsample.1
        parts = path.split(".")
        if len(parts) == 1:
            node = backbone.setdefault(parts[0], {})
        else:
            block = backbone.setdefault(f"{parts[0]}_{parts[1]}", {})
            node = block.setdefault("downsample_bn" if parts[2] == "downsample" else parts[2], {})
        # copies: a state dict's tensors share the live buffers' memory
        node["mean"] = mean.detach().cpu().numpy().astype(np.float32, copy=True)
        node["var"] = (state_dict[f"{prefix}{path}.running_var"].detach().cpu().numpy()
                       .astype(np.float32, copy=True))
    if not backbone:
        raise ValueError("the state dict carries no BatchNorm running statistics under "
                         f"{prefix!r}")
    return {"img_encoder": {"backbone": backbone}}
