"""Public API: model loading, similarities, zero-shot classification, prompts.

Port of ``gloria_tpu.api``'s inference surface: ``GloriaModel`` (host
preprocessing, the two towers, global / local / combined similarities,
zero-shot classification), ``generate_chexpert_class_prompts`` and
``load_gloria`` for reference-format ``.ckpt`` files.

Everything runs on ``cuda`` unless the caller passes ``device="cpu"``; with
no device given and no card, the entry points raise.  They never fall back
to the CPU on their own.  Local similarities go through the CUDA kernel on
a card and through its plain version on the CPU
(:func:`gloria_tpu_torch.ops.gloria_loss.local_similarities_eval`).
"""

from __future__ import annotations

import os
import random
from pathlib import Path
from typing import Union

import numpy as np
import torch

from . import constants
from .configs import Config
from .data.tokenizer import TextProcessor, WordPieceTokenizer, load_tokenizer
from .data.transforms import build_transformation, letterbox_resize, to_rgb
from .models.gloria_model import GLoRIA
from .ops import gloria_loss

# the reference seeds these at import for prompt sampling; so does the JAX
# package, so both packages sample the same prompts
np.random.seed(6)
random.seed(6)

_MODELS = {
    "gloria_resnet50": "./pretrained/chexpert_resnet50.ckpt",
    "gloria_resnet18": "./pretrained/chexpert_resnet18.ckpt",
}
# the eval-path temperatures are fixed in the reference, whatever the config says
EVAL_TEMP1 = 4.0
EVAL_TEMP2 = 5.0


def available_models() -> list[str]:
    return list(_MODELS.keys())


def resolve_device(device=None) -> torch.device:
    """``None`` → the CUDA card, or an error when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available: pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


class GloriaModel:
    """A GLoRIA module with its weights, tokenizer and device, behind the
    reference's instance API."""

    def __init__(self, cfg: Config, state_dict: dict, tokenizer: WordPieceTokenizer | None = None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        model = GLoRIA(cfg)
        model.load_state_dict(state_dict, strict=True)
        model.img_encoder.to(memory_format=torch.channels_last)
        self.model = model.to(self.device).eval()
        text = cfg.model.text if cfg.model else None
        self.tokenizer = tokenizer or load_tokenizer(
            bert_type=text.bert_type if text else None,
            vocab_file=text.vocab_file if text else None,
            corpus=["no finding"],
        )
        word_num = int(cfg.data.text.word_num or 97) if cfg.data and cfg.data.text else 97
        self.text_processor = TextProcessor(self.tokenizer, num_words=word_num)

    @property
    def imsize(self) -> int:
        data = self.cfg.data
        return int(data.image.imsize or 256) if data and data.image else 256

    @property
    def crop_size(self) -> int | None:
        t = self.cfg.transforms
        return int(t.random_crop.crop_size) if t and t.random_crop else None

    # -- host preprocessing ------------------------------------------------
    def process_img(self, paths_or_arrays) -> torch.Tensor:
        """Paths (cv2 grayscale read) or arrays → letterbox → eval transform →
        NHWC float32 on the model's device."""
        if isinstance(paths_or_arrays, (str, Path, np.ndarray)):
            paths_or_arrays = [paths_or_arrays]
        transform = build_transformation(self.cfg, split="test")
        imgs = []
        for p in paths_or_arrays:
            if isinstance(p, (str, Path)):
                import cv2

                x = cv2.imread(str(p), 0)
            else:
                x = np.asarray(p)
            imgs.append(transform(to_rgb(letterbox_resize(x, self.imsize))))
        return torch.from_numpy(np.stack(imgs).astype(np.float32)).to(self.device)

    def process_text(self, text: Union[str, list[str]]) -> dict:
        if isinstance(text, str):
            text = [text]
        return self.text_processor(text)

    def process_class_prompts(self, class_prompts: dict) -> dict:
        return {k: self.process_text(v) for k, v in class_prompts.items()}

    # -- forward + similarities ----------------------------------------------
    def _tensor(self, x, dtype=None) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
        return x.to(self.device, dtype=dtype)

    @torch.inference_mode()
    def encode_images(self, imgs):
        """[B, H, W, 3] float or uint8 → (img_emb_l [B, R, D], img_emb_g [B, D])."""
        img_l, img_g, _ = self.model.image_encoder_forward(self._tensor(imgs))
        return img_l, img_g

    @torch.inference_mode()
    def encode_text(self, txts: dict):
        """Processed text → (txt_emb_l [T, W, D], txt_emb_g [T, D])."""
        return self.model.text_encoder_forward(
            self._tensor(txts["caption_ids"], torch.long),
            self._tensor(txts["attention_mask"], torch.long),
            self._tensor(txts["token_type_ids"], torch.long),
            self._tensor(txts["word_assignment"], torch.float32))

    def encode(self, imgs, txts: dict):
        img_l, img_g = self.encode_images(imgs)
        txt_l, txt_g = self.encode_text(txts)
        return img_l, img_g, txt_l, txt_g

    @torch.inference_mode()
    def get_global_similarities(self, img_emb_g, text_emb_g) -> np.ndarray:
        return gloria_loss.global_similarities(img_emb_g, text_emb_g).cpu().numpy()

    @torch.inference_mode()
    def get_local_similarities(self, img_emb_l, text_emb_l, cap_lens) -> np.ndarray:
        return gloria_loss.local_similarities_eval(
            img_emb_l, text_emb_l, self._tensor(cap_lens, torch.long),
            temp1=EVAL_TEMP1, temp2=EVAL_TEMP2, sink=self.model.no_attn_vec,
        ).cpu().numpy()

    def get_similarities(self, imgs, txts, similarity_type: str = "both") -> np.ndarray:
        if similarity_type not in ("global", "local", "both"):
            raise RuntimeError("similarity type should be one of ['global', 'local', 'both']")
        if isinstance(txts, (str, list)):
            raise RuntimeError("Text input not processed - please use process_text")
        img_l, img_g, txt_l, txt_g = self.encode(imgs, txts)
        global_sim = self.get_global_similarities(img_g, txt_g)
        local_sim = self.get_local_similarities(img_l, txt_l, txts["cap_lens"])
        if similarity_type == "global":
            return global_sim
        if similarity_type == "local":
            return local_sim
        return (local_sim + global_sim) / 2

    def zero_shot_classification(self, imgs, cls_txt_mapping: dict):
        """Per-class max-over-prompts mean similarity, z-normalized across
        images; ``cls_txt_mapping`` maps class → processed prompts
        (:meth:`process_class_prompts`).  Returns a pandas DataFrame."""
        import pandas as pd

        class_similarities = []
        for cls_txt in cls_txt_mapping.values():
            sims = self.get_similarities(imgs, cls_txt, similarity_type="both")
            class_similarities.append(sims.max(axis=1))
        arr = np.stack(class_similarities, axis=1)
        if arr.shape[0] > 1:
            arr = (arr - arr.mean(axis=0)) / arr.std(axis=0)
        return pd.DataFrame(arr, columns=list(cls_txt_mapping.keys()))


def generate_chexpert_class_prompts(n: int = 5) -> dict:
    """severity × subtype × location prompt grammar sampling."""
    prompts = {}
    for k, v in constants.CHEXPERT_CLASS_PROMPTS.items():
        cls_prompts = []
        keys = list(v.keys())
        for k0 in v[keys[0]]:
            for k1 in v[keys[1]]:
                for k2 in v[keys[2]]:
                    cls_prompts.append(f"{k0} {k1} {k2}")
        prompts[k] = random.sample(cls_prompts, n)
    return prompts


def load_gloria(name: str = "gloria_resnet50", device=None, cfg_override: Config | None = None,
                tokenizer: WordPieceTokenizer | None = None) -> GloriaModel:
    """Load a registry name or a reference-format ``.ckpt`` (the reference zoo
    format, which ``python -m gloria_tpu.utils.torch_export`` writes from any
    JAX checkpoint)."""
    if name in _MODELS:
        ckpt_path = _MODELS[name]
    elif os.path.exists(name):
        ckpt_path = name
    else:
        raise RuntimeError(f"Model {name} not found; available models = {available_models()}")
    if not os.path.exists(ckpt_path):
        raise RuntimeError(f"Model {name} not found. Download the pretrained weights from the "
                           f"GLoRIA zoo and place them at {ckpt_path}.")
    if Path(ckpt_path).is_dir():
        raise RuntimeError(
            f"{ckpt_path} is a directory (a gloria_tpu orbax checkpoint); convert it first with "
            f"`python -m gloria_tpu.utils.torch_export {ckpt_path} <out.ckpt>` and load the .ckpt")
    # the reference format is a Lightning pickle whose hyper_parameters are a
    # config object, so it needs the full unpickler: load only trusted files
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    cfg = cfg_override or Config(_cfg_to_dict(ckpt.get("hyper_parameters", {})))
    # strip the reference's ``gloria.`` prefix; drop the BN num_batches_tracked
    # counters, which eval-mode BatchNorm does not use
    state = {(k[len("gloria."):] if k.startswith("gloria.") else k): v
             for k, v in ckpt["state_dict"].items() if not k.endswith("num_batches_tracked")}
    return GloriaModel(cfg, state, tokenizer, device=device)


def _cfg_to_dict(obj):
    """OmegaConf / namespace / dict → plain dict."""
    if hasattr(obj, "items"):
        return {k: _cfg_to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_cfg_to_dict(v) for v in obj]
    return obj
