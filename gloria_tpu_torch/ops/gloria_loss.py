"""GLoRIA eval similarities: the word mask, global cosine, local similarities.

Port of the eval subset of ``gloria_tpu.ops.gloria_loss``.  The losses
(``local_loss``, ``global_loss``) come with the training slice.

Device policy of :func:`local_similarities_eval`: a CUDA tensor goes to the
hand-written kernel (:mod:`.local_sim`) and a CPU tensor to its plain
version, whatever ``model.gloria.fused_kernel`` says.  In the port that flag
will govern only the training loss.
"""

from __future__ import annotations

import torch

from . import local_sim

EPS = 1e-8


def make_word_mask(cap_lens: torch.Tensor, num_words: int, convention: str) -> torch.Tensor:
    """Boolean [T, W] mask of the word positions that take part in matching.

    ``cap_lens`` counts the real (non-special) words + 1.
    convention='train': positions [0, cap_len)  — [CLS] + words
    convention='eval':  positions [1, cap_len]  — words + [SEP]
    """
    idx = torch.arange(num_words, device=cap_lens.device)[None, :]
    lens = cap_lens[:, None]
    if convention == "train":
        return idx < lens
    if convention == "eval":
        return (idx >= 1) & (idx <= lens)
    raise ValueError(f"unknown word-slice convention: {convention}")


def prepend_sink(regions: torch.Tensor, sink: torch.Tensor) -> torch.Tensor:
    """[B, R, D] → [B, 1+R, D] with the no-attention vector as region 0."""
    row = sink.to(regions.dtype)[None, None, :].expand(regions.shape[0], 1, regions.shape[2])
    return torch.cat([row, regions], dim=1)


def global_similarities(img_emb: torch.Tensor, txt_emb: torch.Tensor) -> torch.Tensor:
    """Pairwise cosine similarity [B_img, B_text]."""
    img = img_emb / torch.linalg.vector_norm(img_emb, dim=-1, keepdim=True).clamp_min(EPS)
    txt = txt_emb / torch.linalg.vector_norm(txt_emb, dim=-1, keepdim=True).clamp_min(EPS)
    return img @ txt.T


def local_similarities_eval(img_regions: torch.Tensor, words: torch.Tensor,
                            cap_lens: torch.Tensor, *, temp1: float = 4.0, temp2: float = 5.0,
                            sink: torch.Tensor | None = None) -> torch.Tensor:
    """Eval-path local similarities [B_img, T_text]: word slice
    ``[1, cap_len]`` and the **max** over words."""
    ctx = prepend_sink(img_regions, sink) if sink is not None else img_regions
    mask = make_word_mask(cap_lens.to(words.device), words.shape[1], "eval")
    return local_sim.local_similarities(words.float().contiguous(), ctx.float().contiguous(), mask,
                                        temp1=temp1, temp2=temp2, agg="max")
