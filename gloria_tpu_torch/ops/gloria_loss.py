"""GLoRIA matching: the word mask, global cosine, local similarities, losses.

Port of ``gloria_tpu.ops.gloria_loss``: the eval similarities, the aligned
:func:`attention_fn`, and the pretraining losses :func:`local_loss` (the
InfoNCE pair and the no-attention term) and :func:`global_loss`.  The
flat-attention ablation losses (symmetric KL, entropy) are not ported yet.

Device policy: the O(B²) similarity matrix of :func:`local_similarities_eval`
and :func:`local_loss` goes through the hand-written kernels of
:mod:`.local_sim` on a CUDA tensor (forward K1, backward K2) and through
their plain versions on a CPU tensor, whatever ``model.gloria.fused_kernel``
says: the port has no other route.  :func:`local_loss` therefore computes
the fused form of the JAX ``local_loss(use_fused=True)``: the diagonal
attention maps and the no-attention mass come from the O(B) aligned
:func:`attention_fn`.

Precision: :func:`local_loss` casts the words and regions to f32 where the
JAX ``local_matching`` does (``gloria_loss.py:183-184``), and everything
after that cast runs in f32, whatever the model's compute dtype.  JAX then
stores the O(B²) intermediates (``raw``, the two softmaxes, ``dot``,
``wctx_norm2``) in the model's dtype (``compute_dtype``, ``:188-224``); the
port keeps the kernels on f32 operands instead (a deliberate difference,
ROADMAP.md §C, bounded in ``tests/test_torch_port_bf16.py``).
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


def attention_fn(words: torch.Tensor, regions: torch.Tensor, temp1: float,
                 word_mask: torch.Tensor | None = None,
                 sink: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Aligned-batch double-softmax attention of words [B, W, D] over regions
    [B, R, D] (the sink, if any, prepended as region 0).  Returns
    (weighted context [B, W, D], attention [B, W, R] without the sink column)."""
    ctx = prepend_sink(regions, sink) if sink is not None else regions
    raw = ctx @ words.transpose(1, 2)                                 # [B, S, W]
    if word_mask is not None:
        m = word_mask[:, None, :]
        a1 = torch.softmax(raw.masked_fill(~m, torch.finfo(raw.dtype).min), dim=-1)
        a1 = a1.masked_fill(~m, 0.0)
    else:
        a1 = torch.softmax(raw, dim=-1)
    a2 = torch.softmax(temp1 * a1.transpose(1, 2), dim=-1)           # [B, W, S]
    weighted = a2 @ ctx
    return weighted, (a2[:, :, 1:] if sink is not None else a2)


def _diag_cross_entropy(logits: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy with labels arange(n)."""
    return (torch.logsumexp(logits, dim=-1) - logits.diagonal()).mean()


def local_loss(img_regions: torch.Tensor, words: torch.Tensor, cap_lens: torch.Tensor, *,
               temp1: float = 4.0, temp2: float = 5.0, temp3: float = 10.0, agg: str = "sum",
               sink: torch.Tensor | None = None, no_attn_loss_weight: float | None = None):
    """Local InfoNCE over the batch similarity matrix.

    img_regions [B, R, D], words [B, W, D], cap_lens [B] (train word slice
    ``[0, cap_len)``).  Returns (loss0, loss1, no_attn_loss, attn [B, W, R]):
    image→text and text→image cross-entropies of ``temp3 · sims``, the
    weighted mean log sink mass of the diagonal pairs (0.0 without
    ``no_attn_loss_weight``), and the diagonal attention maps."""
    # JAX gloria_loss.py:183-184: words and regions in (at least) f32; the
    # gradient flows back through this cast to embeddings of a reduced dtype
    words, img_regions = (t.to(torch.promote_types(t.dtype, torch.float32))
                          for t in (words, img_regions))
    mask = make_word_mask(cap_lens.to(words.device), words.shape[1], "train")
    ctx = prepend_sink(img_regions, sink) if sink is not None else img_regions
    sims = local_sim.fused_local_similarities(words, ctx, mask, temp1, temp2, agg)  # [B, T]
    _, attn = attention_fn(words, img_regions, temp1, word_mask=mask, sink=sink)
    logits = sims * temp3
    loss0 = _diag_cross_entropy(logits)      # image -> text
    loss1 = _diag_cross_entropy(logits.T)    # text -> image
    no_attn_loss = 0.0
    if no_attn_loss_weight is not None:
        n_valid = mask.sum(-1).clamp_min(1)
        region_mass = torch.where(mask, attn.sum(-1), 0.0).sum(-1) / n_valid
        no_attn_loss = no_attn_loss_weight * torch.log((1.0 - region_mass).clamp_min(EPS)).mean()
    return loss0, loss1, no_attn_loss, attn


def global_loss(img_emb: torch.Tensor, txt_emb: torch.Tensor, temp3: float = 10.0,
                eps: float = EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric InfoNCE over the global cosine-similarity matrix (rows = images)."""
    img, txt = img_emb.float(), txt_emb.float()
    norms = (torch.linalg.vector_norm(img, dim=-1)[:, None]
             * torch.linalg.vector_norm(txt, dim=-1)[None, :])
    logits = (img @ txt.T) / norms.clamp_min(eps) * temp3
    return _diag_cross_entropy(logits), _diag_cross_entropy(logits.T)


def local_similarities_eval_diag(img_regions: torch.Tensor, words: torch.Tensor,
                                 cap_lens: torch.Tensor, *, temp1: float = 4.0,
                                 temp2: float = 5.0,
                                 sink: torch.Tensor | None = None) -> torch.Tensor:
    """The diagonal of :func:`local_similarities_eval` [B] from one aligned
    :func:`attention_fn` pass (eval word slice, max over words)."""
    mask = make_word_mask(cap_lens.to(words.device), words.shape[1], "eval")
    words = words.float()
    weighted, _ = attention_fn(words, img_regions.float(), temp1, word_mask=mask, sink=sink)
    dot = (words * weighted).sum(-1)
    wn = words.square().sum(-1).clamp_min(1e-12).sqrt()
    cn = weighted.square().sum(-1).clamp_min(1e-12).sqrt()
    cos = torch.where(mask, dot / (wn * cn).clamp_min(EPS), 0.0)
    e = torch.where(mask, torch.exp(temp2 * cos), 0.0)
    return e.amax(-1).clamp_min(EPS).log()
