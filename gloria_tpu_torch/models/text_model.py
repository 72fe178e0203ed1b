"""Text encoder: BERT + last-n-layer aggregation + word-level pooling.

Port of ``gloria_tpu.models.text_model.TextEncoder``.  The layer sum, the
token→word aggregation and the sentence mean are all linear, so the word
embeddings are one assignment product on the summed hidden states.

Parity notes:
- the sentence embedding is the mean over the *static* word axis, zero rows
  of padded words included;
- with ``agg_tokens=False`` the per-token states are used directly;
- ``last_n_layers == 1`` returns the final layer states and the tanh pooler
  output.

``dtype`` is BERT's compute dtype (JAX ``text_model.py:51``); BERT hands
its hidden states out in f32, so the layer sum, the word aggregation and
the sentence mean run in f32 on states rounded to ``dtype``
(``text_model.py:55-69``, ``ops/segment.py:76-79``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.segment import aggregate_embeddings
from .bert import BertConfig, BertModel


class TextEncoder(nn.Module):
    def __init__(self, bert_config: BertConfig, last_n_layers: int = 4,
                 aggregate_method: str = "sum", norm: bool = False, agg_tokens: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if aggregate_method not in ("sum", "mean"):
            raise ValueError(f"aggregation method not implemented: {aggregate_method}")
        self.model = BertModel(bert_config, dtype=dtype)
        self.last_n_layers = last_n_layers
        self.aggregate_method = aggregate_method
        self.norm = norm
        self.agg_tokens = agg_tokens

    def forward(self, caption_ids, attention_mask, token_type_ids, word_assignment=None,
                generator=None):
        """[B, T] ids/masks (+ [B, W, T] assignment) → (word_emb [B, W, D],
        sent_emb [B, D]).  ``generator`` feeds BERT's train-mode dropout."""
        seq, pooled, states = self.model(caption_ids, attention_mask, token_type_ids, generator)
        if self.last_n_layers > 1:
            h = states[-self.last_n_layers:]
            h = h.sum(0) if self.aggregate_method == "sum" else h.mean(0)
            if self.agg_tokens:
                if word_assignment is None:
                    raise ValueError("agg_tokens=True requires a word_assignment matrix")
                word_emb = aggregate_embeddings(h, word_assignment)
            else:
                word_emb = h
            sent_emb = word_emb.mean(dim=1)
        else:
            word_emb, sent_emb = seq, pooled
        if self.norm:
            word_emb = word_emb / torch.linalg.vector_norm(word_emb, dim=-1, keepdim=True)
            sent_emb = sent_emb / torch.linalg.vector_norm(sent_emb, dim=-1, keepdim=True)
        return word_emb, sent_emb
