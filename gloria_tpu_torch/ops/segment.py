"""WordPiece→word aggregation as a fixed-shape assignment product.

The grouping of subword tokens into words is a pure function of the token
strings, so the host builds a 0/1 assignment matrix ``A ∈ [num_words,
num_tokens]`` at tokenize time and the device reduces it to one batched
matrix product: ``word_emb = A @ token_emb``.

Semantics (same as ``gloria_tpu.ops.segment``):
- groups are flushed when a new non-"##" token arrives or at ``[SEP]``;
- the ``[SEP]`` embedding itself is appended as its own output row;
- iteration stops at the first ``[SEP]``; if truncation removed it, the
  trailing open group is dropped;
- output rows beyond the last word are zero ("[PAD]" words).
"""

from __future__ import annotations

import numpy as np
import torch


def build_word_assignment(tokens: list[str], num_words: int) -> tuple[np.ndarray, list[str], int]:
    """Host-side: token strings → (assignment [num_words, T], words, cap_len).

    ``cap_len`` is the count of words not starting with "[" plus one."""
    T = len(tokens)
    assign = np.zeros((num_words, T), dtype=np.float32)
    words: list[str] = []
    group: list[int] = []
    group_str: list[str] = []

    def flush():
        if group and len(words) < num_words:
            assign[len(words), group] = 1.0
            words.append("".join(group_str))

    for t, tok in enumerate(tokens):
        if tok == "[SEP]":
            flush()
            if len(words) < num_words:
                assign[len(words), t] = 1.0
                words.append(tok)
            break
        if tok.startswith("##"):
            group.append(t)
            group_str.append(tok[2:])
        else:
            flush()
            group = [t]
            group_str = [tok]

    cap_len = sum(1 for w in words if not w.startswith("[")) + 1
    padded_words = words + ["[PAD]"] * (num_words - len(words))
    return assign, padded_words, cap_len


def build_batch_assignment(batch_tokens: list[list[str]], num_words: int):
    """List of token lists → stacked assignment [B, num_words, T], word
    strings, cap_lens [B]."""
    assigns, words, lens = [], [], []
    for toks in batch_tokens:
        a, w, n = build_word_assignment(toks, num_words)
        assigns.append(a)
        words.append(w)
        lens.append(n)
    return np.stack(assigns), words, np.asarray(lens, dtype=np.int32)


def aggregate_embeddings(token_emb: torch.Tensor, assignment: torch.Tensor) -> torch.Tensor:
    """[B, T, D] tokens × [B, W, T] assignment → [B, W, D] (f32)."""
    return torch.bmm(assignment.float(), token_emb.float())
