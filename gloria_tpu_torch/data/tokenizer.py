"""Report text pipeline: sentence cleanup + WordPiece tokenization.

The port's own copy of ``gloria_tpu.data.tokenizer``: the reference's
report cleanup (numbered-item splitting, word tokenization, ascii filter,
≤1-token sentence dropping) and a self-contained HF-BERT WordPiece encoder
(greedy longest match with ``##`` continuations).  A real vocab file gives
the same ids as HF's tokenizer.  ``transformers`` is imported only inside
:func:`load_tokenizer`, and only when a ``bert_type`` is given.

The output holds everything the device program needs precomputed: token
ids, masks, the word-assignment matrix (see :mod:`..ops.segment`), word
strings and cap_lens.
"""

from __future__ import annotations

import os
import re
import unicodedata
from pathlib import Path

import numpy as np

from ..ops.segment import build_batch_assignment

_NUMBERED_ITEM = re.compile(r"[0-9]+\.")
_WORD = re.compile(r"\w+")

SPECIAL_TOKENS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


def clean_report(text: str) -> str:
    """Reference report cleanup (gloria_model.py:239-266): numbered-item and
    period sentence split, \\w+ lowercase tokenization, ascii filter, drop
    sentences with ≤1 token, re-join with spaces."""
    text = text.replace("\n", " ")
    captions = []
    for point in _NUMBERED_ITEM.split(text):
        captions.extend(point.split("."))
    sents = []
    for cap in captions:
        cap = cap.replace("��", " ")
        tokens = _WORD.findall(cap.lower())
        if len(tokens) <= 1:
            continue
        kept = []
        for tok in tokens:
            tok = tok.encode("ascii", "ignore").decode("ascii")
            if tok:
                kept.append(tok)
        sents.append(" ".join(kept))
    return " ".join(sents)


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False  # treated as whitespace
    return unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_cjk(cp: int) -> bool:
    # the CJK Unified Ideograph blocks BERT treats as standalone "words"
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def basic_tokenize(text: str, lower: bool = False) -> list[str]:
    """HF BasicTokenizer-equivalent: invalid/control-char cleanup, CJK chars
    split out as standalone tokens, whitespace split, punctuation split.

    ``lower=True`` also strips accents, matching HF's coupling of
    ``strip_accents`` to ``do_lower_case`` (BertTokenizer default)."""
    cleaned = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue  # NUL / replacement / control & format chars vanish
        if _is_cjk(cp):
            cleaned.append(f" {ch} ")  # each ideograph is its own word
        elif _is_whitespace(ch):
            cleaned.append(" ")
        else:
            cleaned.append(ch)
    text = "".join(cleaned)
    if lower:
        text = unicodedata.normalize("NFD", text.lower())
        text = "".join(ch for ch in text if unicodedata.category(ch) != "Mn")
    out: list[str] = []
    for tok in text.strip().split():
        current = []
        for ch in tok:
            if _is_punctuation(ch):
                if current:
                    out.append("".join(current))
                    current = []
                out.append(ch)
            else:
                current.append(ch)
        if current:
            out.append("".join(current))
    return out


class WordPieceTokenizer:
    """Greedy longest-match WordPiece (HF ``BertTokenizer`` algorithm)."""

    def __init__(self, vocab: dict[str, int] | list[str], lower: bool = False,
                 max_chars_per_word: int = 100):
        if isinstance(vocab, list):
            vocab = {tok: i for i, tok in enumerate(vocab)}
        self.vocab = vocab
        self.ids_to_tokens = {i: t for t, i in vocab.items()}
        self.lower = lower
        self.max_chars = max_chars_per_word
        for tok in SPECIAL_TOKENS:
            if tok not in vocab:
                raise ValueError(f"vocab missing special token {tok}")
        self.pad_id = vocab["[PAD]"]
        self.unk_id = vocab["[UNK]"]
        self.cls_id = vocab["[CLS]"]
        self.sep_id = vocab["[SEP]"]

    # -- construction --------------------------------------------------------
    @classmethod
    def from_vocab_file(cls, path: str | Path, lower: bool = False) -> "WordPieceTokenizer":
        tokens = [line.rstrip("\n") for line in open(path, encoding="utf-8")]
        return cls(tokens, lower=lower)

    @classmethod
    def from_corpus(cls, texts: list[str], lower: bool = True) -> "WordPieceTokenizer":
        """Tiny whole-word + character vocab for hermetic development/tests."""
        words: set[str] = set()
        chars: set[str] = set()
        for t in texts:
            for w in basic_tokenize(t, lower=lower):
                words.add(w)
                chars.update(w)
        vocab = list(SPECIAL_TOKENS) + sorted(words) + sorted(chars) + ["##" + c for c in sorted(chars)]
        seen, uniq = set(), []
        for tok in vocab:
            if tok not in seen:
                seen.add(tok)
                uniq.append(tok)
        return cls(uniq, lower=lower)

    # -- tokenization ----------------------------------------------------------
    def wordpiece(self, word: str) -> list[str]:
        if len(word) > self.max_chars:
            return ["[UNK]"]
        out = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = piece
                    break
                end -= 1
            if cur is None:
                return ["[UNK]"]
            out.append(cur)
            start = end
        return out

    def tokenize(self, text: str) -> list[str]:
        toks = []
        for word in basic_tokenize(text, lower=self.lower):
            toks.extend(self.wordpiece(word))
        return toks

    def convert_tokens_to_ids(self, tokens: list[str]) -> list[int]:
        return [self.vocab.get(t, self.unk_id) for t in tokens]

    def encode(self, text: str, max_length: int) -> dict:
        """HF-style: [CLS] tokens [SEP], truncated then padded to max_length."""
        toks = self.tokenize(text)[: max_length - 2]
        tokens = ["[CLS]"] + toks + ["[SEP]"]
        ids = self.convert_tokens_to_ids(tokens)
        attn = [1] * len(ids)
        pad = max_length - len(ids)
        tokens = tokens + ["[PAD]"] * pad
        ids = ids + [self.pad_id] * pad
        attn = attn + [0] * pad
        return {
            "input_ids": np.asarray(ids, np.int32),
            "attention_mask": np.asarray(attn, np.int32),
            "token_type_ids": np.zeros(max_length, np.int32),
            "tokens": tokens,
        }

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)


def load_tokenizer(bert_type: str | None = None, vocab_file: str | None = None,
                   corpus: list[str] | None = None, lower: bool = False) -> WordPieceTokenizer:
    """Resolve a tokenizer: explicit vocab file → HF cache for ``bert_type`` →
    corpus-built fallback."""
    if vocab_file and os.path.exists(vocab_file):
        return WordPieceTokenizer.from_vocab_file(vocab_file, lower=lower)
    if bert_type:
        try:  # only when transformers is installed and its cache has the files
            from transformers import AutoTokenizer

            hf = AutoTokenizer.from_pretrained(bert_type, local_files_only=True)
            return WordPieceTokenizer(dict(hf.get_vocab()), lower=lower)
        except (ImportError, OSError, ValueError):
            pass
    if corpus is not None:
        return WordPieceTokenizer.from_corpus(corpus, lower=True)
    raise ValueError("no tokenizer source available (vocab_file / HF cache / corpus)")


class TextProcessor:
    """Batch text → model-ready arrays (the text half of the reference's
    ``GloriaCollateFn.process_text``, ``mimic_for_gloria.py:184-263``)."""

    def __init__(self, tokenizer: WordPieceTokenizer, num_words: int = 97, clean: bool = True):
        self.tokenizer = tokenizer
        self.num_words = num_words
        self.clean = clean

    def __call__(self, texts: list[str]) -> dict:
        enc = [self.tokenizer.encode(clean_report(t) if self.clean else t, self.num_words) for t in texts]
        assignment, words, cap_lens = build_batch_assignment([e["tokens"] for e in enc], self.num_words)
        return {
            "caption_ids": np.stack([e["input_ids"] for e in enc]),
            "attention_mask": np.stack([e["attention_mask"] for e in enc]),
            "token_type_ids": np.stack([e["token_type_ids"] for e in enc]),
            "word_assignment": assignment,
            "cap_lens": cap_lens,
            "words": words,
        }
