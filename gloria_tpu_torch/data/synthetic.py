"""Synthetic batches for development, benchmarks and the chip smoke test.

The port's own copy of ``gloria_tpu.data.synthetic``: the batch structure
the real collate emits (images NHWC, tokenized captions with
word-assignment matrices and cap_lens) from numpy-seeded random data, so
the card and the CPU tests feed the same batches to both packages.  Arrays
are numpy; the train step moves them to its device.
"""

from __future__ import annotations

import numpy as np


def make_synthetic_batch(
    batch_size: int = 8,
    num_tokens: int = 97,
    imsize: int = 224,
    vocab_size: int = 28996,
    seed: int = 0,
    with_segmentation: bool = False,
) -> dict:
    rng = np.random.RandomState(seed)
    low = min(1000, max(1, vocab_size // 2))
    ids = rng.randint(low, vocab_size, size=(batch_size, num_tokens)).astype(np.int32)
    lengths = rng.randint(num_tokens // 3, num_tokens - 2, size=batch_size)

    attention_mask = np.zeros((batch_size, num_tokens), np.int32)
    assignment = np.zeros((batch_size, num_tokens, num_tokens), np.float32)
    cap_lens = np.zeros(batch_size, np.int32)
    for b, L in enumerate(lengths):
        attention_mask[b, : L + 2] = 1  # [CLS] + words + [SEP]
        # simple grouping: every other token pair fuses into one word
        out = 0
        t = 0
        while t < L + 2 and out < num_tokens:
            span = 1 if (t == 0 or t == L + 1 or t % 3) else 2
            assignment[b, out, t : min(t + span, L + 2)] = 1.0
            t += span
            out += 1
        cap_lens[b] = out - 1  # non-special words ([CLS]+words+[SEP] → words+1)

    batch = {
        "imgs": rng.randn(batch_size, imsize, imsize, 3).astype(np.float32),
        "caption_ids": ids,
        "attention_mask": attention_mask,
        "token_type_ids": np.zeros((batch_size, num_tokens), np.int32),
        "word_assignment": assignment,
        "cap_lens": cap_lens,
    }
    if with_segmentation:
        seg = np.zeros((batch_size, imsize, imsize), np.float32)
        seg[:, imsize // 4 : imsize // 2, imsize // 4 : imsize // 2] = 1.0
        batch["segmentation_labels"] = seg
    return batch
