"""BERT encoder with HF ``BertModel``'s module names and all hidden states.

Port of ``gloria_tpu.models.bert``: exact (erf) GELU, LayerNorm eps 1e-12,
an additive ``finfo(float32).min`` attention mask in f32, and every hidden
state returned, the embedding output included, as one stacked tensor
``[L+1, B, T, D]``.  Module names follow HF (``embeddings.LayerNorm``,
``encoder.layer.{i}.attention.self.query``) so reference state dicts load as
they are; ``embeddings.position_ids`` is the persistent buffer that the
reference's transformers pin writes into its checkpoints.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 28996  # Bio_ClinicalBERT inherits the BERT-base-cased vocab
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dropout_rate: float = 0.1  # kept for config compatibility; the port runs eval only
    pad_token_id: int = 0


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.register_buffer(
            "position_ids", torch.arange(cfg.max_position_embeddings)[None, :], persistent=True)

    def forward(self, input_ids, token_type_ids):
        T = input_ids.shape[1]
        h = (self.word_embeddings(input_ids)
             + self.position_embeddings(self.position_ids[:, :T])
             + self.token_type_embeddings(token_type_ids))
        return self.LayerNorm(h)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.query = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.key = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.value = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, hidden, attn_bias):
        B, T, D = hidden.shape
        H, hd = self.num_heads, D // self.num_heads

        def split(x):
            return x.view(B, T, H, hd).transpose(1, 2)

        q, k, v = split(self.query(hidden)), split(self.key(hidden)), split(self.value(hidden))
        scores = q @ k.transpose(-1, -2) / math.sqrt(hd) + attn_bias
        ctx = torch.softmax(scores, dim=-1) @ v
        return ctx.transpose(1, 2).reshape(B, T, D)


class BertSelfOutput(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, residual):
        return self.LayerNorm(self.dense(x) + residual)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertSelfOutput(cfg)

    def forward(self, hidden, attn_bias):
        return self.output(self.self(hidden, attn_bias), hidden)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x):
        return F.gelu(self.dense(x))  # exact (erf) GELU, as HF BERT


class BertOutput(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, residual):
        return self.LayerNorm(self.dense(x) + residual)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg)

    def forward(self, hidden, attn_bias):
        hidden = self.attention(hidden, attn_bias)
        return self.output(self.intermediate(hidden), hidden)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_layers))


class BertPooler(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, seq):
        return torch.tanh(self.dense(seq[:, 0]))


class BertModel(nn.Module):
    """Returns (sequence_output [B,T,D], pooled [B,D], hidden_states [L+1,B,T,D])."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)
        self.pooler = BertPooler(cfg)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        hidden = self.embeddings(input_ids, token_type_ids)
        # HF-style additive attention bias in f32
        attn_bias = ((1.0 - attention_mask[:, None, None, :].float())
                     * torch.finfo(torch.float32).min)
        states = [hidden]
        for layer in self.encoder.layer:
            hidden = layer(hidden, attn_bias)
            states.append(hidden)
        return hidden, self.pooler(hidden), torch.stack(states)
