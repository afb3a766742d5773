"""BERT (counterpart of paddle_tpu/models/bert.py), forward only.

The encoder rides nn.TransformerEncoderLayer, whose attention core is the
flash-attention kernel and whose FFN is the fused FFN kernel on the card.
Parameter names and shapes match paddle_tpu's one to one, so
`convert.load_jax_state` can carry a JAX model's weights over.

Weights are made on the CPU in float32 from an explicit torch.Generator
seeded with `seed`, then moved to `device` (default cuda; raises without
CUDA unless device="cpu") and cast to `dtype`.  The pretraining
criterion and train step come with the training slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import device as _device
from ..nn import (GELU, Dropout, Embedding, LayerNorm, Linear, ReLU, Tanh,
                  TransformerEncoder, TransformerEncoderLayer)
from ..nn.initializer import TruncatedNormal


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_act="gelu",
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=2,
                 initializer_range=0.02, moe_experts=0):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.initializer_range = initializer_range
        # 0 = dense FFN; Switch-MoE encoders are not ported yet
        self.moe_experts = moe_experts

    @staticmethod
    def base(**kw):
        return BertConfig(**kw)

    @staticmethod
    def tiny(**kw):
        """For tests / CPU dry runs."""
        d = dict(vocab_size=1024, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=128,
                 max_position_embeddings=128)
        d.update(kw)
        return BertConfig(**d)


def _init(cfg):
    return TruncatedNormal(0.0, cfg.initializer_range)


def _place(module: nn.Module, device, dtype) -> nn.Module:
    """Move a freshly built model to its device and dtype; the default
    device is cuda (raising without CUDA)."""
    return module.to(device=_device.resolve(device), dtype=dtype)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, generator=None):
        super().__init__()
        kw = dict(weight_init=_init(cfg), generator=generator)
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **kw)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size, **kw)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size,
                                               cfg.hidden_size, **kw)
        self.layer_norm = LayerNorm(cfg.hidden_size)
        self.dropout = Dropout(cfg.hidden_dropout_prob, generator=generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        s = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(s))


class BertPooler(nn.Module):
    def __init__(self, cfg, generator=None):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size, _init(cfg),
                            generator=generator)
        self.activation = Tanh()

    def forward(self, hidden):
        return self.activation(self.dense(hidden[:, 0]))


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig, device=None,
                 dtype: Optional[torch.dtype] = None, seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if getattr(cfg, "moe_experts", 0):
            raise NotImplementedError(
                "Switch-MoE BERT (moe_experts > 0) is not ported yet")
        top = generator is None
        if top:
            generator = torch.Generator().manual_seed(seed)
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg, generator)
        self.encoder = TransformerEncoder(
            lambda: TransformerEncoderLayer(
                cfg.hidden_size, cfg.num_attention_heads,
                cfg.intermediate_size, dropout=cfg.hidden_dropout_prob,
                activation=cfg.hidden_act,
                attn_dropout=cfg.attention_probs_dropout_prob,
                weight_init=_init(cfg), generator=generator),
            cfg.num_hidden_layers)
        self.pooler = BertPooler(cfg, generator)
        if top:
            _place(self, device, dtype)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        emb = self.embeddings(input_ids, token_type_ids, position_ids)
        encoded = self.encoder(emb, attention_mask)
        pooled = self.pooler(encoded)
        return encoded, pooled


class BertPretrainingHeads(nn.Module):
    """MLM transform + decoder (weight-tied to the word embedding table)
    and NSP classifier."""

    def __init__(self, cfg, embedding_weight: nn.Parameter, generator=None):
        super().__init__()
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size,
                                _init(cfg), generator=generator)
        self.activation = GELU() if cfg.hidden_act == "gelu" else ReLU()
        self.layer_norm = LayerNorm(cfg.hidden_size)
        self.decoder_weight = embedding_weight  # tied: the same Parameter
        self.decoder_bias = nn.Parameter(torch.zeros(cfg.vocab_size))
        self.seq_relationship = Linear(cfg.hidden_size, 2, _init(cfg),
                                       generator=generator)

    def forward(self, encoded, pooled, masked_positions=None):
        x = self.layer_norm(self.activation(self.transform(encoded)))
        if masked_positions is not None:
            # gather only the masked positions: (B, M, H)
            idx = masked_positions.long()[..., None].expand(
                -1, -1, x.shape[-1])
            x = torch.gather(x, 1, idx)
        mlm = torch.matmul(x, self.decoder_weight.t()) + self.decoder_bias
        nsp = self.seq_relationship(pooled)
        return mlm, nsp


class BertForPretraining(nn.Module):
    def __init__(self, cfg: BertConfig, device=None,
                 dtype: Optional[torch.dtype] = None, seed: int = 0):
        super().__init__()
        generator = torch.Generator().manual_seed(seed)
        self.bert = BertModel(cfg, generator=generator)
        self.cls = BertPretrainingHeads(
            cfg, self.bert.embeddings.word_embeddings.weight, generator)
        _place(self, device, dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_positions=None):
        encoded, pooled = self.bert(input_ids, token_type_ids,
                                    attention_mask=attention_mask)
        return self.cls(encoded, pooled, masked_positions)


def fake_batch(cfg, batch_size, seq_len, num_masked=20, seed=0):
    """Random pretraining batch with a variable-length padding mask (the
    same numpy draws as paddle_tpu's fake_batch)."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(max(1, seq_len // 2), seq_len + 1, (batch_size,))
    return {
        "input_ids": rng.randint(0, cfg.vocab_size,
                                 (batch_size, seq_len)).astype("int64"),
        "attention_mask": (np.arange(seq_len)[None, :]
                           < lens[:, None]).astype("int64"),
        "token_type_ids": rng.randint(0, cfg.type_vocab_size,
                                      (batch_size, seq_len)).astype("int64"),
        "masked_positions": np.sort(
            rng.randint(0, seq_len, (batch_size, num_masked)),
            axis=1).astype("int64"),
        "masked_labels": rng.randint(
            0, cfg.vocab_size, (batch_size, num_masked)).astype("int64"),
        "nsp_labels": rng.randint(0, 2, (batch_size,)).astype("int64"),
    }
