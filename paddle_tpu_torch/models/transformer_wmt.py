"""Transformer-base WMT en-de (counterpart of
paddle_tpu/models/transformer_wmt.py, BASELINE.json configs[2]): the
encoder-decoder with scaled word embeddings and sinusoidal positions,
pre-norm layers, label-smoothed cross entropy and the Noam schedule.

The layers are nn.Transformer's, so attention runs the flash kernels
(encoder self-attention and decoder cross-attention, the decode steps'
attention over the caches) or the dense path (the decoder's causal
self-attention in a full forward), and the FFN `fused_ffn`.  Parameter
and buffer names and shapes match paddle_tpu's one to one, so
`convert.load_jax_state` carries a JAX model's state over and
`convert.load_jax_train_state` a JAX train state.

Weights are made on the CPU in float32 from a torch.Generator seeded
with `seed`, then moved to `device` (default cuda; raises without CUDA
unless device="cpu") and cast to `dtype`.

Decoding (`greedy_decode`, `beam_decode`) runs step by step over the
layers' KV caches: each step's self-attention appends one key to its
layer's cache, cross-attention reads the memory's projected keys.
`build_train_step` is the train step: forward on a bf16 cast of fp32
masters, smoothed cross entropy, backward and Adam at the Noam rate.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import device as _device
from ..jit import functional_call, functional_state
from ..nn import Dropout, Embedding, Linear, Transformer
from ..nn import functional as F
from ..nn.initializer import Normal
from ..ops.rnn_ops import dense_beam_backtrack, dense_beam_step
from .bert import _place, _step_seed, _to_device


class TransformerConfig:
    def __init__(self, src_vocab_size=30000, tgt_vocab_size=30000,
                 max_length=256, d_model=512, n_head=8, num_encoder_layers=6,
                 num_decoder_layers=6, d_inner_hid=2048, dropout=0.1,
                 label_smooth_eps=0.1, bos_id=0, eos_id=1):
        self.src_vocab_size = src_vocab_size
        self.tgt_vocab_size = tgt_vocab_size
        self.max_length = max_length
        self.d_model = d_model
        self.n_head = n_head
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        self.d_inner_hid = d_inner_hid
        self.dropout = dropout
        self.label_smooth_eps = label_smooth_eps
        self.bos_id = bos_id
        self.eos_id = eos_id

    @staticmethod
    def base(**kw):
        return TransformerConfig(**kw)

    @staticmethod
    def tiny(**kw):
        d = dict(src_vocab_size=1000, tgt_vocab_size=1000, max_length=64,
                 d_model=64, n_head=4, num_encoder_layers=2,
                 num_decoder_layers=2, d_inner_hid=128)
        d.update(kw)
        return TransformerConfig(**d)


def sinusoid_position_encoding(max_len, d_model):
    pos = np.arange(max_len)[:, None].astype("float32")
    i = np.arange(d_model)[None, :].astype("float32")
    angle = pos / np.power(10000.0, 2 * (i // 2) / d_model)
    enc = np.zeros((max_len, d_model), "float32")
    enc[:, 0::2] = np.sin(angle[:, 0::2])
    enc[:, 1::2] = np.cos(angle[:, 1::2])
    return enc


class WordEmbedding(nn.Module):
    """Embedding drawn from Normal(0, d_model^-0.5), output scaled by
    d_model^0.5."""

    def __init__(self, vocab_size, d_model, generator=None):
        super().__init__()
        self.emb = Embedding(vocab_size, d_model,
                             weight_init=Normal(0.0, d_model ** -0.5),
                             generator=generator)
        self.d_model = d_model

    def forward(self, ids):
        return self.emb(ids) * self.d_model ** 0.5


class PositionalEncoding(nn.Module):
    """x + the sinusoid table's rows offset..offset+seq, then dropout.
    The table is a (non-persistent) buffer, as in paddle_tpu, so it is
    part of `functional_state` and of the train step's state."""

    def __init__(self, max_len, d_model, dropout, generator=None):
        super().__init__()
        self.register_buffer(
            "pe", torch.from_numpy(sinusoid_position_encoding(max_len,
                                                              d_model)),
            persistent=False)
        self.dropout = Dropout(dropout, generator=generator)

    def forward(self, x, offset=0):
        return self.dropout(x + self.pe[offset:offset + x.shape[1]][None])


class WMTTransformer(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None,
                 dtype: Optional[torch.dtype] = None, seed: int = 0):
        super().__init__()
        generator = torch.Generator().manual_seed(seed)
        self.config = cfg
        self.src_emb = WordEmbedding(cfg.src_vocab_size, cfg.d_model,
                                     generator)
        self.tgt_emb = WordEmbedding(cfg.tgt_vocab_size, cfg.d_model,
                                     generator)
        self.src_pos = PositionalEncoding(cfg.max_length, cfg.d_model,
                                          cfg.dropout, generator)
        self.tgt_pos = PositionalEncoding(cfg.max_length, cfg.d_model,
                                          cfg.dropout, generator)
        self.transformer = Transformer(
            d_model=cfg.d_model, nhead=cfg.n_head,
            num_encoder_layers=cfg.num_encoder_layers,
            num_decoder_layers=cfg.num_decoder_layers,
            dim_feedforward=cfg.d_inner_hid, dropout=cfg.dropout,
            activation="relu", normalize_before=True, generator=generator)
        self.out_proj = Linear(cfg.d_model, cfg.tgt_vocab_size,
                               generator=generator)
        _place(self, device, dtype)

    def forward(self, src_ids, tgt_ids, src_pad_mask=None):
        """src_ids (B, S), tgt_ids (B, T) -> logits (B, T, V).  The
        decoder's self-attention mask is causal; `src_pad_mask` is an
        additive (B, 1, 1, S) float mask or None."""
        memory_in = self.src_pos(self.src_emb(src_ids))
        tgt_in = self.tgt_pos(self.tgt_emb(tgt_ids))
        causal = Transformer.generate_square_subsequent_mask(
            tgt_ids.shape[1], device=tgt_ids.device)
        memory = self.transformer.encoder(memory_in, src_pad_mask)
        dec = self.transformer.decoder(tgt_in, memory, causal[None, None],
                                       src_pad_mask)
        return self.out_proj(dec)

    def _encode(self, src_ids):
        return self.transformer.encoder(self.src_pos(self.src_emb(src_ids)))

    def _decode_step(self, ids, step, memory, cache):
        """Logits (rows, 1, V) of one decode step and the grown caches."""
        tgt_in = self.tgt_pos(self.tgt_emb(ids), offset=step)
        dec, cache = self.transformer.decoder(tgt_in, memory, None, None,
                                              cache)
        return self.out_proj(dec), cache

    @torch.no_grad()
    def greedy_decode(self, src_ids, max_len=32):
        """(B, max_len) tokens: from BOS, each step's argmax over the last
        position's logits, decoded incrementally over the layers' KV
        caches.  Nothing is read back to the host."""
        memory = self._encode(src_ids)
        ids = torch.full((src_ids.shape[0], 1), self.config.bos_id,
                         dtype=torch.int64, device=src_ids.device)
        cache = self.transformer.decoder.gen_cache(memory)
        outs = []
        for step in range(max_len):
            logits, cache = self._decode_step(ids, step, memory, cache)
            ids = logits[:, -1].argmax(dim=-1, keepdim=True)
            outs.append(ids)
        return torch.cat(outs, dim=1)

    @staticmethod
    def _tree_reorder(cache, parent):
        """Every tensor leaf of a (nested list/tuple/namedtuple) cache with
        its batch rows taken in `parent` order."""
        if isinstance(cache, torch.Tensor):
            return cache.index_select(0, parent)
        if isinstance(cache, (list, tuple)):
            mapped = [WMTTransformer._tree_reorder(c, parent) for c in cache]
            if hasattr(cache, "_fields"):  # a namedtuple (Cache)
                return type(cache)(*mapped)
            return type(cache)(mapped)
        return cache

    @torch.no_grad()
    def beam_decode(self, src_ids, beam_size=4, max_len=32):
        """Beam search in the dense layout: the beams of a source ride the
        batch dim (B*W rows over the memory repeated W times), beam 0
        starts live at score 0 and the others at -1e9, each step is one
        `dense_beam_step` over the log-softmax (f32) of the W*V
        candidates, every cache leaf (the cross-attention's static caches
        too, as paddle_tpu does) is reordered by the parents, and the
        tokens are backtracked with `dense_beam_backtrack`.  Returns
        (sequences (B, W, max_len) best first, scores (B, W))."""
        cfg, w, batch = self.config, beam_size, src_ids.shape[0]
        dev = src_ids.device
        memory = self._encode(src_ids)
        memory = memory[:, None].expand(batch, w, *memory.shape[1:]).reshape(
            batch * w, *memory.shape[1:])  # each source's row W times
        cache = self.transformer.decoder.gen_cache(memory)
        ids = torch.full((batch * w, 1), cfg.bos_id, dtype=torch.int64,
                         device=dev)
        scores = torch.full((batch * w, 1), -1e9, dtype=torch.float32,
                            device=dev)
        scores[::w] = 0.0
        step_ids, step_parents = [], []
        for step in range(max_len):
            logits, cache = self._decode_step(ids, step, memory, cache)
            lp = torch.log_softmax(logits[:, -1].float(), dim=-1)
            ids, scores, parent = dense_beam_step(ids, scores, None, lp, w,
                                                  cfg.eos_id)
            cache = self._tree_reorder(cache, parent)
            step_ids.append(ids[:, 0])
            step_parents.append(parent)
        seqs = dense_beam_backtrack(torch.stack(step_ids),
                                    torch.stack(step_parents))
        return seqs.reshape(batch, w, max_len), scores[:, 0].reshape(batch, w)


def smoothed_cross_entropy(logits, labels, eps, vocab):
    """Mean over tokens of -sum_v smooth_v * log_softmax(logits)_v, with
    smooth = (1 - eps) * one_hot(labels) + eps / vocab, in f32: (1 - eps)
    times the label's -log p plus eps times the mean -log p over the
    vocabulary, the same sum without the (tokens, vocab) one-hot."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return ((1.0 - eps) * nll - eps * logp.mean(dim=-1)).mean()


def noam_lr(d_model, warmup_steps, t):
    """d_model^-0.5 * min(t^-0.5, t * warmup^-1.5), a host float."""
    return d_model ** -0.5 * min(t ** -0.5, t * warmup_steps ** -1.5)


_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.997, 1e-9
_DROPOUT_KEY = 21  # paddle_tpu folds PRNGKey(21) with the step count


def build_train_step(model: WMTTransformer, lr_d_model=None,
                     warmup_steps=4000, bf16=True, device=None, mesh=None):
    """The WMT train step: forward, smoothed cross entropy, backward and
    Adam at the Noam rate.

    Returns (step_fn, state), with
      state = {"params", "m", "v", "t"}: fp32 masters and Adam moments by
      name for every entry of `functional_state(model)` (the two position
      tables `src_pos.pe` and `tgt_pos.pe` included: paddle_tpu's state
      holds them, so its Adam trains them, and so does this one), and the
      step count t, a host int;
      step_fn(state, batch) -> (state, loss).
    `batch` holds fake_batch's keys ("src", "tgt_in", "tgt_out") as numpy
    arrays or tensors.  `loss` is a 0-d tensor on the device: nothing in
    the step reads a device value back.  The step UPDATES `state` IN
    PLACE and returns it; the model's own weights are never touched.

    With `bf16`, the forward runs on a bf16 cast of the masters.  The
    loss is `smoothed_cross_entropy` at the config's label_smooth_eps.
    The rate is `noam_lr(lr_d_model or d_model, warmup_steps, t)`.  Adam
    is paddle_tpu's: b1 0.9, b2 0.997, eps 1e-9, bias correction by t,
    no weight decay.  Dropout draws from `rng_scope(seed(21, t))`, so a
    step is deterministic in t.  The model runs in its current mode.

    `device`: where the state lives (default: the model's device).
    `mesh` (data parallelism) is not ported yet and raises
    NotImplementedError."""
    if mesh is not None:
        raise NotImplementedError("build_train_step: mesh not ported yet")
    cfg = model.config
    d_model = lr_d_model or cfg.d_model
    dev = (next(model.parameters()).device if device is None
           else _device.resolve(device))
    params = {k: v.to(dev, torch.float32, copy=True)
              for k, v in functional_state(model).items()}
    names = list(params)
    state = {"params": params,
             "m": {k: torch.zeros_like(v) for k, v in params.items()},
             "v": {k: torch.zeros_like(v) for k, v in params.items()},
             "t": 0}

    def loss_fn(masters, batch):
        cast = {k: v.to(torch.bfloat16) if bf16 and v.dtype == torch.float32
                else v for k, v in masters.items()}
        logits, _ = functional_call(model, cast, batch["src"],
                                    batch["tgt_in"])
        return smoothed_cross_entropy(logits, batch["tgt_out"],
                                      cfg.label_smooth_eps,
                                      cfg.tgt_vocab_size)

    def step_fn(state, batch):
        t = state["t"] + 1
        lr = noam_lr(d_model, warmup_steps, t)
        batch = {k: _to_device(v, dev) for k, v in batch.items()}
        leaves = [state["params"][k].detach().requires_grad_(True)
                  for k in names]
        with F.rng_scope(_step_seed(_DROPOUT_KEY, t)):
            loss = loss_fn(dict(zip(names, leaves)), batch)
        grads = [g.float() for g in torch.autograd.grad(loss, leaves)]
        p, m, v = ([state[s][k] for k in names] for s in ("params", "m", "v"))
        with torch.no_grad():
            torch._foreach_mul_(m, _ADAM_B1)
            torch._foreach_add_(m, grads, alpha=1 - _ADAM_B1)
            torch._foreach_mul_(v, _ADAM_B2)
            torch._foreach_addcmul_(v, grads, grads, value=1 - _ADAM_B2)
            denom = torch._foreach_div(v, 1 - _ADAM_B2 ** t)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, _ADAM_EPS)
            upd = torch._foreach_div(m, 1 - _ADAM_B1 ** t)
            torch._foreach_div_(upd, denom)
            torch._foreach_mul_(upd, lr)
            torch._foreach_sub_(p, upd)
        state["t"] = t
        return state, loss.detach()

    return step_fn, state


def fake_batch(cfg, batch_size, src_len, tgt_len, seed=0):
    """Random token batch (the same numpy draws as paddle_tpu's
    fake_batch): tgt_in and tgt_out are one sequence shifted by one."""
    rng = np.random.RandomState(seed)
    tgt = rng.randint(2, cfg.tgt_vocab_size, (batch_size, tgt_len + 1))
    return {
        "src": rng.randint(2, cfg.src_vocab_size,
                           (batch_size, src_len)).astype("int64"),
        "tgt_in": tgt[:, :-1].astype("int64"),
        "tgt_out": tgt[:, 1:].astype("int64"),
    }
