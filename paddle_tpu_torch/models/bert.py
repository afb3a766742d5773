"""BERT pretraining (counterpart of paddle_tpu/models/bert.py).

The encoder rides nn.TransformerEncoderLayer, whose attention core is the
flash-attention kernels and whose FFN is the fused FFN kernels on the
card, forward and backward.  Parameter names and shapes match
paddle_tpu's one to one, so `convert.load_jax_state` can carry a JAX
model's weights over, and `convert.load_jax_train_state` a JAX train
state.

Weights are made on the CPU in float32 from an explicit torch.Generator
seeded with `seed`, then moved to `device` (default cuda; raises without
CUDA unless device="cpu") and cast to `dtype`.

`build_pretrain_step` is the train step: forward, backward and AdamW over
fp32 masters, the forward on their bf16 cast.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import device as _device
from ..jit import functional_call, functional_state
from ..nn import (GELU, Dropout, Embedding, LayerNorm, Linear, ReLU, Tanh,
                  TransformerEncoder, TransformerEncoderLayer)
from ..nn import functional as F
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


class BertPretrainingCriterion(nn.Module):
    """Mean masked-LM loss plus mean next-sentence loss, log-softmax in
    f32 whatever the logits' dtype."""

    def __init__(self, vocab_size):
        super().__init__()
        self.vocab_size = vocab_size

    def forward(self, mlm_logits, nsp_logits, masked_labels, nsp_labels):
        def nll(logits, labels):
            lp = torch.log_softmax(logits.float(), dim=-1)
            return -torch.gather(lp, -1, labels.long()[..., None]).mean()

        return nll(mlm_logits, masked_labels) + nll(nsp_logits, nsp_labels)


def bert_step_flops(cfg, batch, seq, n_masked):
    """Model FLOPs of one train step (fwd + bwd ~= 3x fwd cost): the
    formula of the repo's BERT benchmark."""
    h, l, inter, v = (cfg.hidden_size, cfg.num_hidden_layers,
                      cfg.intermediate_size, cfg.vocab_size)
    per_layer = 4 * h * h + 2 * h * inter          # qkvo + ffn weights
    matmul_params = l * per_layer
    fwd_tok = 2 * matmul_params + l * 4 * seq * h  # + attention scores/pv
    fwd = batch * seq * fwd_tok
    fwd += 2 * batch * n_masked * h * v            # MLM head matmul
    return 3 * fwd


_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8
_DROPOUT_KEY = 20  # JAX folds PRNGKey(20) with the step count
_M64 = (1 << 64) - 1


def _step_seed(key: int, t: int) -> int:
    """A 63-bit seed from (key, t): splitmix64 of the pair, the port's
    `fold_in(PRNGKey(key), t)` (other bits than JAX's, the same role)."""
    z = (((key << 32) ^ t) + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 1


def _dropout_seed(t: int, rank: int = 0) -> int:
    """The seed of step t's dropout draws on data-parallel rank `rank`:
    rank 0's is the one-process step's, another rank's is mixed with its
    index (ROADMAP queue 3 item 44)."""
    return _step_seed(_DROPOUT_KEY + (int(rank) << 20), t)


def _decays(name: str, p: torch.Tensor) -> bool:
    """AdamW's weight-decay rule: none for biases and norms (ndim <= 1)
    nor for stacked biases named `.b1`/`.b2`."""
    return p.ndim > 1 and not name.endswith((".b1", ".b2"))


def _to_device(a, device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(device, non_blocking=True)


def build_pretrain_step(model: BertForPretraining, weight_decay=0.01,
                        bf16=True, remat=False, device=None, mesh=None,
                        mp_axis=None, sp_axis=None, use_ring_attention=False,
                        use_ulysses=False, dp_axis="dp"):
    """The BERT pretraining step: forward, backward and AdamW.

    Returns (step_fn, state), with
      state = {"params", "m", "v", "t"}: fp32 masters and Adam moments by
      parameter name (the tied decoder weight once, under
      `bert.embeddings.word_embeddings.weight`), and the step count t, a
      host int;
      step_fn(state, batch, lr) -> (state, loss).
    `batch` holds paddle_tpu's fake_batch keys as numpy arrays or tensors;
    `lr` is a float or a 0-d tensor.  `loss` is a 0-d tensor on the device:
    nothing in the step reads a device value back to the host.  The step
    UPDATES `state` IN PLACE (masters and moments) and returns it; the
    model's own parameters are never touched.

    With `bf16`, the forward runs on a bf16 cast of the masters and the
    cast's backward hands f32 gradients to them.  AdamW is paddle_tpu's:
    b1 0.9, b2 0.999, eps 1e-8, bias correction by t, `upd + wd * p`, no
    decay for tensors of ndim <= 1 or names ending in `.b1`/`.b2`; the
    tied weight gets the sum of both uses' gradients.  Dropout draws from
    `rng_scope(seed(20, t))`, so a step is deterministic in t.  The model
    runs in its current mode (train() by default).

    `device`: where the state lives (default: the model's device).

    `mesh` (parallel.mesh.make_mesh over the process group) makes the
    step data-parallel over its `dp_axis` (the reference's
    models/bert.py:396-423): each rank is fed ITS rows of the global
    batch (mesh.shard_host_batch), the masters start as rank 0's, the
    gradients and the loss are summed over the axis in one flat f32
    all-reduce a step before AdamW and divided by the axis's size, so
    every rank applies the global batch's mean gradient and returns the
    global mean loss.  Each rank draws its own dropout masks: rank 0 the
    one-process masks of its rows, rank r > 0 from a seed mixed with r
    (ROADMAP queue 3 item 44; the reference draws the global batch's
    masks).  A mesh whose data axis has size 1 is the one-process step.
    `remat`, `mp_axis` (tensor parallelism), `sp_axis` with ring/Ulysses
    attention and Switch-MoE models are not ported yet (ROADMAP queue 1
    item 10b) and raise NotImplementedError."""
    asked = {"remat": remat,
             "mp_axis": mp_axis is not None, "sp_axis": sp_axis is not None,
             "use_ring_attention": use_ring_attention,
             "use_ulysses": use_ulysses,
             "moe_experts": getattr(model.bert.config, "moe_experts", 0)}
    missing = [k for k, v in asked.items() if v]
    if missing:
        raise NotImplementedError(
            f"build_pretrain_step: {', '.join(missing)} not ported yet "
            "(ROADMAP queue 1 item 10b)")
    dev = (next(model.parameters()).device if device is None
           else _device.resolve(device))
    criterion = BertPretrainingCriterion(model.bert.config.vocab_size)
    params = {k: v.to(dev, torch.float32, copy=True)
              for k, v in functional_state(model).items()}
    names = list(params)
    decay = [k for k in names if weight_decay and _decays(k, params[k])]
    group, n_dp, rank = None, 1, 0
    if mesh is not None:
        from ..distributed import comm

        if mesh.data_axis != dp_axis and dp_axis not in mesh.axis_names:
            raise ValueError(f"dp_axis {dp_axis!r} is not an axis of {mesh}")
        n_dp = mesh.data_size
        if n_dp > 1:
            group, rank = mesh.group, comm.rank(mesh.group)
            with torch.no_grad():
                for v in params.values():
                    v.copy_(comm.broadcast(v, 0, group))
    state = {"params": params,
             "m": {k: torch.zeros_like(v) for k, v in params.items()},
             "v": {k: torch.zeros_like(v) for k, v in params.items()},
             "t": 0}

    def loss_fn(masters, batch):
        cast = {k: v.to(torch.bfloat16) if bf16 and v.dtype == torch.float32
                else v for k, v in masters.items()}
        am = batch.get("attention_mask")
        if am is not None:
            am = (am != 0)[:, None, None, :]
        (mlm, nsp), _ = functional_call(
            model, cast, batch["input_ids"], batch["token_type_ids"],
            attention_mask=am, masked_positions=batch["masked_positions"])
        return criterion(mlm, nsp, batch["masked_labels"],
                         batch["nsp_labels"])

    def step_fn(state, batch, lr):
        t = state["t"] + 1
        batch = {k: _to_device(v, dev) for k, v in batch.items()}
        leaves = [state["params"][k].detach().requires_grad_(True)
                  for k in names]
        with F.rng_scope(_dropout_seed(t, rank)):
            loss = loss_fn(dict(zip(names, leaves)), batch)
        grads = [g.float() for g in torch.autograd.grad(loss, leaves)]
        if n_dp > 1:
            grads, loss = _dp_mean(grads, loss, group, n_dp)
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
            by_name = dict(zip(names, upd))
            if decay:
                torch._foreach_add_([by_name[k] for k in decay],
                                    [state["params"][k] for k in decay],
                                    alpha=weight_decay)
            torch._foreach_mul_(upd, lr)
            torch._foreach_sub_(p, upd)
        state["t"] = t
        return state, loss.detach()

    return step_fn, state


def _dp_mean(grads, loss, group, n):
    """The gradients and the loss averaged over the data axis: one flat
    f32 buffer, one all-reduce."""
    from ..distributed import comm

    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [loss.detach().float().reshape(1)])
    comm.all_reduce_(flat, "sum", group)
    flat.div_(n)
    out, off = [], 0
    for g in grads:
        k = g.numel()
        out.append(flat[off:off + k].view_as(g))
        off += k
    return out, flat[off]


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
