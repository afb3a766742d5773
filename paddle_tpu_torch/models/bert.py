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
fp32 masters, the forward on their bf16 cast, data-parallel over a
mesh's `dp_axis`, tensor-parallel over its `mp_axis` (Megatron's
layout, `bert_param_spec`) and sequence-parallel over its `sp_axis`
(ring or Ulysses attention, or K/V gathered at attention).
"""

from __future__ import annotations

import contextlib
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
from ..nn.layer.transformer import tensor_parallel, tp_context
from ..ops.kernels import attention


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


# the batch leaves whose dim 1 is the sequence: a sequence-parallel step
# is fed its tokens of these (`mesh.shard_host_batch(..., seq_keys=
# SEQ_KEYS)`, the reference's P(dp, sp) of the ids and masks), the
# masked positions and the labels whole
SEQ_KEYS = ("input_ids", "attention_mask", "token_type_ids",
            "position_ids")


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
        self.vocab_size = cfg.vocab_size
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **kw)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size, **kw)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size,
                                               cfg.hidden_size, **kw)
        self.layer_norm = LayerNorm(cfg.hidden_size)
        self.dropout = Dropout(cfg.hidden_dropout_prob, generator=generator)

    def _words(self, input_ids):
        """The word embeddings; under tensor parallelism with the table
        split over the vocab, this rank's rows looked up where the ids fall
        in them (zeros elsewhere) and summed over the group."""
        w = self.word_embeddings.weight
        tp = tp_context()
        if tp is None or w.shape[0] == self.vocab_size:
            return self.word_embeddings(input_ids)
        from ..distributed import comm

        group, rank, _ = tp
        lo, rows = rank * w.shape[0], w.shape[0]
        local = input_ids - lo
        mine = (local >= 0) & (local < rows)
        e = F.embedding(torch.where(mine, local, torch.zeros_like(local)), w)
        e = torch.where(mine[..., None], e, torch.zeros_like(e))
        return comm.reduce_from_group(e, group)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            # a sequence rank's tokens sit at their global positions
            sp = attention.seq_split()
            first = 0 if sp is None else sp.rank * input_ids.shape[1]
            position_ids = first + torch.arange(
                input_ids.shape[1], device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        s = (self._words(input_ids)
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
        sp = attention.seq_split()
        if sp is not None:
            # the heads read the whole sequence (the pooler's CLS token
            # lives on sequence rank 0, the masked positions anywhere):
            # the encoder's output gathered over the split, whose
            # backward sums each rank's share back to its tokens
            from ..distributed import comm

            encoded = comm.all_gather_diff(
                encoded.movedim(1, 0).contiguous(), sp.group).movedim(0, 1)
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
        w = self.decoder_weight
        tp = tp_context()
        if tp is not None and w.shape[0] != self.decoder_bias.shape[0]:
            # the tied table split over the vocab: this rank's logits,
            # gathered before the criterion
            from ..distributed import comm

            group = tp[0]
            mlm = comm.gather_last_dim(torch.matmul(
                comm.copy_to_group(x, group), w.t()), group)
            mlm = mlm + self.decoder_bias
        else:
            mlm = torch.matmul(x, w.t()) + self.decoder_bias
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
    batch (mesh.shard_host_batch), the masters start as global rank 0's,
    the gradients and the loss are summed over the axis in one flat f32
    all-reduce a step before AdamW and divided by the axis's size, so
    every rank applies the global batch's mean gradient and returns the
    global mean loss.  Each data-parallel rank draws its own dropout
    masks: rank 0 the one-process masks of its rows, rank r > 0 from a
    seed mixed with r (ROADMAP queue 3 item 44; the reference draws the
    global batch's masks).

    `mp_axis` (an axis of `mesh`) makes it tensor-parallel over that axis
    too, with the reference's layout (`bert_param_spec`): each rank's
    state holds its shards of the column-parallel q/k/v_proj and linear1
    weights, of the row-parallel out_proj and linear2 weights and of the
    word-embedding table (split over the vocab where the axis divides it,
    else replicated: `spec_rules.fit_entries`), the other tensors whole.
    The forward runs inside `nn.layer.transformer.tensor_parallel`: the
    rank's heads and d_ff columns, one all-reduce over the axis after
    each row-parallel product and after the vocab-split lookup, the tied
    decoder's logits gathered before the criterion.  The replicated
    biases the column-parallel layers slice get their gradient summed
    over the axis, the other replicated tensors theirs averaged over it
    (one flat all-reduce): the ranks compute the same gradient but for
    the order of CUDA's atomic adds (the embedding and gather
    backwards), so the replicated masters stay the same bits on every
    rank.  The tensor-parallel ranks of one data-parallel rank
    draw the same masks, the kernels' hash taking their heads and
    columns by their global indices, so at dp 1 the step draws the
    one-process step's masks.  The axis must divide the heads and
    d_ff (ValueError).

    `sp_axis` (an axis of `mesh`) makes it sequence-parallel over that
    axis too (the reference's batch layout P(dp, sp)): each rank is fed
    its tokens of its rows (`mesh.shard_host_batch(mesh, batch,
    seq_keys=SEQ_KEYS)` cuts the ids and the attention mask along the
    sequence; the masked positions, their labels and the NSP labels stay
    whole over the axis).  The layers run on the rank's tokens at their
    global positions, with the one-process hidden dropout masks, inside
    `ops.kernels.attention.sequence_split`; attention takes ring
    attention (`use_ring_attention`), Ulysses' all-to-alls
    (`use_ulysses`), or else the rank's queries against K/V gathered over
    the axis (the layout the reference leaves to GSPMD); the encoder's
    output is gathered over the axis before the pooler and the heads
    (CLS lives on sequence rank 0, a masked position anywhere).  Each
    rank's loss is the whole batch's; its backward is taken of the loss
    over the axis's size and every gradient is summed over the axis, so
    the ranks hold the one-process gradient.  The reference's refusals
    stand (ValueError): attention dropout with ring or Ulysses, both at
    once, a head count Ulysses cannot split.  Under ring attention the
    reference drops the attention mask; the port raises when a row of
    the batch is padded (where dropping it would change the answer), and
    it refuses attention dropout over a split without ring or Ulysses
    (the kernels' hash would index each rank's queries from 0): ROADMAP
    queue 3 items 49-50.

    `remat` waits for ROADMAP queue 1 item 1, Switch-MoE models for item
    10b (iv): they raise NotImplementedError."""
    cfg = model.bert.config
    attn_p = cfg.attention_probs_dropout_prob
    if use_ring_attention and attn_p:
        raise ValueError(
            "use_ring_attention requires attention_probs_dropout_prob=0 "
            "(attention dropout is not supported by the ring path yet)")
    if use_ulysses and attn_p:
        raise ValueError(
            "use_ulysses requires attention_probs_dropout_prob=0 "
            "(attention dropout is not supported by the all-to-all path)")
    if use_ulysses and use_ring_attention:
        raise ValueError("choose ONE of use_ulysses/use_ring_attention")
    later = [("remat", remat, "queue 1 item 1"),
             ("moe_experts", getattr(cfg, "moe_experts", 0),
              "queue 1 item 10b (iv)")]
    missing = [f"{k} (ROADMAP {item})" for k, v, item in later if v]
    if missing:
        raise NotImplementedError(
            f"build_pretrain_step: {', '.join(missing)} not ported yet")
    dev = (next(model.parameters()).device if device is None
           else _device.resolve(device))
    criterion = BertPretrainingCriterion(cfg.vocab_size)
    full = {k: v.to(dev, torch.float32, copy=True)
            for k, v in functional_state(model).items()}
    names = list(full)
    group, n_dp, rank = None, 1, 0
    mp = None  # (group, rank, size) of the tensor axis
    sp, sp_mode = None, None  # (group, rank, size) of the sequence axis
    specs = {}
    for name, axis in (("mp_axis", mp_axis), ("sp_axis", sp_axis)):
        if axis is not None and mesh is None:
            raise ValueError(f"{name} needs a mesh")
    if mesh is not None:
        from ..distributed import comm
        from ..parallel import mesh as M

        if mesh.data_axis != dp_axis and dp_axis not in mesh.axis_names:
            raise ValueError(f"dp_axis {dp_axis!r} is not an axis of {mesh}")
        for name, axis in (("mp_axis", mp_axis), ("sp_axis", sp_axis)):
            if axis is not None and axis not in mesh.axis_names:
                raise ValueError(f"{name} {axis!r} is not an axis of {mesh}")
        n_dp = int(mesh.shape.get(dp_axis, mesh.data_size))
        if n_dp > 1:
            group = M.axis_group(mesh, dp_axis)
            rank = M.axis_rank(mesh, dp_axis)
        n_mp = int(mesh.shape[mp_axis]) if mp_axis is not None else 1
        if n_mp > 1:
            for what, total in (("num_attention_heads",
                                 cfg.num_attention_heads),
                                ("intermediate_size",
                                 cfg.intermediate_size)):
                if total % n_mp:
                    raise ValueError(
                        f"mp_axis {mp_axis!r} of size {n_mp} must divide "
                        f"{what} ({total}); GSPMD splits the columns "
                        "whatever the heads (ROADMAP queue 3)")
            mp = (M.axis_group(mesh, mp_axis), M.axis_rank(mesh, mp_axis),
                  n_mp)
            specs = {k: mp_spec(k, tuple(v.shape), mesh, mp_axis)
                     for k, v in full.items()}
        n_sp = int(mesh.shape[sp_axis]) if sp_axis is not None else 1
        if n_sp > 1:
            sp_mode = ("ring" if use_ring_attention else
                       "ulysses" if use_ulysses else "gather")
            heads = cfg.num_attention_heads // (mp[2] if mp else 1)
            if sp_mode == "ulysses" and heads % n_sp:
                raise ValueError(
                    f"ulysses needs num_heads {heads} (a tensor rank's) "
                    f"divisible by the {sp_axis} axis size {n_sp}; use "
                    "ring attention otherwise")
            if sp_mode == "gather" and attn_p:
                raise NotImplementedError(
                    "attention dropout over a sequence split without ring "
                    "or Ulysses: the kernels' hash would index each rank's "
                    "queries from 0 (ROADMAP queue 3 item 50)")
            sp = (M.axis_group(mesh, sp_axis), M.axis_rank(mesh, sp_axis),
                  n_sp)
        if comm.live():
            # every rank starts from global rank 0's masters
            with torch.no_grad():
                for v in full.values():
                    v.copy_(comm.broadcast(v, 0))
    if specs:
        from ..parallel.compiler import shard_of

        params = {k: shard_of(v, specs[k], mesh) if tuple(specs[k]) else v
                  for k, v in full.items()}
    else:
        params = full
    decay = [k for k in names if weight_decay and _decays(k, params[k])]
    partial = [k for k in names if mp is not None
               and k.endswith(MP_SLICED_BIASES)]
    whole = [k for k in names if mp is not None and k not in partial
             and not tuple(specs[k])]
    state = {"params": params,
             "m": {k: torch.zeros_like(v) for k, v in params.items()},
             "v": {k: torch.zeros_like(v) for k, v in params.items()},
             "t": 0}

    def loss_fn(masters, batch):
        cast = {k: v.to(torch.bfloat16) if bf16 and v.dtype == torch.float32
                else v for k, v in masters.items()}
        am = batch.get("attention_mask")
        if am is not None and sp_mode == "ring":
            am = None  # no row is padded (`_ring_mask_check`)
        elif am is not None:
            if sp is not None:
                # every rank's keys are the whole sequence's
                from ..distributed import comm

                am = comm.all_gather(am.movedim(1, 0).contiguous(),
                                     sp[0]).movedim(0, 1)
            am = (am != 0)[:, None, None, :]
        (mlm, nsp), _ = functional_call(
            model, cast, batch["input_ids"], batch["token_type_ids"],
            attention_mask=am, masked_positions=batch["masked_positions"])
        return criterion(mlm, nsp, batch["masked_labels"],
                         batch["nsp_labels"])

    def step_fn(state, batch, lr):
        t = state["t"] + 1
        if sp_mode == "ring":
            _ring_mask_check(batch.get("attention_mask"), sp[0], dev)
        batch = {k: _to_device(v, dev) for k, v in batch.items()}
        leaves = [state["params"][k].detach().requires_grad_(True)
                  for k in names]
        with contextlib.ExitStack() as scopes:
            scopes.enter_context(F.rng_scope(_dropout_seed(t, rank)))
            if mp is not None:
                scopes.enter_context(tensor_parallel(*mp))
            if sp is not None:
                scopes.enter_context(attention.sequence_split(
                    sp_mode, mesh, sp_axis))
            loss = loss_fn(dict(zip(names, leaves)), batch)
        # every sequence rank's loss is the whole batch's: the backward of
        # its share, the gradients summed over the axis
        grads = [g.float() for g in torch.autograd.grad(
            loss if sp is None else loss / sp[2], leaves)]
        if sp is not None:
            grads = _sp_sum(grads, sp[0])
        if mp is not None:
            grads = _mp_reduce(grads, names, partial, whole, mp[0], mp[2])
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

    # the state's layout: PartitionSpec by name (empty without mp_axis)
    step_fn.specs = specs
    step_fn.mesh = mesh
    return step_fn, state


def _ring_mask_check(am, group, dev):
    """Under ring attention the reference drops the attention mask; the
    port raises where that would change the answer: a padded row on any
    rank of the sequence axis (one MAX all-reduce of a flag over it)."""
    if am is None:
        return
    from ..distributed import comm

    padded = bool((np.asarray(am) == 0).any()) if not isinstance(
        am, torch.Tensor) else bool((am == 0).any())
    flag = torch.tensor([float(padded)], device=dev)
    if float(comm.all_reduce(flag, "max", group)[0]):
        raise ValueError(
            "use_ring_attention: the ring takes no attention mask (the "
            "reference drops it), and a row of this batch is padded, where "
            "dropping it would change the answer (ROADMAP queue 3 item 49); "
            "feed unpadded rows or use_ulysses")


def _sp_sum(grads, group):
    """Every gradient summed over the sequence axis, in one flat f32
    all-reduce."""
    from ..distributed import comm

    flat = torch.cat([g.reshape(-1) for g in grads])
    comm.all_reduce_(flat, "sum", group)
    out, off = [], 0
    for g in grads:
        out.append(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    return out


# the replicated biases a column-parallel layer slices: their gradient
# covers this rank's slice only and is summed over the tensor axis
MP_SLICED_BIASES = ("q_proj.bias", "k_proj.bias", "v_proj.bias",
                    "linear1.bias")


def bert_param_spec(name, shape, mp_axis="mp"):
    """Megatron's tensor-parallel PartitionSpec of a BERT parameter by its
    name (the reference's `bert_param_spec`): column-parallel q/k/v_proj
    and linear1 weights split over their output dim, row-parallel
    out_proj and linear2 weights over their input dim, the word-embedding
    table over the vocab; everything else replicated."""
    from ..parallel.spec_layout import P

    if len(shape) == 2:
        if any(s in name for s in ("q_proj.w", "k_proj.w", "v_proj.w",
                                   "linear1.w")):
            return P(None, mp_axis)
        if any(s in name for s in ("out_proj.w", "linear2.w")):
            return P(mp_axis, None)
        if "word_embeddings" in name:
            return P(mp_axis, None)
    return P()


def mp_spec(name, shape, mesh, mp_axis="mp"):
    """`bert_param_spec` fitted to the mesh and shape
    (`spec_rules.fit_entries`): a dim the axis does not divide (the
    vocab of 30522 over 4) stays whole."""
    from ..parallel import spec_layout, spec_rules

    fitted, _ = spec_rules.fit_entries(
        tuple(bert_param_spec(name, shape, mp_axis)), shape,
        spec_layout.mesh_axes_dict(mesh))
    return spec_layout.P(*fitted)


def _mp_reduce(grads, names, partial, whole, group, n):
    """Over the tensor axis, in one flat all-reduce: the gradients of the
    sliced replicated biases summed (each rank's covers its slice), those
    of the other replicated tensors averaged."""
    from ..distributed import comm

    at = [names.index(k) for k in partial + whole]
    flat = torch.cat([grads[i].reshape(-1) for i in at])
    comm.all_reduce_(flat, "sum", group)
    cut = sum(grads[names.index(k)].numel() for k in partial)
    flat[cut:].div_(n)
    out, off = list(grads), 0
    for i in at:
        k = grads[i].numel()
        out[i] = flat[off:off + k].view_as(grads[i])
        off += k
    return out


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
