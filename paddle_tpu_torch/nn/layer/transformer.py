"""Transformer layers (counterpart of paddle_tpu/nn/layer/transformer.py):
MultiHeadAttention with its incremental and static KV caches, the
encoder and decoder layers (post-norm, Paddle's default and BERT's form,
or pre-norm with `normalize_before`), their stacks and the
encoder-decoder `Transformer`.

The attention core routes through `F.scaled_dot_product_attention` (the
flash kernels for masks constant over query and head dims, the dense
path for the rest, as the reference dispatches) and the dense FFN
through `F.fused_feedforward`.  Layout is (batch, seq, d_model)
throughout, (batch, seq, heads, head_dim) inside attention, as in
Paddle's 2.x API.

Inside `tensor_parallel(group, rank, size)` self-attention and the dense
FFN run Megatron's tensor parallelism on the weights a caller hands them
(`jit.functional_call` with each rank's shards, as the BERT step does):
q/k/v_proj and linear1 column-parallel (their weights hold this rank's
output columns; their replicated biases are sliced to them), out_proj
and linear2 row-parallel (their weights hold this rank's input rows; one
all-reduce over the group follows each, then the bias is added once).
The rank's heads and d_ff columns take their global indices in the
kernels' dropout hash, so they draw the one-process step's masks.
Outside the context nothing changes.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Optional

import torch
from torch import nn

from ... import device as _device
from .. import functional as F
from ..initializer import Initializer
from .activation import GELU, ReLU
from .common import Dropout, Linear
from .layers import Layer
from .norm import LayerNorm

_TP = threading.local()


@contextlib.contextmanager
def tensor_parallel(group, rank: int, size: int):
    """Run the layers called inside on this rank's tensor-parallel shards
    of `size` over `group` (the process group of the tensor axis)."""
    old = getattr(_TP, "ctx", None)
    _TP.ctx = (group, int(rank), int(size))
    try:
        yield
    finally:
        _TP.ctx = old


def tp_context():
    """(group, rank, size) of the enclosing `tensor_parallel`, or None."""
    return getattr(_TP, "ctx", None)


def _local(what: str, total: int, size: int) -> int:
    if total % size:
        raise ValueError(f"tensor parallelism over {size} ranks needs "
                         f"{what} ({total}) to divide by it")
    return total // size


def _column(x, lin, rank: int):
    """A column-parallel Linear: this rank's output columns, the
    replicated bias sliced to them."""
    k = lin.weight.shape[1]
    b = lin.bias
    return F.linear(x, lin.weight,
                    None if b is None else b[rank * k:(rank + 1) * k])


def _row(x, lin, group):
    """A row-parallel Linear: the partial products summed over the group,
    then the bias."""
    from ...distributed import comm

    out = comm.reduce_from_group(F.linear(x, lin.weight), group)
    return out if lin.bias is None else out + lin.bias


class MultiHeadAttention(Layer):
    """Paddle's MultiHeadAttention.  `cache` in forward: a `Cache` (the
    incremental self-attention cache: this call's k/v are appended to it
    and the grown cache is returned beside the output) or a
    `StaticCache` (cross-attention: the memory's projected k/v, used as
    they are); `gen_cache` makes either."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 kdim: Optional[int] = None, vdim: Optional[int] = None,
                 need_weights: bool = False, weight_attr=None,
                 bias_attr=None, *,
                 weight_init: Optional[Initializer] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        if need_weights:
            # the reference stores the flag and never returns weights
            raise NotImplementedError(
                "need_weights=True: the reference returns no attention "
                "weights (ROADMAP queue 3)")
        self.embed_dim = embed_dim
        self.kdim, self.vdim = kdim or embed_dim, vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.generator = generator
        kw = dict(weight_init=weight_init, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)

    def _split_heads(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        """`StaticCache` of key's (and value's) projected k/v when `type`
        is StaticCache; else an empty `Cache`, (B, 0, heads, head_dim) in
        the weights' dtype, on key's device."""
        if type is MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(key if value is None
                                              else value))
            return self.StaticCache(k, v)
        empty = torch.empty((key.shape[0], 0, self.num_heads, self.head_dim),
                            dtype=self.k_proj.weight.dtype, device=key.device)
        return self.Cache(empty, empty)

    def _tp_forward(self, query, attn_mask, tp):
        from ...distributed import comm

        group, rank, size = tp
        heads = _local("num_heads", self.num_heads, size)
        if self.q_proj.weight.shape[1] != heads * self.head_dim:
            raise ValueError(
                f"tensor parallelism over {size} ranks: q_proj.weight holds "
                f"{self.q_proj.weight.shape[1]} columns, not this rank's "
                f"{heads * self.head_dim}")
        x = comm.copy_to_group(query, group)
        q, k, v = (_column(x, lin, rank).reshape(
            x.shape[0], x.shape[1], heads, self.head_dim)
            for lin in (self.q_proj, self.k_proj, self.v_proj))
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training, generator=self.generator,
            heads_total=self.num_heads, head_offset=rank * heads)
        return _row(out.reshape(out.shape[0], out.shape[1], -1),
                    self.out_proj, group)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        tp = tp_context()
        if tp is not None:
            if cache is not None or (key is not None and key is not query):
                raise NotImplementedError(
                    "tensor parallelism runs self-attention without a cache")
            return self._tp_forward(query, attn_mask, tp)
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                cache = self.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training, generator=self.generator)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        if cache is not None and not isinstance(cache, self.StaticCache):
            return out, cache
        return out


def _dense_ffn_block(layer, x):
    """linear2(dropout(act(linear1(x)))) through F.fused_feedforward, for
    encoder and decoder layers alike; layer by layer when a linear has
    no bias (bias_attr=False), as the reference routes it."""
    act = layer.activation
    act_name = "relu" if isinstance(act, ReLU) else (
        "gelu_tanh" if act.approximate else "gelu")
    tp = tp_context()
    if tp is not None:
        return _tp_ffn_block(layer, x, act_name, tp)
    if layer.linear1.bias is None or layer.linear2.bias is None:
        return layer.linear2(layer.dropout(layer.activation(
            layer.linear1(x))))
    return F.fused_feedforward(
        x, layer.linear1.weight, layer.linear1.bias, layer.linear2.weight,
        layer.linear2.bias, activation=act_name,
        act_dropout=layer.dropout.p, training=layer.training,
        generator=layer.dropout.generator)


def _tp_ffn_block(layer, x, act_name, tp):
    """The dense FFN on this rank's d_ff columns: linear1 column-parallel
    and linear2 row-parallel in one F.fused_feedforward (its b2 zero),
    then the all-reduce over the group and linear2's bias."""
    from ...distributed import comm

    group, rank, size = tp
    w1, w2 = layer.linear1.weight, layer.linear2.weight
    b1, b2 = layer.linear1.bias, layer.linear2.bias
    if b1 is None or b2 is None:
        raise NotImplementedError(
            "tensor parallelism runs the FFN with its biases")
    f = w1.shape[1]
    if w2.shape[0] != f or b1.shape[0] != f * size:
        raise ValueError(f"tensor parallelism over {size} ranks: linear1 "
                         f"holds {f} columns, linear1.bias {b1.shape[0]}")
    out = F.fused_feedforward(
        comm.copy_to_group(x, group), w1, b1[rank * f:(rank + 1) * f], w2,
        torch.zeros_like(b2), activation=act_name,
        act_dropout=layer.dropout.p, training=layer.training,
        generator=layer.dropout.generator, col_offset=rank * f)
    return comm.reduce_from_group(out, group) + b2


def _sublayer(norm, normalize_before, x, fn):
    """x + fn(norm(x)) pre-norm, norm(x + fn(x)) post-norm; fn returns
    (output, extra) and `extra` is passed through."""
    out, extra = fn(norm(x) if normalize_before else x)
    out = x + out
    return (out if normalize_before else norm(out)), extra


class TransformerEncoderLayer(Layer):
    """Paddle's encoder layer: post-norm by default (BERT's form), pre-norm
    with `normalize_before`."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False, weight_attr=None,
                 bias_attr=None, moe_experts: Optional[int] = None,
                 moe_capacity_factor: float = 1.25, *,
                 weight_init: Optional[Initializer] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if moe_experts:
            raise NotImplementedError(
                "Switch-MoE encoder layers (moe_experts > 0) are not "
                "ported yet")
        self._config = ((d_model, nhead, dim_feedforward, dropout,
                         activation, attn_dropout, act_dropout,
                         normalize_before, weight_attr, bias_attr,
                         moe_experts, moe_capacity_factor),
                        dict(weight_init=weight_init, generator=generator))
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, weight_init=weight_init,
            generator=generator)
        kw = dict(weight_init=weight_init, generator=generator)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.dropout = Dropout(act_dropout, generator=generator)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.activation = GELU() if activation == "gelu" else ReLU()

    def forward(self, src, src_mask=None, cache=None):
        def attend(x):
            if cache is None:
                return self.dropout1(self.self_attn(x, x, x, src_mask)), None
            out, new = self.self_attn(x, x, x, src_mask, cache)
            return self.dropout1(out), new

        src, cache = _sublayer(self.norm1, self.normalize_before, src,
                               attend)
        src, _ = _sublayer(
            self.norm2, self.normalize_before, src,
            lambda x: (self.dropout2(_dense_ffn_block(self, x)), None))
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src, type=MultiHeadAttention.Cache)


class TransformerDecoderLayer(Layer):
    """Paddle's decoder layer: self-attention, cross-attention over the
    memory, FFN; post-norm by default, pre-norm with `normalize_before`.
    `cache` is (incremental Cache, StaticCache), as `gen_cache` makes it."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False, weight_attr=None,
                 bias_attr=None, *,
                 weight_init: Optional[Initializer] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._config = ((d_model, nhead, dim_feedforward, dropout,
                         activation, attn_dropout, act_dropout,
                         normalize_before, weight_attr, bias_attr),
                        dict(weight_init=weight_init, generator=generator))
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = dict(dropout=attn_dropout, weight_attr=weight_attr,
                  bias_attr=bias_attr, weight_init=weight_init,
                  generator=generator)
        self.self_attn = MultiHeadAttention(d_model, nhead, **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, **kw)
        lkw = dict(weight_init=weight_init, generator=generator)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **lkw)
        self.dropout = Dropout(act_dropout, generator=generator)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **lkw)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.dropout3 = Dropout(dropout, generator=generator)
        self.activation = GELU() if activation == "gelu" else ReLU()

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        def attend(x):
            if cache is None:
                return self.dropout1(self.self_attn(x, x, x, tgt_mask)), None
            out, new = self.self_attn(x, x, x, tgt_mask, cache[0])
            return self.dropout1(out), new

        def cross(x):
            out = self.cross_attn(x, memory, memory, memory_mask,
                                  None if cache is None else cache[1])
            return self.dropout2(out), None

        tgt, incr = _sublayer(self.norm1, self.normalize_before, tgt, attend)
        tgt, _ = _sublayer(self.norm2, self.normalize_before, tgt, cross)
        tgt, _ = _sublayer(
            self.norm3, self.normalize_before, tgt,
            lambda x: (self.dropout3(_dense_ffn_block(self, x)), None))
        return tgt if cache is None else (tgt, (incr, cache[1]))

    def gen_cache(self, memory):
        incr = self.self_attn.gen_cache(memory,
                                        type=MultiHeadAttention.Cache)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incr, static


def _clone_layer(layer):
    """A fresh layer of the same constructor config (the reference's
    `_clone_layer`): independent initialization, its own names."""
    args, kw = layer._config
    return type(layer)(*args, **kw)


def _stack(layer, num_layers):
    """The layers of a stack: a layer instance is layer 0 and the rest
    are clones of its config, as in the reference; any other callable is
    a factory called once a layer."""
    if isinstance(layer, nn.Module):
        return [layer] + [_clone_layer(layer) for _ in range(num_layers - 1)]
    return [layer() for _ in range(num_layers)]


class TransformerEncoder(Layer):
    """`num_layers` encoder layers, then `norm` if given.  The first
    argument is the reference's `encoder_layer` (used as layer 0, the
    others built from its config), or a factory `layer_fn()` called once
    a layer."""

    def __init__(self, encoder_layer, num_layers: int,
                 norm: Optional[nn.Module] = None):
        super().__init__()
        self.layers = nn.ModuleList(_stack(encoder_layer, num_layers))
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                src = layer(src, src_mask)
            else:
                src, new = layer(src, src_mask, cache[i])
                new_caches.append(new)
        if self.norm is not None:
            src = self.norm(src)
        return src if cache is None else (src, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoder(Layer):
    """`num_layers` decoder layers (from a `decoder_layer` instance or a
    factory, as TransformerEncoder takes them), then `norm` if given.
    `cache` is one (Cache, StaticCache) pair a layer."""

    def __init__(self, decoder_layer, num_layers: int,
                 norm: Optional[nn.Module] = None):
        super().__init__()
        self.layers = nn.ModuleList(_stack(decoder_layer, num_layers))
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                tgt = layer(tgt, memory, tgt_mask, memory_mask)
            else:
                tgt, new = layer(tgt, memory, tgt_mask, memory_mask,
                                 cache[i])
                new_caches.append(new)
        if self.norm is not None:
            tgt = self.norm(tgt)
        return tgt if cache is None else (tgt, new_caches)

    def gen_cache(self, memory, do_zip=False):
        """One (Cache, StaticCache) pair a layer; with `do_zip`, the pairs
        transposed into (all Caches, all StaticCaches)."""
        cache = [layer.gen_cache(memory) for layer in self.layers]
        return list(zip(*cache)) if do_zip else cache


class Transformer(Layer):
    """Paddle's encoder-decoder Transformer; with `normalize_before`, each
    stack ends in a LayerNorm of its own."""

    def __init__(self, d_model: int = 512, nhead: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False, weight_attr=None,
                 bias_attr=None, custom_encoder: Optional[nn.Module] = None,
                 custom_decoder: Optional[nn.Module] = None, *,
                 weight_init: Optional[Initializer] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dropout=dropout, activation=activation,
                  attn_dropout=attn_dropout, act_dropout=act_dropout,
                  normalize_before=normalize_before, weight_attr=weight_attr,
                  bias_attr=bias_attr, weight_init=weight_init,
                  generator=generator)

        def norm():
            return LayerNorm(d_model) if normalize_before else None

        self.encoder = custom_encoder if custom_encoder is not None else \
            TransformerEncoder(lambda: TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, **kw), num_encoder_layers,
                norm())
        self.decoder = custom_decoder if custom_decoder is not None else \
            TransformerDecoder(lambda: TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, **kw), num_decoder_layers,
                norm())
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length: int, device=None):
        """(length, length) float32 additive causal mask, 0 on and below
        the diagonal and -inf above it, made on `device` (default: the
        port's default device)."""
        return torch.full((length, length), float("-inf"),
                          device=_device.resolve(device)).triu(1)
