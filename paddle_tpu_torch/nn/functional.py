"""The functional surface BERT and the vision models need (counterpart
of paddle_tpu/nn/functional/__init__.py).

Plain tensor functions in PyTorch's idiom; `gelu`, `mse_loss` and the
binary and KL losses run the registry's rule of the reference's op type
(`_op`), as the tensor API does.  `linear` keeps Paddle's
layout: weight is (in, out) and y = x @ W + b.  The convolution, pooling
and batch-norm functions keep Paddle's forms (OIHW weights, NCHW or NHWC
data, SAME/VALID/asymmetric padding) and the reference lowering's
semantics (paddle_tpu/ops/nn_ops.py); they run on cuDNN and ATen, as
the reference leaves them to XLA: it has no Pallas kernel there.  The
two seams that reach hand-written kernels are
`scaled_dot_product_attention` (flash forward and backward) and
`fused_feedforward` (fused FFN forward and backward, or the library arm
around the element-pass kernels); both are differentiable.

Randomness (counterpart of `rng_key_scope`,
paddle_tpu/fluid/dygraph/tracer.py:91).  Layers hold the host (CPU)
generator they were initialized from.  Inside `rng_scope(seed)` every
draw comes from one host generator seeded with `seed` instead, so a train
step is deterministic in its seed.  Element dropout draws its mask on the
tensor's own device, from a device generator seeded by a host draw; the
seeds of the in-kernel dropout hashes are host integers from the host
generator.  Neither ever reads a device tensor back, so no draw costs a
host sync.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from ..amp import cast_inputs as _amp
from ..fluid import core
from ..ops.kernels import attention as _attn
from ..ops.kernels import ffn as _ffn


def linear(x, weight, bias=None):
    """y = x @ weight + bias with weight (in_features, out_features); under
    `amp.auto_cast` the product and the bias add are the reference's two
    ops (matmul_v2, elementwise_add), cast by its lists."""
    x, weight = _amp("matmul_v2", x, weight)
    out = torch.matmul(x, weight)
    if bias is None:
        return out
    out, bias = _amp("elementwise_add", out, bias)
    return out + bias


def embedding(x, weight):
    """Rows of `weight` at the ids `x`."""
    (weight,) = _amp("lookup_table_v2", weight)
    return torch.nn.functional.embedding(x, weight)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """Paddle's layer_norm: biased variance, (x - mean) * rsqrt(var + eps),
    over the trailing `normalized_shape` dims, in x's dtype."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    axes = tuple(range(x.ndim - len(normalized_shape), x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = torch.square(x - mean).mean(dim=axes, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


def _op(op_type, ins, attrs=None, slot="Out"):
    """One registered op rule run eagerly (`tensor._run`, which casts the
    inputs by the op's type under `amp.auto_cast`), as the reference's
    functionals run theirs through `trace_op`."""
    from ..tensor import _run
    return _run(op_type, ins, attrs, (slot,))[slot][0]


def gelu(x, approximate=False):
    """Exact-erf gelu (jax.nn.gelu(approximate=False)), or the tanh form."""
    return _op("gelu", {"X": x}, {"approximate": approximate})


def relu(x):
    (x,) = _amp("relu", x)
    return torch.relu(x)


def relu6(x):
    (x,) = _amp("relu6", x)
    return torch.clamp(x, 0.0, 6.0)


def tanh(x):
    (x,) = _amp("tanh", x)
    return torch.tanh(x)


def softmax(x, axis=-1, dtype=None):
    (x,) = _amp("softmax", x)
    out = torch.softmax(x, axis)
    return out if dtype is None else out.to(core.torch_dtype(dtype))


def log_softmax(x, axis=-1, dtype=None):
    (x,) = _amp("log_softmax", x)
    out = torch.log_softmax(x, axis)
    return out if dtype is None else out.to(core.torch_dtype(dtype))


_RNG = threading.local()


@contextlib.contextmanager
def rng_scope(seed: int):
    """Draw every dropout mask and kernel seed of this thread from one
    host generator seeded with `seed` (the port's `rng_key_scope`)."""
    old = getattr(_RNG, "host", None)
    _RNG.host = torch.Generator().manual_seed(int(seed))
    try:
        yield
    finally:
        _RNG.host = old


def _host_generator(generator: Optional[torch.Generator]):
    """The scope's host generator, else the layer's own (None = torch's
    default CPU generator)."""
    scoped = getattr(_RNG, "host", None)
    return scoped if scoped is not None else generator


def _device_generator(host: torch.Generator,
                      device: torch.device) -> torch.Generator:
    """A generator on `device`, seeded by a draw from the host
    generator."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=host))
    return torch.Generator(device=device).manual_seed(seed)


def dropout(x, p=0.5, training=True, generator=None):
    """upscale_in_train dropout: the identity in eval or at p == 0.  The
    mask is drawn on x's device: from `generator` when it lives there
    (None: torch's default generator of that device), else from a device
    generator seeded by a host draw.  Under `amp.auto_cast` x is cast as
    the dropout op's inputs are, in eval too (the reference's op runs
    there as well)."""
    (x,) = _amp("dropout", x)
    if not training or p == 0.0:
        return x
    gen = _host_generator(generator)
    if gen is not None and gen.device != x.device:
        gen = _device_generator(gen, x.device)
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def _kernel_seed(generator=None) -> int:
    """A 31-bit seed for an in-kernel dropout hash: a host integer drawn
    from the scope's or the layer's host generator (never a device
    tensor, so no host sync)."""
    return int(torch.randint(0, 2 ** 31 - 1, (1,),
                             generator=_host_generator(generator)))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """Fused attention over (batch, seq, heads, head_dim) inputs: the
    flash kernels (forward and backward) on CUDA tensors, their plain
    versions on CPU tensors.  Attention dropout runs in the kernels,
    seeded from the host generator."""
    p = dropout_p if training else 0.0
    seed = _kernel_seed(generator) if p > 0.0 else None
    return _attn.scaled_dot_product_attention(
        query, key, value, mask=attn_mask, is_causal=is_causal,
        dropout_p=p, dropout_seed=seed)


def fused_feedforward(x, w1, b1, w2, b2, activation="gelu",
                      act_dropout=0.0, training=True, generator=None):
    """Fused transformer FFN: dropout(act(x@w1+b1), p) @ w2 + b2, through
    `ops.kernels.ffn.fused_ffn` (the library arm by default, the kernels
    once opted in); differentiable in x and the four weights."""
    p = act_dropout if training else 0.0
    seed = _kernel_seed(generator) if p > 0.0 else None
    return _ffn.fused_ffn(x, w1, b1, w2, b2, activation=activation,
                          dropout_p=p, dropout_seed=seed)


# -- convolution and pooling --------------------------------------------------

def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def _same_pads(size, k, stride, dilation):
    """XLA's SAME rule for one spatial dim: (low, high) pads whose total is
    max((ceil(size / stride) - 1) * stride + (k - 1) * dilation + 1 - size,
    0), the low side total // 2."""
    total = max((-(-size // stride) - 1) * stride + (k - 1) * dilation + 1
                - size, 0)
    return total // 2, total - total // 2


def _pads(padding, sizes, ksize, strides, dilations):
    """((top, bottom), (left, right)) for Paddle's padding forms
    (`_normalize_padding` + `_conv_paddings`): "SAME", "VALID", an int, a
    pair, or a 4-list [top, bottom, left, right]."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return (0, 0), (0, 0)
        if mode == "SAME":
            return tuple(_same_pads(n, k, s, d) for n, k, s, d in
                         zip(sizes, ksize, strides, dilations))
        raise ValueError(f"unknown padding {padding!r}")
    p = [int(v) for v in _pair(padding)]
    if len(p) == 2:
        return (p[0], p[0]), (p[1], p[1])
    if len(p) == 4:
        return (p[0], p[1]), (p[2], p[3])
    raise ValueError(f"padding must be an int, a pair or 4 values, got "
                     f"{padding!r}")


def _channels_first(x, data_format):
    """x as NCHW (a permuted view of NHWC data) and the function that
    brings a result back to data_format."""
    if data_format == "NCHW":
        return x, lambda y: y
    if data_format == "NHWC":
        return x.permute(0, 3, 1, 2), lambda y: y.permute(0, 2, 3, 1)
    raise ValueError(f"data_format must be NCHW or NHWC, got "
                     f"{data_format!r}")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """2-D convolution (paddle_tpu's `conv2d`, lowered at nn_ops.py:77-103):
    weight OIHW whatever the data format; stride, dilation, groups;
    Paddle's padding forms (asymmetric and strided SAME padded explicitly,
    then convolved with padding 0); the optional bias on the channel
    axis."""
    x, back = _channels_first(x, data_format)
    stride, dilation = _pair(stride), _pair(dilation)
    (t, b), (l, r) = _pads(padding, x.shape[2:], weight.shape[2:], stride,
                           dilation)
    if t != b or l != r:
        x = torch.nn.functional.pad(x, (l, r, t, b))
        t = l = 0
    cx, cw = _amp("conv2d", x, weight)
    if bias is None or (cx is x and cw is weight):
        return back(torch.nn.functional.conv2d(cx, cw, bias, stride, (t, l),
                                               dilation, groups))
    # cast: the bias add is a plain add outside the op lists, as in the
    # reference, so a bf16 convolution's output meets an f32 bias (f32)
    out = torch.nn.functional.conv2d(cx, cw, None, stride, (t, l), dilation,
                                     groups)
    return back(out + bias.view(1, -1, 1, 1))


def _pool_args(x, kernel_size, stride, padding, ceil_mode, data_format):
    if ceil_mode:
        # paddle_tpu's pool2d lowering never reads ceil_mode and floors
        raise NotImplementedError("ceil_mode=True is not supported")
    (x,) = _amp("pool2d", x)
    x, back = _channels_first(x, data_format)
    k = _pair(kernel_size)
    s = _pair(stride if stride is not None else kernel_size)
    return x, back, k, s, _pads(padding, x.shape[2:], k, s, (1, 1))


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW"):
    """Max pooling (nn_ops.py:190-250): padding counts as -inf, so any
    padding torch cannot take in the call (asymmetric, SAME, over half
    the window) is added explicitly."""
    if return_mask:
        raise NotImplementedError("return_mask=True is not supported")
    x, back, k, s, ((t, b), (l, r)) = _pool_args(
        x, kernel_size, stride, padding, ceil_mode, data_format)
    if t != b or l != r or 2 * t > k[0] or 2 * l > k[1]:
        x = torch.nn.functional.pad(x, (l, r, t, b), value=float("-inf"))
        t = l = 0
    return back(torch.nn.functional.max_pool2d(x, k, s, (t, l)))


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW"):
    """Average pooling (nn_ops.py:190-250): `exclusive` divides each
    window's sum by the count of its real elements, else by kh * kw."""
    if divisor_override is not None:
        raise NotImplementedError("divisor_override is not supported")
    x, back, k, s, ((t, b), (l, r)) = _pool_args(
        x, kernel_size, stride, padding, ceil_mode, data_format)
    if t == b and l == r and 2 * t <= k[0] and 2 * l <= k[1]:
        return back(torch.nn.functional.avg_pool2d(
            x, k, s, (t, l), count_include_pad=not exclusive))
    pad = (l, r, t, b)
    out = torch.nn.functional.avg_pool2d(
        torch.nn.functional.pad(x, pad), k, s)
    if exclusive:
        ones = torch.ones((1, 1) + x.shape[2:], dtype=x.dtype,
                          device=x.device)
        out = out / torch.nn.functional.avg_pool2d(
            torch.nn.functional.pad(ones, pad), k, s)
    return back(out)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """Adaptive average pooling over windows [floor(i S / out),
    ceil((i + 1) S / out)) (nn_ops.py:174-187), torch's rule too."""
    (x,) = _amp("pool2d", x)
    x, back = _channels_first(x, data_format)
    return back(torch.nn.functional.adaptive_avg_pool2d(x, output_size))


def adaptive_max_pool2d(x, output_size, return_mask=False):
    """Adaptive max pooling (NCHW) over the windows of
    `adaptive_avg_pool2d`."""
    if return_mask:
        raise NotImplementedError("return_mask=True is not supported")
    (x,) = _amp("pool2d", x)
    return torch.nn.functional.adaptive_max_pool2d(x, output_size)


# -- normalization ------------------------------------------------------------

def batch_norm_train(x, weight, bias, epsilon=1e-5, c_axis=1):
    """Train-mode batch norm over every axis but `c_axis`: (y, the batch
    mean, the BIASED batch variance, 1/sqrt(var + eps)), differentiable in
    x, weight and bias.  ATen's batch norm hands back the mean and the
    inverse std it normalised with, so the statistics are read once; the
    variance is recovered from the inverse std, in at least f32."""
    xc = x if c_axis == 1 else x.movedim(c_axis, 1)
    y, mean, invstd = torch.ops.aten.native_batch_norm(
        xc, weight, bias, None, None, True, 0.0, epsilon)
    with torch.no_grad():
        inv = invstd.to(torch.promote_types(invstd.dtype, torch.float32))
        var = inv.pow(-2) - epsilon
    return (y if c_axis == 1 else y.movedim(1, c_axis)), mean, var, invstd


def batch_norm(x, running_mean, running_var, weight, bias, training=False,
               momentum=0.9, epsilon=1e-5, data_format="NCHW",
               use_global_stats=None):
    """Batch norm with paddle_tpu's semantics (nn_ops.py:253-300), which
    are not torch's.  In training (unless `use_global_stats`) x is
    normalised by its batch statistics and the running buffers are
    updated IN PLACE as running * momentum + batch * (1 - momentum), with
    the BIASED batch variance, in the buffers' dtype; otherwise by the
    running statistics, which stay as they are.  The channel axis is 1
    for data formats that begin "NC" and the last one otherwise."""
    if weight is not None and x.dtype != weight.dtype:
        # the reference's promotion: a bf16 input (an O1 convolution's)
        # normalised with f32 parameters gives f32
        x = x.to(torch.promote_types(x.dtype, weight.dtype))
    c_axis = 1 if data_format.startswith("NC") or data_format == \
        "AnyLayout" else x.ndim - 1
    shape = [1] * x.ndim
    shape[c_axis] = x.shape[c_axis]
    if training and not use_global_stats:
        y, mean, var, _ = batch_norm_train(x, weight, bias, epsilon, c_axis)
        with torch.no_grad():
            for buf, stat in ((running_mean, mean), (running_var, var)):
                buf.copy_(buf * momentum + stat.to(buf.dtype) * (1 - momentum))
        return y
    scale = torch.rsqrt(running_var.float() + epsilon)
    if weight is not None:
        scale = scale * weight.float()
    shift = -running_mean.float() * scale
    if bias is not None:
        shift = shift + bias.float()
    return torch.addcmul(shift.to(x.dtype).view(shape), x,
                         scale.to(x.dtype).view(shape))


# -- losses (nn/functional/__init__.py:402-566, the ops of nn_ops.py) ---------

def sequence_mask(lengths, maxlen=None, dtype="int64", name=None):
    """(B,) lengths -> (B, maxlen) mask in `dtype`: 1 where the position
    is below the row's length.  Without `maxlen`, the lengths' largest,
    read to the host (one sync), as the reference reads it."""
    m = int(lengths.max()) if maxlen is None else int(maxlen)
    pos = torch.arange(m, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).to(core.torch_dtype(dtype))


def _reduce_loss(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def softmax_with_cross_entropy(logits, label, soft_label=False, axis=-1,
                               ignore_index=-100, return_softmax=False,
                               numeric_stable_mode=True):
    """-log softmax(logits) at the hard label along `axis` (a label dim
    of 1 there is squeezed first; 0 at ignore_index), or -sum(label *
    log softmax) with soft labels; the loss keeps the class axis as 1.
    Takes the (N, 1) int64 labels Paddle passes."""
    (logits,) = _amp("softmax_with_cross_entropy", logits)
    logp = torch.log_softmax(logits, dim=axis)
    if soft_label:
        loss = -torch.sum(label * logp, dim=axis, keepdim=True)
    else:
        ax = axis if axis >= 0 else axis + logits.ndim
        lab = label
        if lab.ndim == logits.ndim and lab.shape[ax] == 1:
            lab = lab.squeeze(ax)
        ignored = (lab == ignore_index).unsqueeze(ax)
        safe = torch.where(lab == ignore_index, torch.zeros_like(lab), lab)
        picked = torch.gather(logp, ax, safe.unsqueeze(ax).long())
        loss = torch.where(ignored, torch.zeros_like(picked), -picked)
    if return_softmax:
        return loss, torch.exp(logp)
    return loss


def _cross_entropy2(x, label, soft_label, ignore_index):
    """The cross_entropy2 op: x holds probabilities; -log(p + 1e-12) at
    the label, 0 at ignore_index."""
    eps = 1e-12
    if soft_label:
        return -torch.sum(label * torch.log(x + eps), dim=-1, keepdim=True)
    lab = label[..., 0] if label.ndim == x.ndim and label.shape[-1] == 1 \
        else label
    safe = torch.where(lab == ignore_index, torch.zeros_like(lab), lab)
    picked = torch.gather(x, -1, safe[..., None].long())
    return torch.where((lab == ignore_index)[..., None],
                       torch.zeros_like(picked), -torch.log(picked + eps))


def _apply_class_weight(loss, label, weight, ignore_index, reduction):
    """Hard-label weighting: w_i = weight[y_i] * (y_i != ignore_index);
    'mean' is the weighted mean sum(w_i l_i) / sum(w_i)."""
    lab = (label.squeeze(-1) if label.ndim == loss.ndim
           and label.shape[-1] == 1 else label).long()
    keep = lab != ignore_index
    lw = (weight[lab.clamp(0, weight.shape[0] - 1)] if weight is not None
          else torch.ones(lab.shape, dtype=loss.dtype, device=loss.device))
    lw = torch.where(keep, lw, torch.zeros_like(lw))
    wl = loss * (lw.unsqueeze(-1) if loss.ndim > lw.ndim else lw)
    if reduction == "mean":
        return wl.sum() / torch.clamp(lw.sum(), min=1e-12)
    if reduction == "sum":
        return wl.sum()
    return wl


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True):
    """Paddle's cross_entropy: hard labels of shape (N,) or (N, 1), class
    `weight` and `ignore_index` ('mean' divides by the summed weights),
    or soft labels; `use_softmax=False` takes probabilities."""
    if use_softmax:
        loss = softmax_with_cross_entropy(input, label, soft_label, axis,
                                          ignore_index)
    else:
        loss = _cross_entropy2(input, label, soft_label, ignore_index)
    if soft_label or axis not in (-1, input.ndim - 1):
        if weight is not None:
            raise NotImplementedError(
                "cross_entropy: `weight` needs hard labels and axis=-1")
        return _reduce_loss(loss, reduction)
    return _apply_class_weight(loss, label, weight, ignore_index, reduction)


def mse_loss(input, label, reduction="mean"):
    """The reference's ops: elementwise_sub, elementwise_mul, then the
    reduction."""
    diff = _op("elementwise_sub", {"X": input, "Y": label})
    return _reduce_loss(_op("elementwise_mul", {"X": diff, "Y": diff}),
                        reduction)


def l1_loss(input, label, reduction="mean"):
    return _reduce_loss(torch.abs(input - label), reduction)


def nll_loss(input, label, weight=None, ignore_index=-100,
             reduction="mean"):
    """-w[y_i] logp[i, y_i] over (N, C) log-probabilities, ignored
    targets 0, 'mean' over the applied weights."""
    safe = label.long().clamp(0, input.shape[1] - 1)
    loss = -torch.gather(input, 1, safe[..., None]).squeeze(1)
    return _apply_class_weight(loss, label, weight, ignore_index, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    """The bce_loss op, then elementwise_mul by `weight`."""
    loss = _op("bce_loss", {"X": input, "Label": label})
    if weight is not None:
        loss = _op("elementwise_mul", {"X": loss, "Y": weight})
    return _reduce_loss(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    """The sigmoid_cross_entropy_with_logits op (0 where the label is
    -100), times (y (pos_weight - 1) + 1), then elementwise_mul by
    `weight`.  The pos_weight term is no op of the reference: amp leaves
    it and its label uncast, as there."""
    loss = _op("sigmoid_cross_entropy_with_logits",
               {"X": logit, "Label": label})
    if pos_weight is not None:
        loss = loss * (label * (pos_weight - 1) + 1)
    if weight is not None:
        loss = _op("elementwise_mul", {"X": loss, "Y": weight})
    return _reduce_loss(loss, reduction)


def kl_div(input, label, reduction="mean"):
    """The kldiv_loss op unreduced (target (log target - input) where
    target > 0, else 0), then `reduction`; 'batchmean' sums and divides
    by the batch."""
    loss = _op("kldiv_loss", {"X": input, "Target": label},
               {"reduction": "none"}, slot="Loss")
    if reduction == "batchmean":
        n = loss.shape[0] if loss.ndim > 0 else 1
        return loss.sum() * (1.0 / n)
    return _reduce_loss(loss, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    d = torch.abs(input - label)
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce_loss(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    loss = torch.clamp(-label * (input - other) + margin, min=0.0)
    return _reduce_loss(loss, reduction)
