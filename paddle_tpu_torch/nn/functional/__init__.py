"""`paddle.nn.functional` of the port (counterpart of
paddle_tpu/nn/functional/__init__.py; the tail is `extra.py`, as there).

Where the reference's function runs an op through `trace_op`, the port's
runs the registry's rule of that op type (`_op`, i.e. `tensor._run`), so
the Executor and the eager API share one implementation and the amp
cast follows the op type; where the reference composes jax.numpy in a
`trace_fn`, the port composes torch operations (no cast, as there).  A
few hot functions (linear, relu, softmax, the convolutions and pools,
batch norm) call torch directly at the same cast points.  `linear` keeps Paddle's
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

from ...amp import cast_inputs as _amp
from ...fluid import core
from ...ops.kernels import attention as _attn
from ...ops.kernels import ffn as _ffn


def linear(x, weight, bias=None, name=None):
    """y = x @ weight + bias with weight (in_features, out_features); under
    `amp.auto_cast` the product and the bias add are the reference's two
    ops (matmul_v2, elementwise_add), cast by its lists."""
    x, weight = _amp("matmul_v2", x, weight)
    out = torch.matmul(x, weight)
    if bias is None:
        return out
    out, bias = _amp("elementwise_add", out, bias)
    return out + bias


def _lookup_body(weight, ids, padding_idx):
    """Rows of `weight` at `ids`, zeros where the id equals `padding_idx`
    (-1: none), as the reference's rule masks them (the body of
    F.embedding and the lookup_table rules)."""
    out = torch.nn.functional.embedding(ids, weight)
    if padding_idx != -1:
        out = torch.where((ids == padding_idx)[..., None],
                          torch.zeros_like(out), out)
    return out


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of `weight` at the ids `x` (the lookup_table_v2 op); rows
    whose id equals `padding_idx` read as zeros.  `sparse` changes
    nothing here, as in the reference: the gradient is dense."""
    (weight,) = _amp("lookup_table_v2", weight)
    return _lookup_body(weight, x, -1 if padding_idx is None
                        else padding_idx)


def _layer_norm_body(x, begin_norm_axis, scale=None, bias=None,
                     epsilon=1e-5):
    """Paddle's layer_norm over the dims from `begin_norm_axis`: (y, mean,
    biased variance), y = (x - mean) * rsqrt(var + eps) * scale + bias,
    in x's dtype (the body of F.layer_norm and the layer_norm rule)."""
    axes = tuple(range(begin_norm_axis, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = torch.square(x - mean).mean(dim=axes, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + epsilon)
    norm_shape = x.shape[begin_norm_axis:]
    if scale is not None:
        y = y * (scale if scale.shape == norm_shape
                 else scale.reshape(norm_shape))
    if bias is not None:
        y = y + (bias if bias.shape == norm_shape
                 else bias.reshape(norm_shape))
    return y, mean, var


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """The layer_norm op over the trailing `normalized_shape` dims, its
    inputs cast as the op's are under `amp.auto_cast`."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    x, weight, bias = _amp("layer_norm", x, weight, bias)
    return _layer_norm_body(x, x.ndim - len(normalized_shape), weight, bias,
                            epsilon)[0]


def _op(op_type, ins, attrs=None, slot="Out"):
    """One registered op rule run eagerly (`tensor._run`, which casts the
    inputs by the op's type under `amp.auto_cast`), as the reference's
    functionals run theirs through `trace_op`."""
    from ...tensor import _run
    return _run(op_type, ins, attrs, (slot,))[slot][0]


def gelu(x, approximate=False, name=None):
    """Exact-erf gelu (jax.nn.gelu(approximate=False)), or the tanh form."""
    return _op("gelu", {"X": x}, {"approximate": approximate})


def relu(x, name=None):
    (x,) = _amp("relu", x)
    return torch.relu(x)


def relu6(x, name=None):
    (x,) = _amp("relu6", x)
    return torch.clamp(x, 0.0, 6.0)


def tanh(x, name=None):
    (x,) = _amp("tanh", x)
    return torch.tanh(x)


def softmax(x, axis=-1, dtype=None, name=None):
    (x,) = _amp("softmax", x)
    out = torch.softmax(x, axis)
    return out if dtype is None else out.to(core.torch_dtype(dtype))


def log_softmax(x, axis=-1, dtype=None, name=None):
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


def _dropout_body(x, p, training, upscale, gen):
    """The dropout op's computation (the body of F.dropout and of the
    dropout rule): (out, keep mask or None).  Eval or p == 0: x, times
    1 - p for downscale_in_infer in eval.  Training: a mask drawn from
    `gen` on x's device; kept elements are x / (1 - p) (upscale_in_train)
    or x, dropped ones 0."""
    if not training or p == 0.0:
        if upscale or p == 0.0:
            return x, None
        return x * (1.0 - p), None
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    kept = x / (1.0 - p) if upscale else x
    return torch.where(keep, kept, torch.zeros_like(x)), keep


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, *, generator=None):
    """Dropout as the reference's op computes it (`_dropout_body`):
    `upscale_in_train` scales the kept elements by 1 / (1 - p) and is the
    identity in eval; `downscale_in_infer` keeps them as they are and
    scales by 1 - p in eval.  The mask is elementwise and drawn on x's
    device: from `generator` when it lives there (None: torch's default
    generator of that device), else from a device generator seeded by a
    host draw.  The reference reads no `axis` (its mask stays
    elementwise), so a given one raises.  Under `amp.auto_cast` x is cast
    as the dropout op's inputs are, in eval too."""
    if axis is not None:
        raise NotImplementedError(
            "dropout: the reference reads no `axis` (its mask is "
            "elementwise whatever the argument); ROADMAP queue 3")
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout: unknown mode {mode!r}")
    (x,) = _amp("dropout", x)
    gen = None
    if training and p != 0.0:
        gen = _host_generator(generator)
        if gen is not None and gen.device != x.device:
            gen = _device_generator(gen, x.device)
    return _dropout_body(x, p, training, mode == "upscale_in_train", gen)[0]


def _kernel_seed(generator=None) -> int:
    """A 31-bit seed for an in-kernel dropout hash: a host integer drawn
    from the scope's or the layer's host generator (never a device
    tensor, so no host sync)."""
    return int(torch.randint(0, 2 ** 31 - 1, (1,),
                             generator=_host_generator(generator)))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, *,
                                 generator=None, heads_total=0,
                                 head_offset=0):
    """Fused attention over (batch, seq, heads, head_dim) inputs: the
    flash kernels (forward and backward) on CUDA tensors, their plain
    versions on CPU tensors.  Attention dropout runs in the kernels,
    seeded from the host generator; `heads_total` / `head_offset` give
    the heads' global indices in its hash (a tensor-parallel rank's local
    heads draw the one-process masks of the heads they are)."""
    p = dropout_p if training else 0.0
    seed = _kernel_seed(generator) if p > 0.0 else None
    return _attn.scaled_dot_product_attention(
        query, key, value, mask=attn_mask, is_causal=is_causal,
        dropout_p=p, dropout_seed=seed, heads_total=heads_total,
        head_offset=head_offset)


def fused_feedforward(x, w1, b1, w2, b2, activation="gelu",
                      act_dropout=0.0, training=True, name=None, *,
                      generator=None, col_offset=0):
    """Fused transformer FFN: dropout(act(x@w1+b1), p) @ w2 + b2, through
    `ops.kernels.ffn.fused_ffn` (the library arm by default, the kernels
    once opted in); differentiable in x and the four weights.
    `col_offset`: the d_ff columns' global index in the dropout hash (a
    tensor-parallel rank's columns)."""
    p = act_dropout if training else 0.0
    seed = _kernel_seed(generator) if p > 0.0 else None
    return _ffn.fused_ffn(x, w1, b1, w2, b2, activation=activation,
                          dropout_p=p, dropout_seed=seed,
                          col_offset=col_offset)


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


def _conv2d_core(x, weight, bias=None, stride=1, padding=0, dilation=1,
                 groups=1, data_format="NCHW"):
    """The conv2d op (nn_ops.py:77-103) with no cast: weight OIHW whatever
    the data format; Paddle's padding forms (asymmetric and strided SAME
    padded explicitly, then convolved with padding 0); `bias` added by
    cuDNN on the channel axis."""
    x, back = _channels_first(x, data_format)
    stride, dilation = _pair(stride), _pair(dilation)
    (t, b), (l, r) = _pads(padding, x.shape[2:], weight.shape[2:], stride,
                           dilation)
    if t != b or l != r:
        x = torch.nn.functional.pad(x, (l, r, t, b))
        t = l = 0
    return back(torch.nn.functional.conv2d(x, weight, bias, stride, (t, l),
                                           dilation, groups))


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2-D convolution (paddle_tpu's `conv2d`): the conv2d op, then the
    optional bias on the channel axis."""
    cx, cw = _amp("conv2d", x, weight)
    if bias is None or (cx is x and cw is weight):
        return _conv2d_core(cx, cw, bias, stride, padding, dilation, groups,
                            data_format)
    # cast: the bias add is a plain add outside the op lists, as in the
    # reference, so a bf16 convolution's output meets an f32 bias (f32)
    out = _conv2d_core(cx, cw, None, stride, padding, dilation, groups,
                       data_format)
    return _add_channel_bias(out, bias, 1 if data_format == "NCHW" else 3)


def _conv_transpose_core(x, weight, strides, pads, dilations, groups,
                         output_padding, nhwc=False):
    """The transposed convolution of the conv2d_transpose and
    conv3d_transpose ops: x[i] W[k] lands at i s + k d - pad_low (the
    scatter of nn_ops.py:119-122), weight (in, out / groups, *k), `pads`
    (low, high) a spatial dim; `output_padding` extends the high end by
    that many positions, which take the scatter's contributions there.
    torch's conv_transpose takes symmetric pads with output_padding below
    the stride or dilation; any other form runs unpadded and is cut."""
    nd = weight.ndim - 2
    if nhwc:
        x = x.movedim(-1, 1)
    op_ = [int(v) for v in output_padding] or [0] * nd
    f = (torch.nn.functional.conv_transpose2d if nd == 2
         else torch.nn.functional.conv_transpose3d)
    if all(lo == hi for lo, hi in pads) and all(
            o < max(s, d) for o, s, d in zip(op_, strides, dilations)):
        out = f(x, weight, None, strides, [lo for lo, _ in pads], op_,
                groups, dilations)
    else:
        full = f(x, weight, None, strides, 0, 0, groups, dilations)
        sizes = [full.shape[2 + i] - lo - hi + o
                 for i, ((lo, hi), o) in enumerate(zip(pads, op_))]
        extra = []
        for i in reversed(range(nd)):
            extra += [0, max(0, pads[i][0] + sizes[i] - full.shape[2 + i])]
        if any(extra):
            full = torch.nn.functional.pad(full, extra)
        out = full[(slice(None), slice(None)) + tuple(
            slice(lo, lo + n) for (lo, _), n in zip(pads, sizes))]
    return out.movedim(1, -1) if nhwc else out


def _conv3d_core(x, weight, strides, pads, dilations, groups):
    """The conv3d op: NCDHW, OIDHW weights, (low, high) pads a dim."""
    if any(lo != hi for lo, hi in pads):
        flat = [v for lo_hi in reversed(pads) for v in lo_hi]
        x = torch.nn.functional.pad(x, flat)
        pads = [(0, 0)] * 3
    return torch.nn.functional.conv3d(x, weight, None, strides,
                                      [lo for lo, _ in pads], dilations,
                                      groups)


def _normalize_padding(padding):
    """(paddings, padding_algorithm) of the reference's functional."""
    if isinstance(padding, str):
        return [0, 0], padding.upper()
    if isinstance(padding, int):
        return [padding, padding], "EXPLICIT"
    return list(padding), "EXPLICIT"


def _add_channel_bias(out, bias, axis):
    """out + bias on `axis` (a plain add outside the op lists)."""
    shape = [1] * out.ndim
    shape[axis] = -1
    return out + bias.reshape(shape)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCHW", name=None):
    """The conv2d_transpose op, weight (in, out / groups, kh, kw), then
    the bias.  The reference reads no `output_size`: one that differs
    from the computed size raises."""
    padding, algorithm = _normalize_padding(padding)
    out = _op("conv2d_transpose", {"Input": x, "Filter": weight},
              {"strides": list(_pair(stride)), "paddings": padding,
               "dilations": list(_pair(dilation)), "groups": groups,
               "output_padding": list(_pair(output_padding)),
               "padding_algorithm": algorithm, "data_format": data_format},
              slot="Output")
    _check_output_size(out, output_size, data_format)
    if bias is not None:
        out = _add_channel_bias(out, bias, 1 if data_format == "NCHW"
                                else 3)
    return out


def _check_output_size(out, output_size, data_format):
    if output_size is None:
        return
    sp = (out.shape[2:] if data_format.startswith("NC")
          else out.shape[1:-1])
    want = ([int(output_size)] * len(sp) if isinstance(output_size, int)
            else [int(v) for v in output_size])
    if list(sp) != want:
        raise NotImplementedError(
            f"output_size {want}: the reference reads no output_size and "
            f"gives {list(sp)}")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    """The conv3d op, then the bias on axis 1."""
    padding, algorithm = _normalize_padding3(padding)
    out = _op("conv3d", {"Input": x, "Filter": weight},
              {"strides": _ntuple(stride, 3), "paddings": padding,
               "dilations": _ntuple(dilation, 3), "groups": groups,
               "padding_algorithm": algorithm, "data_format": data_format},
              slot="Output")
    return out if bias is None else _add_channel_bias(out, bias, 1)


def _ntuple(v, n):
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


def _normalize_padding3(padding):
    """(paddings, padding_algorithm) of a 3-D padding: an int pads every
    dim (the reference's conv3d makes it a pair, which its op cannot
    read: ROADMAP queue 3)."""
    if isinstance(padding, str):
        return [0, 0, 0], padding.upper()
    if isinstance(padding, int):
        return [padding] * 3, "EXPLICIT"
    return list(padding), "EXPLICIT"


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
               return_mask=False, data_format="NCHW", name=None):
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
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
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


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Adaptive average pooling over windows [floor(i S / out),
    ceil((i + 1) S / out)) (nn_ops.py:174-187), torch's rule too."""
    (x,) = _amp("pool2d", x)
    x, back = _channels_first(x, data_format)
    return back(torch.nn.functional.adaptive_avg_pool2d(x, output_size))


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
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


def _group_live() -> bool:
    from ...distributed import comm

    return comm.live()


def _sync_batch_norm_train(x, weight, bias, epsilon=1e-5, c_axis=1,
                          group=None):
    """batch_norm_train over the batch of every rank of `group`: each rank
    sums x and x^2 over its own non-channel axes in float32, one
    differentiable all-reduce adds the sums (and the counts) up, and x is
    normalised by the group's mean and BIASED variance E[x^2] - E[x]^2,
    the reference's sync_batch_norm rule (nn_ops.py:279-282); `group`
    defaults to the data axis's.  Returns (y in x's dtype, mean, var,
    1/sqrt(var + eps)), differentiable in x, weight and bias through the
    all-reduce's adjoint."""
    from ...distributed import comm

    if group is None:
        group = comm.default_group()

    axes = [i for i in range(x.ndim) if i != c_axis]
    xf = x.float()
    count = torch.full((1,), float(x.numel() // x.shape[c_axis]),
                       device=x.device)
    stats = comm.all_reduce_sum(torch.cat(
        [xf.sum(axes), (xf * xf).sum(axes), count]), group)
    c = x.shape[c_axis]
    n = stats[2 * c]
    mean = stats[:c] / n
    var = stats[c:2 * c] / n - mean * mean
    inv_std = torch.rsqrt(var + epsilon)
    shape = [1] * x.ndim
    shape[c_axis] = c
    y = (xf - mean.view(shape)) * inv_std.view(shape)
    if weight is not None:
        y = y * weight.float().view(shape)
    if bias is not None:
        y = y + bias.float().view(shape)
    return y.to(x.dtype), mean, var.detach(), inv_std


def batch_norm(x, running_mean, running_var, weight, bias, training=False,
               momentum=0.9, epsilon=1e-5, data_format="NCHW",
               use_global_stats=None, name=None, *, sync_group=False):
    """Batch norm with paddle_tpu's semantics (nn_ops.py:253-300), which
    are not torch's.  In training (unless `use_global_stats`) x is
    normalised by its batch statistics and the running buffers are
    updated IN PLACE as running * momentum + batch * (1 - momentum), with
    the BIASED batch variance, in the buffers' dtype; otherwise by the
    running statistics, which stay as they are.  The channel axis is 1
    for data formats that begin "NC" and the last one otherwise.
    `sync_group` (SyncBatchNorm's): under a process group of more than
    one, the batch statistics are the whole group's
    (_sync_batch_norm_train)."""
    if weight is not None and x.dtype != weight.dtype:
        # the reference's promotion: a bf16 input (an O1 convolution's)
        # normalised with f32 parameters gives f32
        x = x.to(torch.promote_types(x.dtype, weight.dtype))
    c_axis = 1 if data_format.startswith("NC") or data_format == \
        "AnyLayout" else x.ndim - 1
    shape = [1] * x.ndim
    shape[c_axis] = x.shape[c_axis]
    if training and not use_global_stats:
        if sync_group and _group_live():
            y, mean, var, _ = _sync_batch_norm_train(x, weight, bias,
                                                    epsilon, c_axis)
        else:
            y, mean, var, _ = batch_norm_train(x, weight, bias, epsilon,
                                               c_axis)
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
                  use_softmax=True, name=None):
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


def mse_loss(input, label, reduction="mean", name=None):
    """The reference's ops: elementwise_sub, elementwise_mul, then the
    reduction."""
    diff = _op("elementwise_sub", {"X": input, "Y": label})
    return _reduce_loss(_op("elementwise_mul", {"X": diff, "Y": diff}),
                        reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return _reduce_loss(torch.abs(input - label), reduction)


def nll_loss(input, label, weight=None, ignore_index=-100,
             reduction="mean", name=None):
    """-w[y_i] logp[i, y_i] over (N, C) log-probabilities, ignored
    targets 0, 'mean' over the applied weights."""
    safe = label.long().clamp(0, input.shape[1] - 1)
    loss = -torch.gather(input, 1, safe[..., None]).squeeze(1)
    return _apply_class_weight(loss, label, weight, ignore_index, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    """The bce_loss op, then elementwise_mul by `weight`."""
    loss = _op("bce_loss", {"X": input, "Label": label})
    if weight is not None:
        loss = _op("elementwise_mul", {"X": loss, "Y": weight})
    return _reduce_loss(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
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


def kl_div(input, label, reduction="mean", name=None):
    """The kldiv_loss op unreduced (target (log target - input) where
    target > 0, else 0), then `reduction`; 'batchmean' sums and divides
    by the batch."""
    loss = _op("kldiv_loss", {"X": input, "Target": label},
               {"reduction": "none"}, slot="Loss")
    if reduction == "batchmean":
        n = loss.shape[0] if loss.ndim > 0 else 1
        return loss.sum() * (1.0 / n)
    return _reduce_loss(loss, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    d = torch.abs(input - label)
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce_loss(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    loss = torch.clamp(-label * (input - other) + margin, min=0.0)
    return _reduce_loss(loss, reduction)


# -- the activations of the 2.x surface (nn/functional/__init__.py:39-138) ---

def sigmoid(x, name=None):
    return _op("sigmoid", {"X": x})


def leaky_relu(x, negative_slope=0.01, name=None):
    return _op("leaky_relu", {"X": x}, {"alpha": negative_slope})


def elu(x, alpha=1.0, name=None):
    return _op("elu", {"X": x}, {"alpha": alpha})


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    """scale * elu(x, alpha), composed as jax.nn.elu (the reference's
    trace_fn): the exp only sees x <= 0."""
    neg = torch.where(x > 0, torch.zeros_like(x), x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(neg))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return _op("softplus", {"X": x}, {"beta": beta, "threshold": threshold})


def softshrink(x, threshold=0.5, name=None):
    return _op("softshrink", {"X": x}, {"lambda": threshold})


def hardshrink(x, threshold=0.5, name=None):
    return _op("hard_shrink", {"X": x}, {"threshold": threshold})


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return _op("hard_sigmoid", {"X": x}, {"slope": slope, "offset": offset})


def hardswish(x, name=None):
    return _op("hard_swish", {"X": x})


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return _op("clip", {"X": x}, {"min": float(min), "max": float(max)})


def swish(x, name=None):
    return _op("swish", {"X": x})


def silu(x, name=None):
    """The swish op, as the reference runs it."""
    return _op("swish", {"X": x})


def mish(x, name=None):
    return x * torch.tanh(torch.log1p(torch.exp(x)))


def prelu(x, weight, data_format="NCHW", name=None):
    """The prelu op with its default mode 'all', as the reference passes
    it: one alpha (a weight of more than one element raises there and
    here)."""
    return _op("prelu", {"X": x, "Alpha": weight},
               {"data_format": data_format})


def maxout(x, groups, axis=1, name=None):
    return _op("maxout", {"X": x}, {"groups": groups, "axis": axis})


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def thresholded_relu(x, threshold=1.0, name=None):
    return torch.where(x > threshold, x, torch.zeros_like(x))


def glu(x, axis=-1, name=None):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


# -- normalization (nn/functional/__init__.py:291-341) ----------------------

def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """The instance_norm op: each (sample, channel) over its spatial
    dims.  Like the reference, it reads neither the running statistics
    nor `use_input_stats`, `momentum` and `data_format`."""
    ins = {"X": x}
    if weight is not None:
        ins["Scale"] = weight
    if bias is not None:
        ins["Bias"] = bias
    return _op("instance_norm", ins, {"epsilon": eps}, slot="Y")


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    ins = {"X": x}
    if weight is not None:
        ins["Scale"] = weight
    if bias is not None:
        ins["Bias"] = bias
    return _op("group_norm", ins, {"epsilon": epsilon, "groups": num_groups},
               slot="Y")


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """x over max(its p-norm along `axis`, epsilon)."""
    norm = torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=True)
    return x / torch.clamp(norm, min=epsilon)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """x / (k + alpha * (the sum of x^2 over `size` channels, zero padded
    size // 2 below and size - size // 2 - 1 above))^beta, on axis 1
    (the reference reads no data_format)."""
    sq = torch.square(x)
    half = size // 2
    pads = [0, 0] * (x.ndim - 2) + [half, size - half - 1]
    sq = torch.nn.functional.pad(sq, pads)
    acc = sq.narrow(1, 0, x.shape[1])
    for i in range(1, size):
        acc = acc + sq.narrow(1, i, x.shape[1])
    return x / torch.pow(k + alpha * acc, beta)


# -- dropout variants, masks, embedding helpers -------------------------------

def _channel_dropout(x, p, training, c_axis, generator):
    """Whole channels (every axis but 0 and `c_axis` shares a draw)
    zeroed with probability p, the rest scaled by 1 / (1 - p)."""
    if not training or p == 0:
        return x
    gen = _host_generator(generator)
    if gen is not None and gen.device != x.device:
        gen = _device_generator(gen, x.device)
    shape = [1] * x.ndim
    shape[0], shape[c_axis] = x.shape[0], x.shape[c_axis]
    keep = torch.rand(shape, generator=gen, device=x.device) >= p
    return torch.where(keep, x / (1 - p), torch.zeros_like(x))


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None, *,
              generator=None):
    """Channel dropout on (N, C, H, W) (or NHWC): one draw a (sample,
    channel); torch's bits, not the reference's jax.random ones."""
    return _channel_dropout(x, p, training, 1 if data_format == "NCHW"
                            else 3, generator)


def one_hot(x, num_classes, name=None):
    return _op("one_hot_v2", {"X": x}, {"depth": num_classes})


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    ins = {"X": label}
    if prior_dist is not None:
        ins["PriorDist"] = prior_dist
    return _op("label_smooth", ins, {"epsilon": epsilon})


# -- padding, resizing, patches (nn/functional/__init__.py:586-676) ----------

def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """The reference's pad: `pad` as (low, high) pairs of every dim from
    the first when it has 2 x.ndim values, else of the trailing len(pad)
    / 2 dims innermost first (torch's order); modes constant, reflect,
    replicate and circular."""
    pad = [int(v) for v in pad]
    if len(pad) == 2 * x.ndim:
        flat = []
        for i in reversed(range(x.ndim)):
            flat += [pad[2 * i], pad[2 * i + 1]]
        pad = flat
        while len(pad) > 2 and pad[-2:] == [0, 0]:
            pad = pad[:-2]
    if mode == "constant":
        return torch.nn.functional.pad(x, pad, value=value)
    if mode not in ("reflect", "replicate", "circular"):
        raise ValueError(f"pad: unknown mode {mode!r}")
    lead = x.ndim - len(pad) // 2
    if lead < 1 or (mode != "circular" and lead < 2):
        # torch pads these modes only behind batch (and channel) dims
        y = torch.nn.functional.pad(x.reshape((1,) * 2 + tuple(x.shape)),
                                    pad, mode=mode)
        return y.reshape(y.shape[2:])
    return torch.nn.functional.pad(x, pad, mode=mode)


def _resize_kernel(method):
    """jax.image.resize's kernels for the methods the reference sends
    there (the interpolation modes it has no op for)."""
    if method in ("linear", "bilinear", "trilinear", "triangle"):
        return lambda v: torch.clamp(1.0 - torch.abs(v), min=0.0)
    if method in ("cubic", "bicubic", "tricubic"):
        def keys(v):
            v = torch.abs(v)
            out = ((1.5 * v - 2.5) * v) * v + 1.0
            out = torch.where(v >= 1.0, ((-0.5 * v + 2.5) * v - 4.0) * v
                              + 2.0, out)
            return torch.where(v >= 2.0, torch.zeros_like(v), out)
        return keys
    if method in ("lanczos3", "lanczos5"):
        r = float(method[-1])
        return lambda v: torch.where(v < r, torch.sinc(v) * torch.sinc(v / r),
                                     torch.zeros_like(v))
    raise ValueError(f"interpolate: unknown mode {method!r}")


def _image_resize(x, size, method):
    """jax.image.resize of (N, C, H, W) to (oh, ow) by `method` with its
    default antialiasing: each resized axis contracts with a weight
    matrix over the half-pixel sample positions, the kernel widened by
    in / out when shrinking, the weights normalised a column and zeroed
    for samples outside the input."""
    kernel = _resize_kernel(method)
    out = x
    for axis, osz in ((2, int(size[0])), (3, int(size[1]))):
        isz = x.shape[axis]
        if isz == osz:
            continue
        dt = torch.promote_types(x.dtype, torch.float32)
        inv = isz / osz
        sample = (torch.arange(osz, dtype=dt) + 0.5) * inv - 0.5
        v = torch.abs(sample[None, :] - torch.arange(isz, dtype=dt)[:, None]
                      ) / max(inv, 1.0)
        w = kernel(v)
        tot = w.sum(dim=0, keepdim=True)
        w = torch.where(torch.abs(tot) > 1000.0 * float(
            torch.finfo(torch.float32).eps),
            w / torch.where(tot != 0, tot, torch.ones_like(tot)),
            torch.zeros_like(w))
        w = torch.where(((sample >= -0.5) & (sample <= isz - 0.5))[None, :],
                        w, torch.zeros_like(w))
        out = torch.movedim(torch.tensordot(out, w.to(x.device, out.dtype),
                                            dims=([axis], [0])), -1, axis)
    return out


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """nearest and bilinear: the nearest_interp_v2 / bilinear_interp_v2
    ops.  Other modes go, as in the reference, to jax.image.resize's
    method of that name on (N, C, H, W) (`_image_resize`)."""
    op = {"nearest": "nearest_interp_v2",
          "bilinear": "bilinear_interp_v2"}.get(mode)
    if op is None:
        h, w = x.shape[2], x.shape[3]
        oh, ow = (size if size is not None
                  else (int(h * scale_factor), int(w * scale_factor)))
        return _image_resize(x, (oh, ow), mode)
    attrs = {"align_corners": align_corners, "align_mode": align_mode,
             "data_layout": data_format}
    if size is not None:
        attrs["out_h"], attrs["out_w"] = int(size[0]), int(size[1])
    else:
        attrs["scale"] = (list(scale_factor)
                          if isinstance(scale_factor, (list, tuple))
                          else [float(scale_factor)] * 2)
    return _op(op, {"X": x}, attrs)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    """(N, C r^2, H, W) -> (N, C, H r, W r), composed as the reference's
    trace_fn (which reads no data_format)."""
    r = upscale_factor
    n, c, h, w = x.shape
    return x.reshape(n, c // (r * r), r, r, h, w).permute(
        0, 1, 4, 2, 5, 3).reshape(n, c // (r * r), h * r, w * r)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col (N, C kh kw, L), symmetric paddings, as the reference's
    trace_fn."""
    ks, st, pd, dl = (_ntuple(v, 2) for v in (kernel_sizes, strides,
                                               paddings, dilations))
    return torch.nn.functional.unfold(x, ks[:2], dl[:2], pd[:2], st[:2])


# -- losses and misc (nn/functional/__init__.py:579, 753-805) -----------------

def log_loss(input, label, epsilon=1e-4, name=None):
    """-y log(x + eps) - (1 - y) log1p(eps - x), the reference's
    composition (not the log_loss op)."""
    return -label * torch.log(input + epsilon) \
        - (1 - label) * torch.log1p(epsilon - input)


def square_error_cost(input, label):
    diff = _op("elementwise_sub", {"X": input, "Y": label})
    return _op("elementwise_mul", {"X": diff, "Y": diff})


def diag_embed(input, offset=0, dim1=-2, dim2=-1):
    """The last dim on the diagonal of a new trailing square; the
    reference reads no offset or dims: other ones raise."""
    if offset != 0 or (dim1 % (input.ndim + 1), dim2 % (input.ndim + 1)) \
            != (input.ndim - 1, input.ndim):
        raise NotImplementedError(
            "diag_embed: the reference reads no offset, dim1 or dim2")
    return torch.diag_embed(input)


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    """(N T, C, H, W): the first C ratio channels take t + 1's values
    (zeros at the end), the next C ratio t - 1's (zeros at the start),
    as the reference's functional composes it; not the temporal_shift
    op, which shifts the other way."""
    nt, c, h, w = x.shape
    x5 = x.reshape(nt // seg_num, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    left = torch.cat([x5[:, 1:, :fold], torch.zeros_like(x5[:, :1, :fold])],
                     dim=1)
    right = torch.cat([torch.zeros_like(x5[:, :1, fold:2 * fold]),
                       x5[:, :-1, fold:2 * fold]], dim=1)
    return torch.cat([left, right, x5[:, :, 2 * fold:]], dim=2).reshape(
        nt, c, h, w)


def _reexport_fluid_layers():
    """The reference re-exports these names of its fluid.layers
    (nn/functional/__init__.py:811-838); the port re-exports those its
    fluid.layers has."""
    import sys

    from ...fluid import layers as _L

    mod = sys.modules[__name__]
    for n in _REEXPORTED:
        if not hasattr(mod, n) and hasattr(_L, n):
            setattr(mod, n, getattr(_L, n))


# (generate_proposals is then replaced by extra.py's, as in the reference)
_REEXPORTED = [
    "anchor_generator", "array_length", "array_read", "array_write",
    "assign", "bipartite_match", "box_clip", "box_coder", "create_array",
    "detection_output", "dynamic_gru", "dynamic_lstm", "erf", "fc",
    "generate_proposals", "grid_sampler", "image_resize",
    "linear_chain_crf", "multiclass_nms", "pad2d", "pool2d", "prior_box",
    "resize_bilinear", "resize_nearest", "roi_align", "sequence_concat",
    "sequence_conv", "sequence_enumerate", "sequence_expand",
    "sequence_expand_as", "sequence_first_step", "sequence_last_step",
    "sequence_pad", "sequence_pool", "sequence_reverse", "sequence_slice",
    "sequence_softmax", "sequence_unpad", "sigmoid_focal_loss", "smooth_l1",
    "warpctc", "yolo_box", "yolov3_loss",
]

_reexport_fluid_layers()
del _reexport_fluid_layers

from .extra import *  # noqa: E402,F401,F403 - the functional tail
from .extra import bilinear, hash  # noqa: E402,F401,A004
