"""The tail of `paddle.nn.functional` (counterpart of
paddle_tpu/nn/functional/extra.py): wrappers over the registry's rules
(`_op`), torch compositions where the reference composes jax.numpy, and
the reference's guards for the names it does not carry (they raise
NotImplementedError with the same reason and alternative), and the
detection tail over the detection rules (the ROI pools,
polygon_box_transform, generate_proposals and its kin), each running its
op with no output slot declared, as the reference's trace_op does.
"""

from __future__ import annotations

import torch

from . import (_add_channel_bias, _channel_dropout, _normalize_padding3,
               _ntuple, _op, avg_pool2d, conv2d, conv2d_transpose,
               max_pool2d)

__all__ = []  # filled by _export


def _export(fn):
    __all__.append(fn.__name__)
    return fn


# -- activations / elementwise --------------------------------------------------

@_export
def log_sigmoid(x, name=None):
    return torch.nn.functional.logsigmoid(x)


@_export
def softsign(x, name=None):
    return x / (1 + torch.abs(x))


@_export
def soft_relu(x, threshold=40.0, name=None):
    return torch.log1p(torch.exp(torch.clamp(x, -threshold, threshold)))


@_export
def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    na = torch.linalg.vector_norm(x1, dim=axis, keepdim=True)
    nb = torch.linalg.vector_norm(x2, dim=axis, keepdim=True)
    denom = torch.clamp(na * nb, min=eps)
    return (torch.sum(x1 * x2, dim=axis, keepdim=True).squeeze(axis)
            / denom.squeeze(axis))


# -- losses ----------------------------------------------------------------------

@_export
def dice_loss(input, label, epsilon=1e-5, name=None):
    """The mean over samples of 1 - (2 |x y| + eps) / (|x| + |y| + eps),
    y the one-hot labels over the last dim."""
    lab = label.squeeze(-1) if label.shape[-1] == 1 else label
    yf = torch.nn.functional.one_hot(lab.long(), input.shape[-1]).to(
        input.dtype)
    red = tuple(range(1, input.ndim))
    inter = torch.sum(input * yf, dim=red)
    union = torch.sum(input, dim=red) + torch.sum(yf, dim=red)
    return torch.mean(1 - (2 * inter + epsilon) / (union + epsilon))


@_export
def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """Softmax cross-entropy of the anchor-positive similarities against
    the label-equality targets, plus l2_reg times the embeddings' mean
    squared norms over 2."""
    sim = anchor @ positive.T
    same = (labels[:, None] == labels[None, :]).to(anchor.dtype)
    tgt = same / torch.sum(same, dim=1, keepdim=True)
    ce = torch.mean(torch.sum(-tgt * torch.log_softmax(sim, dim=1), dim=1))
    reg = l2_reg * (torch.mean(torch.sum(anchor * anchor, dim=1))
                    + torch.mean(torch.sum(positive * positive, dim=1))) / 2
    return ce + reg


@_export
def fsp_matrix(x, y):
    """(B, Cx, Cy): the channels' Gram over the spatial positions, over
    their count."""
    b, cx, h, w = x.shape
    return torch.einsum("bxs,bys->bxy", x.reshape(b, cx, h * w),
                        y.reshape(b, y.shape[1], h * w)) / (h * w)


@_export
def bpr_loss(input, label, name=None):
    return _op("bpr_loss", {"X": input, "Label": label}, slot="Y")


@_export
def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    return _op("teacher_student_sigmoid_loss", {"X": input, "Label": label},
               {"soft_max_up_bound": soft_max_up_bound,
                "soft_max_lower_bound": soft_max_lower_bound}, slot="Y")


@_export
def shuffle_channel(x, group, name=None):
    return _op("shuffle_channel", {"X": x}, {"group": group})


@_export
def random_crop(x, shape, seed=None):
    return _op("random_crop", {"X": x}, {"shape": list(shape),
                                         "startup_seed": int(seed or 0)})


@_export
def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    return _op("add_position_encoding", {"X": input},
               {"alpha": alpha, "beta": beta})


@_export
def continuous_value_model(input, cvm, use_cvm=True):
    return _op("cvm", {"X": input, "CVM": cvm}, {"use_cvm": use_cvm},
               slot="Y")


_CENTER_BUFFERS = {}


@_export
def center_loss(input, label, num_classes, alpha, param_attr=None,
                update_center=True):
    """The center_loss op over a module-level float32 centers buffer a
    (num_classes, dim), as in the reference (which keeps no updated
    centers: the buffer stays zero); returns the loss a sample."""
    key = (num_classes, int(input.shape[-1]))
    buf = _CENTER_BUFFERS.setdefault(key, torch.zeros(key))
    rate = torch.tensor([alpha], dtype=torch.float32)
    return _op("center_loss",
               {"X": input, "Label": label, "Centers": buf.to(input.device),
                "CenterUpdateRate": rate.to(input.device)},
               {"cluster_num": num_classes,
                "need_update": bool(update_center)}, slot="Loss")


@_export
def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean"):
    """The warpctc op over (T, B, C) logits; 'mean' averages each loss
    over its label length (at least 1)."""
    loss = _op("warpctc", {"Logits": log_probs, "Label": labels,
                           "LogitsLength": input_lengths,
                           "LabelLength": label_lengths}, {"blank": blank},
               slot="Loss")
    if reduction == "mean":
        n = torch.clamp(label_lengths.to(loss.dtype), min=1)
        return torch.mean(loss.reshape(-1) / n)
    if reduction == "sum":
        return torch.sum(loss)
    return loss


@_export
def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    ins = {"X": input, "Label": label, "W": weight}
    if bias is not None:
        ins["Bias"] = bias
    if path_table is not None:
        ins["PathTable"] = path_table
    if path_code is not None:
        ins["PathCode"] = path_code
    return _op("hierarchical_sigmoid", ins, {"num_classes": num_classes})


@_export
def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=None, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False,
        weight=None, bias=None):
    """The nce op with the uniform sampler (the only one the reference
    runs), `num_neg_samples` (10 by default) drawn from the op's
    generator."""
    ins = {"Input": input, "Label": label, "Weight": weight}
    if bias is not None:
        ins["Bias"] = bias
    return _op("nce", ins, {"num_total_classes": num_total_classes,
                            "num_neg_samples": num_neg_samples or 10,
                            "seed": seed, "sampler": 0}, slot="Cost")


# -- conv / pool family ---------------------------------------------------------

def _first(v):
    return v if isinstance(v, (int, str)) else v[0]


@_export
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    """(B, C, L) convolution as conv2d over (B, C, 1, L)."""
    p = _first(padding)
    out = conv2d(x.unsqueeze(2), weight.unsqueeze(2), bias=bias,
                 stride=[1, _first(stride)],
                 padding=p if isinstance(p, str) else [0, p],
                 dilation=[1, _first(dilation)], groups=groups)
    return out.squeeze(2)


@_export
def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    out = conv2d_transpose(x.unsqueeze(2), weight.unsqueeze(2), bias=bias,
                           stride=[1, _first(stride)],
                           padding=[0, _first(padding)],
                           output_padding=[0, _first(output_padding)],
                           dilation=[1, _first(dilation)], groups=groups)
    return out.squeeze(2)


@_export
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    """The conv3d_transpose op.  Like the reference, it passes no
    `output_padding` to the op (and reads no `output_size`): a nonzero
    one raises."""
    if any(_ntuple(output_padding, 3)) or output_size is not None:
        raise NotImplementedError(
            "conv3d_transpose: the reference passes no output_padding or "
            "output_size to its op")
    padding, algorithm = _normalize_padding3(padding)
    out = _op("conv3d_transpose", {"Input": x, "Filter": weight},
              {"strides": _ntuple(stride, 3), "paddings": padding,
               "dilations": _ntuple(dilation, 3), "groups": groups,
               "padding_algorithm": algorithm, "data_format": data_format},
              slot="Output")
    return out if bias is None else _add_channel_bias(out, bias, 1)


def _pool1d(x, kernel_size, stride, padding, pooling_type, ceil_mode):
    k = _first(kernel_size)
    s = _first(stride if stride is not None else k)
    p = _first(padding)
    f = max_pool2d if pooling_type == "max" else avg_pool2d
    out = f(x.unsqueeze(2), [1, k], stride=[1, s],
            padding=p if isinstance(p, str) else [0, p],
            ceil_mode=ceil_mode)
    return out.squeeze(2)


@_export
def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    """max_pool2d over (B, C, 1, L); like the reference it gives no mask
    (return_mask raises)."""
    if return_mask:
        raise NotImplementedError("return_mask=True is not supported")
    return _pool1d(x, kernel_size, stride, padding, "max", ceil_mode)


@_export
def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    """avg_pool2d over (B, C, 1, L); the reference passes no `exclusive`
    (it pools exclusive): False raises."""
    if not exclusive:
        raise NotImplementedError(
            "avg_pool1d: the reference pools exclusive whatever `exclusive`")
    return _pool1d(x, kernel_size, stride, padding, "avg", ceil_mode)


def _pool3d(x, kernel_size, stride, padding, pooling_type, ceil_mode,
            exclusive=True, global_pooling=False):
    stride = stride if stride is not None else kernel_size
    padding, algorithm = _normalize_padding3(padding)
    return _op("pool3d", {"X": x},
               {"pooling_type": pooling_type,
                "ksize": _ntuple(kernel_size, 3),
                "strides": _ntuple(stride, 3), "paddings": padding,
                "padding_algorithm": algorithm, "ceil_mode": ceil_mode,
                "exclusive": exclusive, "adaptive": False,
                "global_pooling": global_pooling})


@_export
def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    if return_mask:
        raise NotImplementedError("return_mask=True is not supported")
    return _pool3d(x, kernel_size, stride, padding, "max", ceil_mode)


@_export
def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    """The pool3d op, exclusive: the reference passes neither `exclusive`
    nor `divisor_override`, so other values raise."""
    if not exclusive or divisor_override is not None:
        raise NotImplementedError(
            "avg_pool3d: the reference pools exclusive and reads no "
            "divisor_override")
    return _pool3d(x, kernel_size, stride, padding, "avg", ceil_mode)


def _adaptive(x, output_size, spatial, ptype):
    from ...ops.nn_ops import _adaptive as pool

    return pool(x, ptype, _ntuple(output_size, spatial))


@_export
def adaptive_avg_pool1d(x, output_size, name=None):
    """Windows [floor(i S / out), ceil((i + 1) S / out)): the reference's
    region split, torch's too."""
    return _adaptive(x, output_size, 1, "avg")


@_export
def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    if return_mask:
        raise NotImplementedError("return_mask=True is not supported")
    return _adaptive(x, output_size, 1, "max")


@_export
def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, 3, "avg")


@_export
def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    if return_mask:
        raise NotImplementedError("return_mask=True is not supported")
    return _adaptive(x, output_size, 3, "max")


# -- vision / geometry ----------------------------------------------------------

@_export
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    return _op("grid_sampler", {"X": x, "Grid": grid},
               {"mode": mode, "padding_mode": padding_mode,
                "align_corners": align_corners}, slot="Output")


@_export
def affine_grid(theta, out_shape, align_corners=True, name=None):
    attrs = {"align_corners": align_corners}
    ins = {"Theta": theta}
    if isinstance(out_shape, torch.Tensor):
        ins["OutputShape"] = out_shape
    else:
        attrs["output_shape"] = [int(v) for v in out_shape]
    return _op("affine_grid", ins, attrs, slot="Output")


@_export
def affine_channel(x, scale=None, bias=None, data_layout="NCHW", name=None):
    return _op("affine_channel", {"X": x, "Scale": scale, "Bias": bias},
               {"data_layout": data_layout})


@_export
def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    """The inverse of pixel_shuffle: (B, C, H, W) -> (B, C r^2, H / r, W /
    r)."""
    r = int(downscale_factor)
    b, c, h, w = x.shape
    return x.reshape(b, c, h // r, r, w // r, r).permute(
        0, 1, 3, 5, 2, 4).reshape(b, c * r * r, h // r, w // r)


@_export
def space_to_depth(x, blocksize, name=None):
    return _op("space_to_depth", {"X": x}, {"blocksize": blocksize})


@_export
def deformable_conv(x, offset, mask, weight, bias=None, stride=1, padding=0,
                    dilation=1, deformable_groups=1, groups=1, im2col_step=1,
                    name=None):
    ins = {"Input": x, "Offset": offset, "Filter": weight}
    if mask is not None:
        ins["Mask"] = mask
    out = _op("deformable_conv", ins,
              {"strides": _ntuple(stride, 2), "paddings": _ntuple(padding, 2),
               "dilations": _ntuple(dilation, 2),
               "deformable_groups": deformable_groups, "groups": groups,
               "im2col_step": im2col_step}, slot="Output")
    return out if bias is None else _add_channel_bias(out, bias, 1)


@_export
def resize_trilinear(input, out_shape=None, scale=None, name=None,
                     actual_shape=None, align_corners=True, align_mode=1,
                     data_format="NCDHW"):
    if out_shape is not None:
        d, h, w = [int(v) for v in out_shape]
    elif scale is not None:
        d, h, w = [int(s * scale) for s in input.shape[2:5]]
    else:
        raise ValueError("resize_trilinear needs out_shape or scale")
    return _op("trilinear_interp", {"X": input},
               {"out_d": d, "out_h": h, "out_w": w,
                "align_corners": align_corners, "align_mode": align_mode,
                "data_layout": data_format})


@_export
def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """Resized so that the short side is `out_short_len`, the aspect
    kept (corners aligned)."""
    h, w = int(input.shape[2]), int(input.shape[3])
    short = min(h, w)
    oh = int(round(h * out_short_len / short))
    ow = int(round(w * out_short_len / short))
    op = "bilinear_interp" if resample.upper() == "BILINEAR" \
        else "nearest_interp"
    return _op(op, {"X": input}, {"out_h": oh, "out_w": ow,
                                  "align_corners": True, "align_mode": 1})


# -- op wrappers of the other buckets the port has --------------------------------

@_export
def bilinear_tensor_product(x, y, weight, bias=None, name=None):
    ins = {"X": x, "Y": y, "Weight": weight}
    if bias is not None:
        ins["Bias"] = bias
    return _op("bilinear_tensor_product", ins)


bilinear = bilinear_tensor_product
__all__.append("bilinear")


@_export
def row_conv(input, weight, act=None):
    out = _op("row_conv", {"X": input, "Filter": weight})
    return _op(act, {"X": out}) if act else out


@_export
def spectral_norm(weight, u, v, dim=0, power_iters=1, eps=1e-12, name=None):
    return _op("spectral_norm", {"Weight": weight, "U": u, "V": v},
               {"dim": dim, "power_iters": power_iters, "eps": eps})


@_export
def data_norm(input, batch_size, batch_sum, batch_square_sum, epsilon=1e-4,
              name=None):
    """The data_norm op's outputs {"Y", "Means", "Scales": [tensor]}: the
    reference's trace_op hands back every slot of an op with several."""
    from ...tensor import _run

    return _run("data_norm", {"X": input, "BatchSize": batch_size,
                              "BatchSum": batch_sum,
                              "BatchSquareSum": batch_square_sum},
                {"epsilon": epsilon}, ("Y", "Means", "Scales"))


@_export
def gru_unit(input, hidden, weight, bias=None, activation="tanh",
             gate_activation="sigmoid", origin_mode=False):
    """The gru_unit op with the reference's attrs.  Its rule reads the
    activations as the op's integer codes, so the default names raise
    ValueError there and here."""
    from ...tensor import _run

    ins = {"Input": input, "HiddenPrev": hidden, "Weight": weight}
    if bias is not None:
        ins["Bias"] = bias
    outs = _run("gru_unit", ins,
                {"activation": activation, "gate_activation": gate_activation,
                 "origin_mode": origin_mode},
                ("Hidden", "ResetHiddenPrev", "Gate"))
    return outs["Hidden"][0], outs["ResetHiddenPrev"][0], outs["Gate"][0]


@_export
def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """The lstm_unit op over gate pre-activations x_t (the projection is
    outside the op, as in the reference): (h, c)."""
    from ...tensor import _run

    outs = _run("lstm_unit", {"X": x_t, "C_prev": cell_t_prev},
                {"forget_bias": forget_bias}, ("H", "C"))
    return outs["H"][0], outs["C"][0]


@_export
def pad_constant_like(x, y, pad_value=0.0, name=None):
    return _op("pad_constant_like", {"X": x, "Y": y},
               {"pad_value": float(pad_value)})


# -- the sequence and control-flow buckets' eager forms ----------------------------

@_export
def sequence_reshape(input, new_dim):
    x = input[0] if isinstance(input, tuple) else input
    return _op("sequence_reshape", {"X": x}, {"new_dim": new_dim})


@_export
def sequence_scatter(input, index, updates, name=None):
    return _op("sequence_scatter",
               {"X": input, "Ids": index, "Updates": updates})


@_export
def im2sequence(input, filter_size=1, stride=1, padding=0,
                input_image_size=None, out_stride=1, name=None):
    return _op("im2sequence", {"X": input},
               {"kernels": _ntuple(filter_size, 2),
                "strides": _ntuple(stride, 2),
                "paddings": _ntuple(padding, 4)})


@_export
def lod_reset(x, y=None, target_lod=None):
    ins = {"X": x}
    if y is not None:
        ins["Y"] = y
    return _op("lod_reset", ins, {"target_lod": target_lod or []})


@_export
def tensor_array_to_tensor(input, axis=1, use_stack=False, name=None):
    """(out, index) of an eager array, a list of same-shape tensors:
    stacked on a new axis 0 under `use_stack`, else concatenated along
    `axis` (the reference hands its rule the list, which reads a
    buffer, and raises AttributeError)."""
    from ...ops.control_flow_ops import array_to_tensor

    return array_to_tensor(torch.stack(list(input)), axis, use_stack)


# -- dropout variants (torch's bits, not the reference's jax.random ones) --------

@_export
def alpha_dropout(x, p=0.5, training=True, name=None, *, generator=None):
    """SELU-preserving dropout: a dropped element becomes -alpha scale,
    then a x + b with a = ((1 - p)(1 + p alpha_p^2))^-1/2 and b = -a
    alpha_p p."""
    if not training or p == 0.0:
        return x
    from . import _device_generator, _host_generator

    gen = _host_generator(generator)
    if gen is not None and gen.device != x.device:
        gen = _device_generator(gen, x.device)
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    a = (1 / ((1 - p) * (1 + p * alpha_p ** 2))) ** 0.5
    b = -a * alpha_p * p
    return (a * torch.where(keep, x, torch.full_like(x, alpha_p))
            + b).to(x.dtype)


@_export
def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None, *,
              generator=None):
    """Channel dropout on 5-D input: one draw a (sample, channel)."""
    return _channel_dropout(x, p, training, 1 if data_format == "NCDHW"
                            else 4, generator)


# -- the reference's guards for names it does not carry -------------------------

def _na(name, why, alternative):
    def fn(*a, **k):
        raise NotImplementedError(
            f"paddle.nn.functional.{name} is not carried by this build: "
            f"{why}. Use instead: {alternative}")

    fn.__name__ = name
    __all__.append(name)
    return fn


hash = _na(  # noqa: A001 - the reference's name shadows the builtin
    "hash", "xxhash sparse-id hashing belongs to the parameter-server "
    "sparse-embedding path", "dense embedding lookups "
    "(paddle.nn.functional.embedding)")
filter_by_instag = _na(
    "filter_by_instag", "instance-tag filtering is part of the PS "
    "sparse-feature pipeline", "boolean masking with paddle.masked_select")
similarity_focus = _na(
    "similarity_focus", "a rarely-used CUDA op with data-dependent "
    "output patterns that defeat XLA static shapes",
    "explicit masking built from paddle.topk indices")
roi_perspective_transform = _na(
    "roi_perspective_transform", "rotated-ROI warping (RRPN) needs "
    "data-dependent gather patterns kept out of the static-shape op "
    "set", "paddle.nn.functional.grid_sample with precomputed grids")
deformable_roi_pooling = _na(
    "deformable_roi_pooling", "superseded by deformable_conv + "
    "roi_align in the supported detection path",
    "paddle.nn.functional.deformable_conv / roi_align")
multi_box_head = _na(
    "multi_box_head", "the SSD head builder creates parameters, which "
    "is a static-graph (LayerHelper) affair",
    "paddle.static.nn.multi_box_head (implemented) inside a static "
    "program, or prior_box + nn.Conv2D composition in dygraph")
merge_selected_rows = _na(
    "merge_selected_rows", "SelectedRows never materializes here "
    "(gradients are dense on TPU)", "dense tensors directly")
reorder_lod_tensor_by_rank = _na(
    "reorder_lod_tensor_by_rank", "LoD metadata is replaced by dense "
    "padding + explicit lengths", "paddle.gather over a rank index")
lod_append = _na(
    "lod_append", "LoD metadata is replaced by dense padding + "
    "explicit lengths", "sequence_pad / explicit length tensors")
dynamic_lstmp = _na(
    "dynamic_lstmp", "LoD-ragged projection LSTM; the dense-batch "
    "path covers the capability", "paddle.nn.LSTM (with projection "
    "via a Linear on outputs) over padded batches")
autoincreased_step_counter = _na(
    "autoincreased_step_counter", "global step state lives in the "
    "optimizer state pytree on TPU (host-side counters would break "
    "the fused step)", "the optimizer's own step counter "
    "(state['t']) or paddle.optimizer.lr schedulers")


# -- cell drivers (reference nn/functional/rnn.py) -------------------------------

@_export
def rnn(cell, inputs, initial_states=None, sequence_length=None,
        time_major=False, is_reverse=False, **kwargs):
    from ..layer.rnn import RNN

    return RNN(cell, is_reverse=is_reverse, time_major=time_major)(
        inputs, initial_states, sequence_length)


@_export
def birnn(cell_fw, cell_bw, inputs, initial_states=None,
          sequence_length=None, time_major=False, **kwargs):
    from ..layer.rnn import BiRNN

    return BiRNN(cell_fw, cell_bw, time_major=time_major)(
        inputs, initial_states, sequence_length)


@_export
def lstm(input, init_h, init_c, weight, bias=None, hidden_size=None,
         num_layers=1, dropout_prob=0.0, is_bidirec=False, **kwargs):
    """The lstm op with the reference's slots and attrs: (Out, LastH,
    LastC), the last two None where the op gives none."""
    from ...tensor import _run

    ins = {"Input": input, "Weight": weight}
    if bias is not None:
        ins["Bias"] = bias
    if init_h is not None:
        ins["InitH"] = init_h
    if init_c is not None:
        ins["InitC"] = init_c
    outs = _run("lstm", ins, {"hidden_size": hidden_size or 0,
                              "num_layers": num_layers,
                              "dropout_prob": dropout_prob,
                              "is_bidirec": is_bidirec},
                ("Out", "LastH", "LastC"))
    # the lstm rule gives Hidden and Cell, no Out: KeyError, as in the
    # reference
    return (outs["Out"][0], outs.get("LastH", [None])[0],
            outs.get("LastC", [None])[0])


@_export
def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, data_format="NCDHW", name=None):
    """The legacy fluid-style signature over the pool3d op, which pools
    exclusive: the reference passes no `exclusive`, so False raises."""
    if not exclusive:
        raise NotImplementedError(
            "pool3d: the reference passes no exclusive attr")
    return _pool3d(input, pool_size, pool_stride, pool_padding, pool_type,
                   ceil_mode, exclusive, global_pooling)


# -- the detection tail (the reference's extra.py:484-518, 863-1037) -------------

def _det(op_type, ins, attrs):
    """The rule's {slot: [tensors]}, run as the reference's trace_op runs
    it: the op declares no output slot."""
    from ...tensor import _run

    return _run(op_type, ins, attrs, ())


@_export
def roi_pool(x, boxes, boxes_num=None, output_size=1, spatial_scale=1.0,
             name=None):
    osz = ([output_size] * 2 if isinstance(output_size, int)
           else list(output_size))
    return _det("roi_pool", {"X": x, "ROIs": boxes},
                {"pooled_height": osz[0], "pooled_width": osz[1],
                 "spatial_scale": spatial_scale})["Out"][0]


@_export
def prroi_pool(x, boxes, output_channels=None, spatial_scale=1.0,
               pooled_height=1, pooled_width=1, batch_roi_nums=None,
               name=None):
    return _det("prroi_pool", {"X": x, "ROIs": boxes},
                {"pooled_height": pooled_height,
                 "pooled_width": pooled_width,
                 "spatial_scale": spatial_scale})["Out"][0]


@_export
def psroi_pool(x, boxes, boxes_num=None, output_channels=1,
               spatial_scale=1.0, pooled_height=1, pooled_width=1,
               name=None):
    return _det("psroi_pool", {"X": x, "ROIs": boxes},
                {"output_channels": output_channels,
                 "pooled_height": pooled_height,
                 "pooled_width": pooled_width,
                 "spatial_scale": spatial_scale})["Out"][0]


@_export
def polygon_box_transform(input, name=None):
    return _det("polygon_box_transform", {"Input": input}, {})["Output"][0]


@_export
def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       return_rois_num=False, name=None):
    """(rois, probs), and with return_rois_num a third None: the op
    declares no RpnRoisNum slot, as the reference's."""
    outs = _det("generate_proposals",
                {"Scores": scores, "BboxDeltas": bbox_deltas,
                 "ImInfo": im_info, "Anchors": anchors,
                 "Variances": variances},
                {"pre_nms_topN": pre_nms_top_n,
                 "post_nms_topN": post_nms_top_n,
                 "nms_thresh": nms_thresh, "min_size": min_size,
                 "eta": eta})
    rois, probs = outs["RpnRois"][0], outs["RpnRoiProbs"][0]
    if return_rois_num:
        return rois, probs, outs.get("RpnRoisNum", [None])[0]
    return rois, probs


@_export
def distribute_fpn_proposals(fpn_rois, min_level, max_level,
                             refer_level, refer_scale,
                             rois_num=None, name=None):
    """(the levels' packed rois, RestoreIndex)."""
    outs = _det("distribute_fpn_proposals", {"FpnRois": fpn_rois},
                {"min_level": min_level, "max_level": max_level,
                 "refer_level": refer_level, "refer_scale": refer_scale})
    return outs["MultiFpnRois"], outs["RestoreIndex"][0]


@_export
def collect_fpn_proposals(multi_rois, multi_scores, min_level,
                          max_level, post_nms_top_n, rois_num=None,
                          name=None):
    return _det("collect_fpn_proposals",
                {"MultiLevelRois": list(multi_rois),
                 "MultiLevelScores": list(multi_scores)},
                {"post_nms_topN": post_nms_top_n})["FpnRois"][0]


@_export
def density_prior_box(input, image, densities=None, fixed_sizes=None,
                      fixed_ratios=None, variance=(0.1, 0.1, 0.2, 0.2),
                      clip=False, steps=(0.0, 0.0), offset=0.5,
                      flatten_to_2d=False, name=None):
    """(boxes, variances).  The rule reads step_w / step_h, not the
    `steps` attr this passes (the reference's does the same)."""
    outs = _det("density_prior_box", {"Input": input, "Image": image},
                {"densities": list(densities or []),
                 "fixed_sizes": list(fixed_sizes or []),
                 "fixed_ratios": list(fixed_ratios or []),
                 "variances": list(variance), "clip": clip,
                 "steps": list(steps), "offset": offset,
                 "flatten_to_2d": flatten_to_2d})
    return outs["Boxes"][0], outs["Variances"][0]


@_export
def box_decoder_and_assign(prior_box, prior_box_var, target_box,
                           box_score, box_clip, name=None):
    outs = _det("box_decoder_and_assign",
                {"PriorBox": prior_box, "PriorBoxVar": prior_box_var,
                 "TargetBox": target_box, "BoxScore": box_score},
                {"box_clip": box_clip})
    return outs["DecodeBox"][0], outs["OutputAssignBox"][0]


@_export
def retinanet_detection_output(bboxes, scores, anchors, im_info,
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.3,
                               nms_eta=1.0):
    return _det("retinanet_detection_output",
                {"BBoxes": list(bboxes), "Scores": list(scores),
                 "Anchors": list(anchors), "ImInfo": im_info},
                {"score_threshold": score_threshold,
                 "nms_top_k": nms_top_k, "keep_top_k": keep_top_k,
                 "nms_threshold": nms_threshold,
                 "nms_eta": nms_eta})["Out"][0]


@_export
def retinanet_target_assign(bbox_pred, cls_logits, anchor_box,
                            anchor_var, gt_boxes, gt_labels, is_crowd,
                            im_info, num_classes=1,
                            positive_overlap=0.5,
                            negative_overlap=0.4):
    """Paddle's signature returns the sampled anchors' index lists; the
    dense rule gives per-anchor targets and masks, no LocationIndex:
    KeyError, as in the reference."""
    outs = _det("retinanet_target_assign",
                {"Anchor": anchor_box, "GtBoxes": gt_boxes,
                 "GtLabels": gt_labels, "IsCrowd": is_crowd,
                 "ImInfo": im_info},
                {"positive_overlap": positive_overlap,
                 "negative_overlap": negative_overlap})
    return (None, None, outs["TargetBBox"][0], outs["TargetLabel"][0],
            outs["LocationIndex"][0], outs["ScoreIndex"][0],
            outs.get("ForegroundNumber", [None])[0])


@_export
def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd, im_info,
                      rpn_batch_size_per_im=256,
                      rpn_straddle_thresh=0.0, rpn_fg_fraction=0.5,
                      rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True):
    """As retinanet_target_assign: KeyError on LocationIndex, as in the
    reference."""
    outs = _det("rpn_target_assign",
                {"Anchor": anchor_box, "GtBoxes": gt_boxes,
                 "IsCrowd": is_crowd, "ImInfo": im_info},
                {"rpn_batch_size_per_im": rpn_batch_size_per_im,
                 "rpn_straddle_thresh": rpn_straddle_thresh,
                 "rpn_fg_fraction": rpn_fg_fraction,
                 "rpn_positive_overlap": rpn_positive_overlap,
                 "rpn_negative_overlap": rpn_negative_overlap,
                 "use_random": use_random})
    return (outs["LocationIndex"][0], outs["ScoreIndex"][0],
            outs["TargetBBox"][0], outs["TargetLabel"][0],
            outs.get("BBoxInsideWeight", [None])[0])


@_export
def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=None, name=None):
    ins = {"X": input, "MatchIndices": matched_indices}
    if negative_indices is not None:
        ins["NegIndices"] = negative_indices
    outs = _det("target_assign", ins, {"mismatch_value": mismatch_value or 0})
    return outs["Out"][0], outs["OutWeight"][0]


@_export
def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info, batch_size_per_im=256,
                             fg_fraction=0.25, fg_thresh=0.25,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=None, use_random=True,
                             is_cls_agnostic=False,
                             is_cascade_rcnn=False):
    outs = _det("generate_proposal_labels",
                {"RpnRois": rpn_rois, "GtClasses": gt_classes,
                 "IsCrowd": is_crowd, "GtBoxes": gt_boxes,
                 "ImInfo": im_info},
                {"batch_size_per_im": batch_size_per_im,
                 "fg_fraction": fg_fraction, "fg_thresh": fg_thresh,
                 "bg_thresh_hi": bg_thresh_hi,
                 "bg_thresh_lo": bg_thresh_lo,
                 "bbox_reg_weights": list(bbox_reg_weights),
                 "class_nums": class_nums or 81,
                 "use_random": use_random})
    return (outs["Rois"][0], outs["LabelsInt32"][0],
            outs["BboxTargets"][0], outs["BboxInsideWeights"][0],
            outs["BboxOutsideWeights"][0])


@_export
def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms,
                         rois, labels_int32, num_classes, resolution):
    outs = _det("generate_mask_labels",
                {"ImInfo": im_info, "GtClasses": gt_classes,
                 "IsCrowd": is_crowd, "GtSegms": gt_segms,
                 "Rois": rois, "LabelsInt32": labels_int32},
                {"num_classes": num_classes, "resolution": resolution})
    return (outs["MaskRois"][0], outs["RoiHasMaskInt32"][0],
            outs["MaskInt32"][0])
