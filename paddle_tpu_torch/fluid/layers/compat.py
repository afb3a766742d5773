"""fluid.layers' legacy-name tail (counterpart of
paddle_tpu/fluid/layers/compat.py), as far as the port has the rules:

  * one-op static wrappers through `_static_op` (cos_sim, gather_tree,
    multiplex, unbind, stanh, mish, size, unique, the sequence bucket's
    im2sequence, lod_reset, sequence_reshape and sequence_scatter, the
    misc and random buckets' add_position_encoding, mean_iou,
    shuffle_channel, random_crop, ...) and a few
    compositions (sum, scatter_nd, brelu, soft_relu, has_inf, has_nan,
    dice_loss, sampled_softmax_with_cross_entropy);
  * the detection bucket's seven (box_decoder_and_assign, target_assign,
    roi_pool, psroi_pool, prroi_pool, polygon_box_transform,
    retinanet_detection_output);
  * (`dynamic_decode` and the cell and decoder classes resolve from the
    port's 2.x API through fluid.layers' module `__getattr__`; `birnn`
    calls nn.functional's on use);
  * the reference's `_na` table: names it does not carry raise
    NotImplementedError with the reason and the alternative, worded as
    the reference words them.  `lstm`, `lstm_unit`, `gru_unit`,
    `dynamic_gru` and `dynamic_lstmp` are among them, so
    `fluid.layers.dynamic_gru` raises in both packages (star-imported
    after `rnn`, this module's guard wins), while
    `fluid.layers.rnn.dynamic_gru` computes.

"""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = []  # populated below


def _static_op(name, slots, out_slot="Out", dtype_from=0,
               out_dtype=None, n_outs=1, extra_out_slots=(),
               attr_names=(), extra_out_dtypes=()):
    """One-op static wrapper: positional tensor args -> slots, then
    positional ATTR args -> attr_names in order (the reference's
    positional signatures), keyword args -> attrs.  Excess positionals
    raise instead of being silently dropped."""

    def fn(*args, **kwargs):
        kwargs.pop("name", None)
        if len(args) > len(slots) + len(attr_names):
            raise TypeError(
                f"{name}() takes at most {len(slots)} tensor args + "
                f"attrs {list(attr_names)} positionally; pass other "
                "attributes as keywords (op attr names)")
        for aname, aval in zip(attr_names, args[len(slots):]):
            kwargs.setdefault(aname, aval)
        args = args[:len(slots)]
        helper = LayerHelper(name)
        ins = {}
        for slot, a in zip(slots, args):
            if a is None:
                continue
            ins[slot] = list(a) if isinstance(a, (list, tuple)) else [a]
        dt = out_dtype(kwargs) if callable(out_dtype) else out_dtype
        if dt is None:
            ref = args[dtype_from]
            ref = ref[0] if isinstance(ref, (list, tuple)) else ref
            dt = getattr(ref, "dtype", "float32")
        outs = {out_slot: [helper.create_variable_for_type_inference(dt)]}
        for i, s in enumerate(extra_out_slots):
            ed = (extra_out_dtypes[i] if i < len(extra_out_dtypes)
                  and extra_out_dtypes[i] else dt)
            outs[s] = [helper.create_variable_for_type_inference(ed)]
        helper.append_op(name, inputs=ins, outputs=outs, attrs=kwargs,
                         infer_shape=False)
        ordered = [outs[out_slot][0]] + [outs[s][0]
                                         for s in extra_out_slots]
        return ordered[0] if len(ordered) == 1 else tuple(ordered)

    fn.__name__ = name
    __all__.append(name)
    return fn


# -- one-op static wrappers -------------------------------------------------

cos_sim = _static_op("cos_sim", ["X", "Y"])
multiplex = _static_op("multiplex", ["X", "Ids"])
unbind = _static_op("unbind", ["X"], attr_names=("axis",))
gather_tree = _static_op("gather_tree", ["Ids", "Parents"])
gaussian_random = _static_op(
    "gaussian_random", [],
    out_dtype=lambda kw: kw.get("dtype", "float32"),
    attr_names=("shape", "mean", "std", "seed", "dtype"))
uniform_random = _static_op(
    "uniform_random", [],
    out_dtype=lambda kw: kw.get("dtype", "float32"),
    attr_names=("shape", "dtype", "min", "max", "seed"))
unique = _static_op("unique", ["X"], extra_out_slots=("Index",),
                    extra_out_dtypes=("int32",))


def unique_with_counts(x, dtype="int32", name=None):
    """Paddle's layers/nn.py unique_with_counts: the unique rule gives
    the counts when the op declares its Counts slot."""
    helper = LayerHelper("unique")
    out = helper.create_variable_for_type_inference(x.dtype)
    idx = helper.create_variable_for_type_inference(dtype)
    cnt = helper.create_variable_for_type_inference(dtype)
    helper.append_op("unique", inputs={"X": [x]},
                     outputs={"Out": [out], "Index": [idx],
                              "Counts": [cnt]},
                     attrs={"dtype": dtype, "return_counts": True},
                     infer_shape=False)
    return out, idx, cnt


__all__.append("unique_with_counts")


def sum(x, name=None):  # noqa: A001 - reference API shadows builtin
    """The n-ary sum of a list of tensors (tensor.sums)."""
    from .tensor import sums

    return sums(x if isinstance(x, (list, tuple)) else [x])


__all__.append("sum")

stanh = _static_op("stanh", ["X"],
                   attr_names=("scale_a", "scale_b"))

mish = _static_op("mish", ["X"], attr_names=("threshold",))
size = _static_op("size", ["Input"], out_dtype="int64")

# -- the nn and vision buckets' wrappers ----------------------------------------

affine_channel = _static_op("affine_channel", ["X", "Scale", "Bias"])
_affine_grid_op = _static_op("affine_grid", ["Theta", "OutputShape"],
                             out_slot="Output")
__all__.remove("affine_grid")


def affine_grid(theta, out_shape, name=None):
    """out_shape a Python list (the attr) or a Variable (the tensor
    slot), as the reference takes it."""
    if isinstance(out_shape, (list, tuple)):
        return _affine_grid_op(theta, None,
                               output_shape=[int(v) for v in out_shape])
    return _affine_grid_op(theta, out_shape)


__all__.append("affine_grid")
bpr_loss = _static_op("bpr_loss", ["X", "Label"], out_slot="Y")
grid_sampler = _static_op("grid_sampler", ["X", "Grid"],
                          out_slot="Output")
pad_constant_like = _static_op("pad_constant_like", ["X", "Y"])
pixel_shuffle = _static_op("pixel_shuffle", ["X"],
                           attr_names=("upscale_factor",))
pool3d = _static_op("pool3d", ["X"])
rank_loss = _static_op("rank_loss", ["Label", "Left", "Right"])
margin_rank_loss = _static_op("margin_rank_loss", ["Label", "X1", "X2"],
                              attr_names=("margin",))
space_to_depth = _static_op("space_to_depth", ["X"],
                            attr_names=("blocksize",))
temporal_shift = _static_op("temporal_shift", ["X"],
                            attr_names=("seg_num", "shift_ratio"))
lrn = _static_op("lrn", ["X"], attr_names=("n", "k", "alpha", "beta"))
deformable_conv = _static_op("deformable_conv",
                             ["Input", "Offset", "Mask", "Filter"],
                             out_slot="Output")
resize_trilinear = _static_op("trilinear_interp", ["X"])
resize_linear = _static_op("linear_interp", ["X"])
selu = _static_op("selu", ["X"], attr_names=("scale", "alpha"))
hsigmoid = _static_op("hierarchical_sigmoid", ["X", "Label", "W", "Bias"],
                      extra_out_slots=("PreOut",))
crop_tensor = _static_op("crop_tensor", ["X", "Shape", "Offsets"])
# the misc and random buckets' eleven
add_position_encoding = _static_op("add_position_encoding", ["X"])
continuous_value_model = _static_op("cvm", ["X", "CVM"], out_slot="Y")
mean_iou = _static_op("mean_iou", ["Predictions", "Labels"],
                      out_slot="OutMeanIou",
                      extra_out_slots=("OutWrong", "OutCorrect"),
                      attr_names=("num_classes",))
sampling_id = _static_op("sampling_id", ["X"],
                         attr_names=("min", "max", "seed"))
shard_index = _static_op("shard_index", ["X"],
                         attr_names=("index_num", "nshards",
                                     "shard_id", "ignore_value"))
shuffle_channel = _static_op("shuffle_channel", ["X"],
                             attr_names=("group",))
teacher_student_sigmoid_loss = _static_op(
    "teacher_student_sigmoid_loss", ["X", "Label"], out_slot="Y",
    attr_names=("soft_max_up_bound", "soft_max_lower_bound"))
random_crop = _static_op("random_crop", ["X"],
                         attr_names=("shape", "startup_seed"))
gaussian_random_batch_size_like = _static_op(
    "gaussian_random_batch_size_like", ["Input"])
uniform_random_batch_size_like = _static_op(
    "uniform_random_batch_size_like", ["Input"])
is_empty = _static_op("is_empty", ["X"], out_dtype="bool")

# the sequence bucket's four
im2sequence = _static_op("im2sequence", ["X"])
lod_reset = _static_op("lod_reset", ["X", "Y"])
sequence_reshape = _static_op("sequence_reshape", ["X"])
sequence_scatter = _static_op("sequence_scatter", ["X", "Ids", "Updates"])
crop = crop_tensor
__all__.append("crop")

# the detection bucket's seven
polygon_box_transform = _static_op("polygon_box_transform", ["Input"],
                                   out_slot="Output")
prroi_pool = _static_op("prroi_pool", ["X", "ROIs"])
box_decoder_and_assign = _static_op(
    "box_decoder_and_assign",
    ["PriorBox", "PriorBoxVar", "TargetBox", "BoxScore"],
    out_slot="DecodeBox", extra_out_slots=("OutputAssignBox",))
target_assign = _static_op("target_assign", ["X", "MatchIndices"],
                           extra_out_slots=("OutWeight",))
roi_pool = _static_op("roi_pool", ["X", "ROIs"],
                      extra_out_slots=("Argmax",))
psroi_pool = _static_op("psroi_pool", ["X", "ROIs"])
retinanet_detection_output = _static_op(
    "retinanet_detection_output",
    ["BBoxes", "Scores", "Anchors", "ImInfo"])

# the factory appended op names where the Python name differs
for _wrong, _right in [("cvm", "continuous_value_model"),
                       ("trilinear_interp", "resize_trilinear"),
                       ("linear_interp", "resize_linear"),
                       ("hierarchical_sigmoid", "hsigmoid")]:
    __all__.remove(_wrong)
    __all__.append(_right)


def scatter_nd(index, updates, shape, name=None):
    """Paddle's layers/nn.py scatter_nd: scatter-add into zeros of
    `shape` (over the scatter_nd_add rule)."""
    from .tensor import fill_constant

    base = fill_constant(list(shape), updates.dtype, 0.0)
    return _scatter_nd_add_op(base, index, updates)


_scatter_nd_add_op = _static_op("scatter_nd_add",
                                ["X", "Index", "Updates"])
__all__.remove("scatter_nd_add")
__all__.append("scatter_nd")


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    """clip(x, t_min, t_max)."""
    from .nn import clip as _clip

    return _clip(x, t_min, t_max)


__all__.append("brelu")


def soft_relu(x, threshold=40.0, name=None):
    """ln(1 + exp(clip(x, -t, t))), over the clip, exp and log
    layers."""
    from .nn import clip as _clip, exp as _exp, log as _log

    one = 1.0
    return _log(_exp(_clip(x, -threshold, threshold)) + one)


__all__.append("soft_relu")


def _any_of(op_name):
    elem = _static_op(op_name, ["X"], out_dtype="bool")
    __all__.remove(op_name)
    reduce_any = _static_op("reduce_any", ["X"], out_dtype="bool")
    __all__.remove("reduce_any")

    def fn(x, name=None):
        return reduce_any(elem(x), reduce_all=True)

    return fn


has_inf = _any_of("isinf_v2")
has_inf.__name__ = "has_inf"
has_nan = _any_of("isnan_v2")
has_nan.__name__ = "has_nan"
__all__ += ["has_inf", "has_nan"]


# -- composition wrappers (match the documented formulas) --------------------

def dice_loss(input, label, epsilon=1e-5):
    """The per-sample dice loss (reduced over every non-batch dim), then
    the mean over the batch."""
    from .nn import reduce_mean, reduce_sum
    from .tensor import one_hot

    from ... import fluid

    L = fluid.layers

    nclass = int(input.shape[-1])
    lab = one_hot(L.reshape(label, [-1]), nclass)
    lab = L.reshape(lab, [int(s) if s > 0 else -1
                          for s in input.shape[:-1]] + [nclass])
    red = list(range(1, len(input.shape)))
    inter = reduce_sum(input * lab, dim=red)
    union = reduce_sum(input, dim=red) + reduce_sum(lab, dim=red)
    return reduce_mean(1 - (2 * inter + epsilon) / (union + epsilon))


__all__.append("dice_loss")


def sampled_softmax_with_cross_entropy(logits, label, num_samples,
                                       **kwargs):
    """Full softmax cross entropy, as the reference computes it (no
    sampling: the same quantity in expectation, exact here)."""
    from .loss import softmax_with_cross_entropy

    return softmax_with_cross_entropy(logits, label)


__all__.append("sampled_softmax_with_cross_entropy")


def birnn(*args, **kwargs):
    """nn.functional.birnn, looked up on call (nn imports fluid: an
    import here would cycle), as the reference's lazy alias."""
    from ...nn import functional

    return functional.birnn(*args, **kwargs)


__all__.append("birnn")


# -- loud guards for what is not carried ---------------------------------------

def _na(name, why, alternative):
    def fn(*a, **k):
        raise NotImplementedError(
            f"fluid.layers.{name} is not carried by this build: "
            f"{why}. Use instead: {alternative}")

    fn.__name__ = name
    globals()[name] = fn
    __all__.append(name)


for _name, _why, _alt in [
    ("py_reader", "the C++ double-buffered reader is replaced by the "
     "DataLoader over the native GIL-free queue",
     "paddle.io.DataLoader / fluid.io.DataLoader.from_generator"),
    ("create_py_reader_by_data", "same as py_reader",
     "fluid.io.DataLoader.from_generator"),
    ("double_buffer", "XLA pipelining + the native queue own buffering",
     "paddle.io.DataLoader"),
    ("read_file", "file ops belong to the host input pipeline",
     "paddle.io datasets / python IO in the reader"),
    ("load", "per-op C++ LoadOp is replaced by program-level io",
     "fluid.io.load / paddle.load"),
    ("DynamicRNN", "the LoD-stepped RNN graph builder is replaced by "
     "dense recurrence", "paddle.nn.RNN / fluid.layers.rnn cells with "
     "while_loop"),
    ("StaticRNN", "same as DynamicRNN", "paddle.nn.RNN or lax.scan via "
     "jit.to_static"),
    ("IfElse", "block-based branching is replaced by functional cond",
     "fluid.layers.cond"),
    ("Switch", "block-based switching is replaced by case/switch_case",
     "fluid.layers.case / fluid.layers.switch_case"),
    ("BasicDecoder", "the helper-driven decode stack is replaced by "
     "the dense decode API", "paddle.nn.BeamSearchDecoder + "
     "dynamic_decode"),
    ("DecodeHelper", "same as BasicDecoder", "paddle.nn.dynamic_decode"),
    ("TrainingHelper", "same as BasicDecoder", "teacher-forced loops "
     "over cells (paddle.nn.RNN)"),
    ("GreedyEmbeddingHelper", "same as BasicDecoder",
     "BeamSearchDecoder with beam_size=1"),
    ("SampleEmbeddingHelper", "same as BasicDecoder",
     "sampling loops over cells"),
    ("autodoc", "documentation codegen decorator, not a layer", "n/a"),
    ("templatedoc", "documentation codegen decorator, not a layer",
     "n/a"),
    ("generate_layer_fn", "pybind op-wrapper codegen; lowerings are "
     "explicit here", "the explicit layer functions"),
    ("generate_activation_fn", "same as generate_layer_fn",
     "the explicit activation functions"),
    ("inplace_abn", "in-place activated batch norm is a CUDA memory "
     "optimization; XLA fuses BN+act without aliasing",
     "fluid.layers.batch_norm(act=...)"),
    ("similarity_focus", "data-dependent output patterns defeat XLA "
     "static shapes", "masking built from paddle.topk indices"),
    ("roi_perspective_transform", "rotated-ROI warping needs "
     "data-dependent gathers kept out of the static op set",
     "grid_sampler with precomputed grids"),
    ("deformable_roi_pooling", "superseded by deformable_conv + "
     "roi_align", "deformable_conv / roi_align"),
    ("hash", "xxhash sparse-id hashing belongs to the PS "
     "sparse-embedding path", "dense embedding lookups"),
    ("filter_by_instag", "instance-tag filtering is part of the PS "
     "pipeline", "boolean masking with masked_select"),
    ("merge_selected_rows", "SelectedRows never materializes here",
     "dense tensors"),
    ("reorder_lod_tensor_by_rank", "LoD metadata is replaced by dense "
     "padding + lengths", "gather over a rank index"),
    ("lod_append", "LoD metadata is replaced by dense padding + "
     "lengths", "sequence_pad / explicit lengths"),
    ("dynamic_lstmp", "LoD-ragged projection LSTM",
     "paddle.nn.LSTM + a Linear projection"),
    ("get_tensor_from_selected_rows", "SelectedRows never "
     "materializes here", "the dense tensor directly"),
    ("center_loss", "the static variant needs persistable center "
     "state wiring; the dygraph path is implemented",
     "paddle.nn.functional.center_loss (dygraph)"),
    ("npair_loss", "implemented in the 2.0 namespace",
     "paddle.nn.functional.npair_loss (dygraph)"),
    ("fsp_matrix", "implemented in the 2.0 namespace",
     "paddle.nn.functional.fsp_matrix (dygraph)"),
    ("image_resize_short", "implemented in the 2.0 namespace",
     "paddle.nn.functional.image_resize_short (dygraph)"),
    ("adaptive_pool3d", "implemented in the 2.0 namespace",
     "paddle.nn.functional.adaptive_avg_pool3d / adaptive_max_pool3d"),
    ("Assert", "host-side assertion op; the executor checks feeds and "
     "FLAGS_check_nan_inf scans outputs",
     "fluid.layers.Print + host checks"),
    ("autoincreased_step_counter", "global step state lives in the "
     "optimizer state", "optimizer LR schedulers / state['t']"),
    ("density_prior_box", "implemented in the 2.0 namespace",
     "paddle.nn.functional.density_prior_box (dygraph)"),
    ("collect_fpn_proposals", "implemented in the 2.0 namespace",
     "paddle.nn.functional.collect_fpn_proposals (dygraph)"),
    ("distribute_fpn_proposals", "implemented in the 2.0 namespace",
     "paddle.nn.functional.distribute_fpn_proposals (dygraph)"),
    ("generate_mask_labels", "implemented in the 2.0 namespace",
     "paddle.nn.functional.generate_mask_labels (dygraph)"),
    ("generate_proposal_labels", "implemented in the 2.0 namespace",
     "paddle.nn.functional.generate_proposal_labels (dygraph)"),
    ("generate_proposals", "implemented in the 2.0 namespace",
     "paddle.nn.functional.generate_proposals (dygraph)"),
    ("retinanet_target_assign", "implemented in the 2.0 namespace",
     "paddle.nn.functional.retinanet_target_assign (dygraph)"),
    ("rpn_target_assign", "implemented in the 2.0 namespace",
     "paddle.nn.functional.rpn_target_assign (dygraph)"),
    ("ssd_loss", "the SSD training loss composes target_assign + "
     "box_coder + softmax/smooth-l1, all available",
     "explicit composition (see reference detection.py ssd_loss)"),
    ("locality_aware_nms", "implemented as an op lowering",
     "the locality_aware_nms op via nn.functional / OpTest path"),
    ("matrix_nms", "implemented as an op lowering",
     "the matrix_nms op via the detection module"),
    ("lstm", "the fused multi-layer LSTM wrapper is dygraph-first "
     "here", "paddle.nn.functional.lstm / paddle.nn.LSTM"),
    ("lstm_unit", "implemented in the 2.0 namespace",
     "paddle.nn.functional.lstm_unit (dygraph)"),
    ("gru_unit", "implemented in the 2.0 namespace",
     "paddle.nn.functional.gru_unit (dygraph)"),
    ("dynamic_gru", "already available", "fluid.layers.rnn dynamic_gru"),
    ("tensor_array_to_tensor", "implemented in the 2.0 namespace",
     "paddle.nn.functional.tensor_array_to_tensor (dygraph)"),
    ("rank", "implemented in the 2.0 namespace", "paddle.rank"),
    ("chunk_eval", "the CoNLL chunking F1 metric is a host-side "
     "evaluation, not a device op",
     "compute chunk metrics on fetched numpy outputs (or "
     "paddle.metric)"),
]:
    if _name not in __all__:
        _na(_name, _why, _alt)
