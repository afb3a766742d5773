"""The rest of the 2.x `nn` surface against paddle_tpu on the CPU: every
function the port's `nn.functional` gained and every layer class `nn`
gained, on the same seeded numpy inputs (a layer's weights carried over
from the reference's by `convert.load_jax_state`), forward values and the
gradients of the inputs (and of a layer's parameters) under the same
seeded cotangents, the reference's on its eager tape.  Then the names
left out, by the op bucket that waits for them; the reference's guards;
the dropout variants (held by their statistics and identities: eager
jax.random bits cannot be reproduced); and the reference's forms that
raise where the port computes, or that raise in both.

Tolerances.  F32 (rtol 1e-5, atol 1e-6): a few float32 operations whose
only difference is the order of summation (convolutions and their
gradients of at most a few hundred products).  RESIZE (rtol 1e-5, atol
1e-5): jax.image.resize contracts each axis with its weight matrix on
the MXU path's precision in f32, the port by tensordot.
"""

import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.tensor as JT
from paddle_tpu.fluid import dygraph as Jdy
from paddle_tpu.fluid import initializer as _jax_init
from paddle_tpu.jit import functional_state as j_state

import paddle_tpu_torch as T
from paddle_tpu_torch.convert import load_jax_state

F32 = dict(rtol=1e-5, atol=1e-6)
RESIZE = dict(rtol=1e-5, atol=1e-5)


def _f(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _probs(n, c, seed=0):
    z = _f(n, c, seed=seed)
    e = np.exp(z - z.max(1, keepdims=True))
    return (e / e.sum(1, keepdims=True)).astype(np.float32)


def _ids(shape, high, seed=0):
    return np.random.RandomState(seed).randint(0, high, shape).astype(
        np.int64)


@contextlib.contextmanager
def _fresh_jax_stream():
    saved = list(_jax_init._eager_seed)
    _jax_init._eager_seed[:] = [2023, 0]
    try:
        yield
    finally:
        _jax_init._eager_seed[:] = saved


_IMG = _f(2, 3, 5, 6)
_VOL = _f(1, 2, 4, 5, 5)

# name -> [(args, kwargs, positions of the inputs whose gradient is held)]
FUNCTIONAL = {
    "sigmoid": [((_f(3, 4),), {}, (0,))],
    "leaky_relu": [((_f(3, 4),), {"negative_slope": 0.2}, (0,))],
    "elu": [((_f(3, 4),), {"alpha": 0.5}, (0,))],
    "selu": [((_f(3, 4, scale=3),), {}, (0,))],
    "softplus": [((_f(3, 4, scale=10),), {"beta": 2.0, "threshold": 5.0},
                  (0,))],
    "softshrink": [((_f(3, 4),), {"threshold": 0.3}, (0,))],
    "hardshrink": [((_f(3, 4),), {"threshold": 0.3}, (0,))],
    "hardsigmoid": [((_f(3, 4, scale=4),), {}, (0,))],
    "hardswish": [((_f(3, 4, scale=4),), {}, (0,))],
    "hardtanh": [((_f(3, 4, scale=2),), {"min": -0.5, "max": 1.5}, (0,))],
    "swish": [((_f(3, 4),), {}, (0,))],
    "silu": [((_f(3, 4),), {}, (0,))],
    "mish": [((_f(3, 4),), {}, (0,))],
    "prelu": [((_f(2, 3, 4), np.array([0.1], np.float32)), {}, (0, 1))],
    "maxout": [((_f(2, 4, 3, 3),), {"groups": 2}, (0,))],
    "tanhshrink": [((_f(3, 4),), {}, (0,))],
    "thresholded_relu": [((_f(3, 4, scale=2),), {"threshold": 0.5}, (0,))],
    "glu": [((_f(3, 6),), {}, (0,)), ((_f(4, 2, 3),), {"axis": 0}, (0,))],
    "instance_norm": [((_IMG,), {"weight": _f(3, seed=1),
                                 "bias": _f(3, seed=2)}, (0,)),
                      ((_f(2, 3, 7),), {"eps": 1e-3}, (0,))],
    "group_norm": [((_f(2, 6, 3, 3), 3), {"weight": _f(6, seed=1),
                                          "bias": _f(6, seed=2)}, (0,))],
    "normalize": [((_f(3, 4),), {}, (0,)), ((_f(2, 3, 4),),
                                            {"p": 1, "axis": -1}, (0,))],
    "local_response_norm": [((_f(2, 6, 3, 3), 3), {"alpha": 0.1}, (0,))],
    "one_hot": [((np.array([0, 3, 1, 4], np.int64), 5), {}, ())],
    "label_smooth": [((np.eye(4, dtype=np.float32)[[0, 2, 3]],),
                      {"epsilon": 0.2}, (0,)),
                     ((np.eye(4, dtype=np.float32)[[0, 2, 3]],),
                      {"prior_dist": _probs(1, 4)}, (0,))],
    "pad": [((_IMG, [1, 2, 0, 1]), {"mode": "reflect"}, (0,)),
            ((_IMG, [0, 0, 1, 1, 2, 0, 0, 1]), {"value": 0.5}, (0,)),
            ((_f(2, 3, 4), [2, 1]), {"mode": "replicate"}, (0,)),
            ((_f(2, 3, 4), [1, 2]), {"mode": "circular"}, (0,))],
    "interpolate": [((_IMG,), {"size": [7, 8]}, (0,)),
                    ((_IMG,), {"scale_factor": 2, "mode": "bilinear"},
                     (0,)),
                    ((_IMG,), {"size": [4, 9], "mode": "bilinear",
                               "align_corners": True}, (0,)),
                    ((_IMG,), {"size": [8, 7], "mode": "bicubic"}, (0,)),
                    ((_IMG,), {"size": [3, 4], "mode": "linear"}, (0,))],
    "upsample": [((_IMG,), {"scale_factor": 2}, (0,))],
    "pixel_shuffle": [((_f(2, 8, 3, 3), 2), {}, (0,))],
    "unfold": [((_f(2, 3, 5, 5), 2), {"paddings": 1}, (0,)),
               ((_f(1, 2, 6, 6), [2, 3]), {"strides": 2, "dilations": 1},
                (0,))],
    "log_loss": [((_probs(5, 2)[:, :1].copy(),
                   np.array([[1.], [0.], [1.], [1.], [0.]], np.float32)),
                  {}, (0,))],
    "square_error_cost": [((_f(4, 3), _f(4, 3, seed=1)), {}, (0, 1))],
    "diag_embed": [((_f(2, 3),), {}, (0,))],
    "temporal_shift": [((_f(6, 8, 2, 2), 3), {}, (0,))],
    "conv2d_transpose": [((_f(2, 3, 5, 5), _f(3, 4, 3, 3, seed=1),
                           _f(4, seed=2)), {"stride": 2, "padding": 1},
                          (0, 1, 2)),
                         ((_f(2, 4, 4, 4), _f(4, 3, 3, 3, seed=1)),
                          {"groups": 2, "padding": "SAME"}, (0, 1))],
    "conv3d": [((_VOL, _f(3, 2, 3, 3, 3, seed=1), _f(3, seed=2)),
                {"padding": [1, 0, 1], "stride": 2}, (0, 1, 2))],
    "log_sigmoid": [((_f(3, 4, scale=5),), {}, (0,))],
    "softsign": [((_f(3, 4),), {}, (0,))],
    "soft_relu": [((_f(3, 4, scale=20),), {"threshold": 10.0}, (0,))],
    "cosine_similarity": [((_f(3, 4), _f(3, 4, seed=1)), {}, (0, 1))],
    "dice_loss": [((_probs(4, 3), _ids((4, 1), 3)), {}, (0,))],
    "npair_loss": [((_f(4, 5), _f(4, 5, seed=1),
                     np.array([1, 0, 1, 2], np.int64)), {}, (0, 1))],
    "fsp_matrix": [((_f(2, 3, 4, 4), _f(2, 5, 4, 4, seed=1)), {}, (0, 1))],
    "bpr_loss": [((_f(4, 5), _ids((4, 1), 5, seed=1)), {}, (0,))],
    "teacher_student_sigmoid_loss": [(
        (_f(6, 1), np.array([[-2.0], [-0.5], [0.3], [1.7], [0.0], [1.0]])),
        {}, (0,))],
    "shuffle_channel": [((_f(2, 6, 3, 3), 3), {}, (0,))],
    "add_position_encoding": [((_f(2, 5, 6),), {"alpha": 0.5, "beta": 2.0},
                               (0,))],
    "continuous_value_model": [
        ((np.abs(_f(4, 5)), np.abs(_f(4, 2, seed=1))), {}, (0,)),
        ((np.abs(_f(4, 5)), np.abs(_f(4, 2, seed=1))), {"use_cvm": False},
         (0,))],
    "center_loss": [((_f(5, 3), np.array([[0], [2], [0], [1], [2]],
                                         np.int64), 3, 0.1), {}, (0,))],
    "ctc_loss": [((_f(6, 2, 4), np.array([[1, 2], [3, 0]], np.int64),
                   np.array([6, 5], np.int64), np.array([2, 1], np.int64)),
                  {}, (0,)),
                 ((_f(6, 2, 4), np.array([[1, 2], [3, 0]], np.int64),
                   np.array([6, 5], np.int64), np.array([2, 1], np.int64)),
                  {"reduction": "sum"}, (0,))],
    "hsigmoid_loss": [((_f(4, 5), np.array([[0], [5], [3], [2]], np.int64),
                        6, _f(5, 5, seed=1)), {"bias": _f(5, 1, seed=2)},
                       (0, 3))],
    "conv1d": [((_f(2, 3, 8), _f(4, 3, 3, seed=1), _f(4, seed=2)),
                {"stride": 2, "padding": 1}, (0, 1, 2))],
    "conv1d_transpose": [((_f(2, 3, 5), _f(3, 4, 3, seed=1)),
                          {"stride": 2, "padding": 1}, (0, 1))],
    "conv3d_transpose": [((_f(1, 2, 3, 3, 3), _f(2, 3, 2, 2, 2, seed=1),
                           _f(3, seed=2)), {"stride": 2}, (0, 1, 2))],
    "max_pool1d": [((_f(2, 3, 9), 3), {"stride": 2, "padding": 1}, (0,))],
    "avg_pool1d": [((_f(2, 3, 8), 2), {}, (0,))],
    "max_pool3d": [((_VOL, 2), {"stride": 2}, (0,))],
    "avg_pool3d": [((_VOL, 3), {"stride": 1, "padding": 1}, (0,))],
    "adaptive_avg_pool1d": [((_f(2, 3, 7), 3), {}, (0,))],
    "adaptive_max_pool1d": [((_f(2, 3, 7), 3), {}, (0,))],
    "adaptive_avg_pool3d": [((_f(1, 2, 4, 5, 6), [2, 3, 4]), {}, (0,))],
    "adaptive_max_pool3d": [((_f(1, 2, 4, 5, 6), 2), {}, (0,))],
    "grid_sample": [((_f(2, 3, 4, 5), _f(2, 4, 5, 2, seed=1, scale=0.7)),
                     {}, (0, 1)),
                    ((_f(2, 3, 4, 5), _f(2, 4, 5, 2, seed=1, scale=0.7)),
                     {"padding_mode": "border", "align_corners": False},
                     (0, 1))],
    "affine_grid": [((_f(2, 2, 3), [2, 3, 4, 5]), {}, (0,))],
    "affine_channel": [((_IMG, _f(3, seed=1), _f(3, seed=2)), {},
                        (0, 1, 2))],
    "pixel_unshuffle": [((_f(2, 2, 4, 6), 2), {}, (0,))],
    "space_to_depth": [((_f(2, 8, 4, 6), 2), {}, (0,))],
    "deformable_conv": [((_f(1, 4, 5, 5), _f(1, 18, 5, 5, seed=3,
                                              scale=0.7),
                          _probs(9, 25, seed=4).reshape(1, 9, 5, 5) * 9,
                          _f(6, 4, 3, 3, seed=1), _f(6, seed=2)),
                         {"padding": 1}, (0, 1, 2, 3, 4))],
    "resize_trilinear": [((_f(1, 2, 3, 4, 5),), {"out_shape": [4, 6, 3]},
                          (0,))],
    "image_resize_short": [((_f(1, 2, 5, 7), 4), {}, (0,))],
    "bilinear_tensor_product": [((_f(3, 4), _f(3, 5, seed=1),
                                  _f(2, 4, 5, seed=2), _f(1, 2, seed=3)),
                                 {}, (0, 1, 2, 3))],
    "bilinear": [((_f(3, 4), _f(3, 5, seed=1), _f(2, 4, 5, seed=2)), {},
                  (0, 1, 2))],
    "row_conv": [((_f(2, 5, 3), _f(3, 3, seed=1)), {}, (0, 1)),
                 ((_f(2, 5, 3), _f(3, 3, seed=1)), {"act": "relu"}, (0,))],
    "spectral_norm": [((_f(4, 3, 2), _f(4, seed=1), _f(6, seed=2)),
                       {"power_iters": 2}, (0,))],
    "data_norm": [((_f(5, 3), np.full(3, 12.0, np.float32),
                    _f(3, seed=1), np.abs(_f(3, seed=2)) * 9 + 4), {},
                   (0,))],
    "lstm_unit": [((_f(3, 16), _f(3, 4, seed=1), _f(3, 4, seed=2)),
                   {"forget_bias": 1.0}, (0, 2))],
    "pad_constant_like": [((_f(4, 5), _f(2, 3, seed=1)),
                           {"pad_value": 1.5}, (1,))],
    "pool3d": [((_VOL,), {"pool_size": 2, "pool_stride": 2}, (0,)),
               ((_VOL,), {"pool_size": 3, "pool_type": "avg",
                          "pool_padding": 1}, (0,))],
    # the sequence bucket's eager forms
    "sequence_reshape": [((_f(2, 3, 4),), {"new_dim": 6}, (0,))],
    "sequence_scatter": [((_f(3, 5), np.array([[0, 4, -1], [2, 2, 9],
                                              [1, 3, 0]]),
                           _f(3, 3, seed=1)), {}, (0, 2))],
    "im2sequence": [((_f(2, 3, 5, 6),), {"filter_size": [2, 3],
                                         "stride": [1, 2], "padding": 1},
                     (0,))],
    "lod_reset": [((_f(3, 4),), {"target_lod": [0, 1, 3]}, (0,))],
    # the repaired forms of the earlier functions
    "embedding": [((_ids((2, 3), 10), _f(10, 4)), {"padding_idx": 3},
                   (1,))],
    "dropout": [((_f(4, 8),), {"p": 0.3, "training": False,
                               "mode": "downscale_in_infer"}, (0,))],
}

# functions held by their own tests below, with the reason
HELD_BELOW = {
    "nce": "draws its negatives (torch's bits, not jax.random's)",
    "alpha_dropout": "random", "dropout2d": "random", "dropout3d": "random",
    "gru_unit": "raises in both packages", "lstm": "raises in both",
    "rnn": "drives a cell", "birnn": "drives two cells",
    "tensor_array_to_tensor": "the reference's raises on an eager array "
                              "(test_torch_control_flow.py)",
    "random_crop": "draws its offsets (torch's bits, not jax.random's)",
}
# the detection tail, held in test_torch_detection.py
HELD_BELOW.update(dict.fromkeys((
    "roi_pool", "prroi_pool", "psroi_pool", "polygon_box_transform",
    "generate_proposals", "distribute_fpn_proposals", "collect_fpn_proposals",
    "density_prior_box", "box_decoder_and_assign",
    "retinanet_detection_output", "retinanet_target_assign",
    "rpn_target_assign", "target_assign", "generate_proposal_labels",
    "generate_mask_labels"), "test_torch_detection.py"))

# names of the reference's nn.functional the port leaves out, by the queue
# item they wait for (none since the detection bucket landed)
LEFT_OUT = {}
# the reference's nn names the port leaves out, by queue item
NN_LEFT_OUT = {
    "item 10 (the collective path)": {"SwitchMoE", "SyncBatchNorm"},
}
NOT_API = {"np", "Tensor", "trace_fn", "trace_op"}


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def test_the_port_lacks_only_the_left_out_names():
    missing_f = _public(J.nn.functional) - _public(T.nn.functional) - NOT_API
    assert missing_f == set().union(set(), *LEFT_OUT.values())
    assert _public(J.nn) - _public(T.nn) == set().union(
        *NN_LEFT_OUT.values())


def test_reexported_fluid_layers_are_the_port_layers():
    """Where the reference's nn.functional re-exports its fluid.layers'
    name, the port's re-exports its own (static builders both)."""
    for n in ("assign", "erf", "fc", "pool2d", "pad2d", "warpctc",
              "sequence_pool", "linear_chain_crf", "smooth_l1"):
        assert getattr(T.nn.functional, n) is getattr(T.fluid.layers, n), n
        assert getattr(J.nn.functional, n) is getattr(J.fluid.layers, n), n


def _ref_args(args, grad):
    return [J.to_tensor(a, stop_gradient=i not in grad)
            if isinstance(a, np.ndarray) else a for i, a in enumerate(args)]


def _port_args(args, grad):
    out = []
    for i, a in enumerate(args):
        if isinstance(a, np.ndarray):
            t = torch.from_numpy(a.copy())
            out.append(t.requires_grad_(True) if i in grad else t)
        else:
            out.append(a)
    return out


def _flat(out):
    """A result as a list of tensors: a dict (a multi-output op's slots,
    as the reference's trace_op returns them) in slot order."""
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in out[k]]
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _cts(shapes, seed=7):
    rng = np.random.RandomState(seed)
    return [np.asarray(rng.randn(*s), np.float32) for s in shapes]


def _conv(a, J_side):
    if isinstance(a, np.ndarray):
        return J.to_tensor(a) if J_side else torch.from_numpy(a.copy())
    return a


def _run_both(fn_j, fn_t, args, kwargs, grad, tol, params=()):
    """Outputs and gradients (of the inputs at `grad`, and of `params`:
    (reference tensors, port tensors) by name) of fn_j and fn_t."""
    with Jdy.guard():
        jargs = _ref_args(args, grad)
        jouts = _flat(fn_j(*jargs, **{k: _conv(v, True)
                                     for k, v in kwargs.items()}))
        want = [np.asarray(o.numpy()) for o in jouts]
        floats = [(o, w) for o, w in zip(jouts, want)
                  if np.issubdtype(w.dtype, np.floating)]
        cts = _cts([w.shape for _, w in floats])
        jgrads = {}
        if grad or params:
            loss = JT.add_n([JT.sum(JT.multiply(o, J.to_tensor(c)))
                             for (o, _), c in zip(floats, cts)])
            loss.backward()
            jgrads = {i: np.asarray(jargs[i].grad.numpy()) for i in grad}
            for name, p in (params[0] if params else {}).items():
                jgrads[name] = np.asarray(p.grad.numpy())
    targs = _port_args(args, grad)
    touts = _flat(fn_t(*targs, **{k: _conv(v, False)
                                  for k, v in kwargs.items()}))
    assert len(touts) == len(want)
    for k, (t, w) in enumerate(zip(touts, want)):
        g = t.detach().numpy()
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
            np.testing.assert_allclose(g, w, err_msg=f"out {k}", **tol)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"out {k}")
    if grad or params:
        tfloats = [t for t, w in zip(touts, want)
                   if np.issubdtype(w.dtype, np.floating)]
        loss = sum((t * torch.from_numpy(c)).sum()
                   for t, c in zip(tfloats, cts))
        loss.backward()
        for i in grad:
            np.testing.assert_allclose(targs[i].grad.numpy(), jgrads[i],
                                       err_msg=f"grad {i}", **tol)
        for name, p in (params[1] if params else {}).items():
            np.testing.assert_allclose(p.grad.numpy(), jgrads[name],
                                       err_msg=f"grad {name}", **tol)


FUNCTIONAL_CASES = [(n, i) for n in sorted(FUNCTIONAL)
                    for i in range(len(FUNCTIONAL[n]))]


@pytest.mark.parametrize("name,i", FUNCTIONAL_CASES)
def test_functional_matches_the_reference(name, i):
    args, kwargs, grad = FUNCTIONAL[name][i]
    tol = RESIZE if name == "interpolate" else F32
    _run_both(getattr(J.nn.functional, name),
              getattr(T.nn.functional, name), args, kwargs, grad, tol)


def test_every_new_function_is_held():
    """Each public function of the port's functional tail, and each the
    head gained, has a case above or a test below."""
    from paddle_tpu_torch.nn.functional import extra
    guards = {n for n in extra.__all__
              if getattr(extra, n).__qualname__.startswith("_na")}
    new = set(extra.__all__) - guards
    assert new <= set(FUNCTIONAL) | set(HELD_BELOW)
    assert len(guards) == 11


# -- layers -----------------------------------------------------------------------

# name -> [(constructor args, constructor kwargs, forward inputs, grad)]
LAYERS = {
    "Sigmoid": [((), {}, (_f(3, 4),), (0,))],
    "LeakyReLU": [((0.1,), {}, (_f(3, 4),), (0,))],
    "ELU": [((0.7,), {}, (_f(3, 4),), (0,))],
    "SELU": [((), {}, (_f(3, 4),), (0,))],
    "Softmax": [((0,), {}, (_f(3, 4),), (0,))],
    "LogSoftmax": [((), {}, (_f(3, 4),), (0,))],
    "Softplus": [((), {}, (_f(3, 4),), (0,))],
    "Softshrink": [((), {}, (_f(3, 4),), (0,))],
    "Hardshrink": [((), {}, (_f(3, 4),), (0,))],
    "Hardsigmoid": [((), {}, (_f(3, 4, scale=4),), (0,))],
    "Hardswish": [((), {}, (_f(3, 4, scale=4),), (0,))],
    "Hardtanh": [((-0.5, 0.5), {}, (_f(3, 4),), (0,))],
    "Swish": [((), {}, (_f(3, 4),), (0,))],
    "Silu": [((), {}, (_f(3, 4),), (0,))],
    "Mish": [((), {}, (_f(3, 4),), (0,))],
    "Tanhshrink": [((), {}, (_f(3, 4),), (0,))],
    "ThresholdedReLU": [((0.3,), {}, (_f(3, 4),), (0,))],
    "PReLU": [((), {"init": 0.2}, (_f(2, 3, 4),), (0,))],
    "Maxout": [((3,), {}, (_f(2, 6, 2, 2),), (0,))],
    "Dropout2D": [((0.5,), {}, (_IMG,), (0,))],
    "Upsample": [((), {"scale_factor": 2, "mode": "bilinear"}, (_IMG,),
                  (0,))],
    "UpsamplingNearest2D": [((), {"size": [7, 9]}, (_IMG,), (0,))],
    "UpsamplingBilinear2D": [((), {"scale_factor": 2}, (_IMG,), (0,))],
    "Pad1D": [(([1, 2],), {"mode": "reflect"}, (_f(2, 3, 5),), (0,))],
    "Pad2D": [(([3, 3, 3, 3],), {"mode": "reflect"}, (_f(1, 2, 6, 7),),
               (0,))],
    "Pad3D": [(([1, 0, 2, 1, 0, 1],), {"value": 2.0}, (_VOL,), (0,))],
    "PixelShuffle": [((2,), {}, (_f(2, 8, 3, 3),), (0,))],
    "CosineSimilarity": [((), {"axis": 0}, (_f(3, 4), _f(3, 4, seed=1)),
                          (0, 1))],
    "Bilinear": [((4, 5, 3), {}, (_f(2, 4), _f(2, 5, seed=1)), (0, 1))],
    "Conv1D": [((3, 4, 3), {"padding": 1, "stride": 2}, (_f(2, 3, 8),),
                (0,))],
    "Conv2DTranspose": [((3, 2, 3), {"stride": 2, "padding": 1},
                         (_f(2, 3, 4, 4),), (0,))],
    "Conv3D": [((2, 3, 3), {"padding": [1, 1, 1]}, (_VOL,), (0,))],
    "BatchNorm3D": [((2,), {}, (_VOL,), (0,))],
    "InstanceNorm1D": [((3,), {}, (_f(2, 3, 7),), (0,))],
    "InstanceNorm2D": [((3,), {"weight_attr": False, "bias_attr": False},
                        (_IMG,), (0,))],
    "InstanceNorm3D": [((2,), {}, (_VOL,), (0,))],
    "GroupNorm": [((2, 6), {}, (_f(2, 6, 3, 3),), (0,))],
    "LocalResponseNorm": [((3,), {}, (_f(2, 6, 3, 3),), (0,))],
    "MaxPool1D": [((3, 2, 1), {}, (_f(2, 3, 9),), (0,))],
    "AvgPool1D": [((2,), {}, (_f(2, 3, 8),), (0,))],
    "LogSigmoid": [((), {}, (_f(3, 4),), (0,))],
    "Softsign": [((), {}, (_f(3, 4),), (0,))],
    "AlphaDropout": [((0.5,), {}, (_f(3, 4),), (0,))],
    "Dropout3D": [((0.5,), {}, (_VOL,), (0,))],
    "PairwiseDistance": [((), {}, (_f(3, 4), _f(3, 4, seed=1)), (0, 1)),
                         ((1.0,), {"keepdim": True},
                          (_f(3, 4), _f(3, 4, seed=1)), (0,))],
    "CTCLoss": [((), {}, (_f(6, 2, 4), np.array([[1, 2], [3, 0]], np.int64),
                          np.array([6, 5], np.int64),
                          np.array([2, 1], np.int64)), (0,))],
    "HSigmoidLoss": [((5, 6), {}, (_f(4, 5), np.array([[0], [5], [3], [2]],
                                                      np.int64)), (0,))],
    "BilinearTensorProduct": [((4, 5, 2), {}, (_f(3, 4), _f(3, 5, seed=1)),
                               (0, 1))],
    "RowConv": [((3, 2), {}, (_f(2, 5, 3),), (0,))],
    "Conv1DTranspose": [((3, 2, 3), {"stride": 2}, (_f(2, 3, 5),), (0,))],
    "Conv3DTranspose": [((2, 3, 2), {"stride": 2}, (_f(1, 2, 3, 3, 3),),
                         (0,))],
    "MaxPool3D": [((2,), {"stride": 2}, (_VOL,), (0,))],
    "AvgPool3D": [((3,), {"stride": 1, "padding": 1}, (_VOL,), (0,))],
    "AdaptiveAvgPool1D": [((3,), {}, (_f(2, 3, 7),), (0,))],
    "AdaptiveMaxPool1D": [((4,), {}, (_f(2, 3, 7),), (0,))],
    "AdaptiveAvgPool3D": [(([2, 3, 2],), {}, (_VOL,), (0,))],
    "AdaptiveMaxPool3D": [((2,), {}, (_VOL,), (0,))],
    "Pool2D": [((2, "avg", 2), {}, (_IMG,), (0,)),
               ((), {"pool_type": "max", "global_pooling": True}, (_IMG,),
                (0,))],
}


def _layer_pair(name, ctor, kw):
    with _fresh_jax_stream(), Jdy.guard():
        jl = getattr(J.nn, name)(*ctor, **kw)
        state = {k: np.asarray(v) for k, v in j_state(jl).items()}
    tl = getattr(T.nn, name)(*ctor, **kw)
    load_jax_state(tl, state)
    return jl, tl


LAYER_CASES = [(n, i) for n in sorted(LAYERS) for i in range(len(LAYERS[n]))]


@pytest.mark.parametrize("name,i", LAYER_CASES)
def test_layer_matches_the_reference(name, i):
    """Train mode (eval for the dropout layers): the forward, the inputs'
    gradients and every parameter's."""
    ctor, kw, inputs, grad = LAYERS[name][i]
    jl, tl = _layer_pair(name, ctor, kw)
    if "Dropout" in name:
        jl.eval()
        tl.eval()
    jp = dict(jl.named_parameters())
    tp = dict(tl.named_parameters())
    assert set(jp) == set(tp)
    _run_both(jl, tl, inputs, {}, grad,
              RESIZE if "Upsampl" in name else F32, (jp, tp))


def test_every_new_layer_is_held():
    new = _public(T.nn) - {
        "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BCELoss",
        "BCEWithLogitsLoss", "Conv2D", "CrossEntropyLoss", "Dropout",
        "Embedding", "Flatten", "GELU", "KLDivLoss", "L1Loss", "Layer",
        "LayerNorm", "Linear", "MarginRankingLoss", "MaxPool2D", "MSELoss",
        "MultiHeadAttention", "NLLLoss", "Parameter", "ReLU", "ReLU6",
        "Sequential", "SmoothL1Loss", "Tanh", "Transformer",
        "TransformerDecoder", "TransformerDecoderLayer",
        "TransformerEncoder", "TransformerEncoderLayer", "AdaptiveAvgPool2D",
        "AdaptiveMaxPool2D", "AvgPool2D", "GRU", "LSTM", "RNN", "BiRNN",
        "GRUCell", "LSTMCell", "RNNCellBase", "SimpleRNN", "SimpleRNNCell",
        "BeamSearchDecoder", "Decoder", "dynamic_decode", "functional",
        "initializer", "conv", "loss", "vision", "layer", "decode"}
    held = set(LAYERS) | {"LayerList", "ParameterList", "SpectralNorm"}
    # the static graph's clip names, held in test_torch_fluid_optimizer.py
    static_clip = {"ClipGradByGlobalNorm", "ClipGradByNorm",
                   "ClipGradByValue", "clip", "clip_by_norm"}
    assert new == held | static_clip
    for name in static_clip:
        assert getattr(T.nn, name) is getattr(T.fluid.clip, name, None) \
            or getattr(T.nn, name) is getattr(T.fluid.layers, name), name


def test_spectral_norm_layer_refines_its_vectors_as_the_reference():
    """The output, and weight_u / weight_v written back after the
    forward (two calls: the second starts from the refined vectors)."""
    w = _f(4, 3, 2)
    jl, tl = _layer_pair("SpectralNorm", ([4, 3, 2],),
                         {"dim": 1, "power_iters": 2})
    for _ in range(2):
        with Jdy.guard():
            want = jl(J.to_tensor(w)).numpy()
        got = tl(torch.from_numpy(w)).detach().numpy()
        np.testing.assert_allclose(got, want, **F32)
        for k in ("weight_u", "weight_v"):
            np.testing.assert_allclose(
                getattr(tl, k).detach().numpy(),
                np.asarray(getattr(jl, k).numpy()), **F32)


def test_layer_and_parameter_lists():
    layers = [T.nn.Linear(2, 2) for _ in range(3)]
    ll = T.nn.LayerList(layers[:2])
    ll.append(layers[2])
    ll.insert(1, T.nn.ReLU())
    assert len(ll) == 4 and ll[0] is layers[0] and ll[2] is layers[1]
    assert len(list(ll.parameters())) == 6 and len(ll[1:]) == 3
    pl = T.nn.ParameterList([T.nn.Parameter(torch.ones(2))])
    pl.append(T.nn.Parameter(torch.zeros(3)))
    assert len(pl) == 2 and len(list(pl.parameters())) == 2
    with Jdy.guard():
        jll = J.nn.LayerList([J.nn.Linear(2, 2) for _ in range(3)])
        jll.insert(1, J.nn.ReLU())
        assert len(jll) == 4 and len(jll.parameters()) == 6


# -- the random ones --------------------------------------------------------------

@pytest.mark.parametrize("fn,shape,c_axis", [
    ("dropout2d", (40, 50, 2, 2), 1), ("dropout3d", (40, 50, 1, 2, 2), 1)])
def test_channel_dropout_statistics_and_identities(fn, shape, c_axis):
    """Whole (sample, channel) maps dropped with probability p (within 5
    standard errors of 2000 draws), the rest scaled by 1 / (1 - p); the
    identity in eval and at p 0, as in the reference."""
    f = getattr(T.nn.functional, fn)
    x = torch.ones(shape)
    assert f(x, 0.3, training=False) is x and f(x, 0.0) is x
    out = f(x, 0.3, generator=torch.Generator().manual_seed(0))
    per_map = out.reshape(shape[0], shape[1], -1)
    assert (per_map == per_map[..., :1]).all()
    assert torch.isclose(per_map[per_map != 0], torch.tensor(1 / 0.7)).all()
    dropped = float((per_map[..., 0] == 0).float().mean())
    assert abs(dropped - 0.3) < 5 * (0.21 / 2000) ** 0.5
    with Jdy.guard():
        jx = J.to_tensor(np.ones(shape, np.float32))
        assert np.array_equal(getattr(J.nn.functional, fn)(
            jx, 0.3, training=False).numpy(), jx.numpy())


def test_alpha_dropout_keeps_the_mean_and_variance():
    """alpha_dropout of N(0, 1) values keeps mean 0 and variance 1 (SELU's
    fixed point) within 5 standard errors of 40000 draws; eval and p 0
    are the identity in both."""
    x = torch.from_numpy(_f(200, 200))
    out = T.nn.functional.alpha_dropout(
        x, 0.2, generator=torch.Generator().manual_seed(0))
    assert abs(float(out.mean())) < 5 / 200
    assert abs(float(out.var()) - 1.0) < 5 * (2 / 40000) ** 0.5
    assert T.nn.functional.alpha_dropout(x, 0.2, training=False) is x
    with Jdy.guard():
        jx = J.to_tensor(_f(3, 4))
        assert np.array_equal(J.nn.functional.alpha_dropout(
            jx, 0.2, training=False).numpy(), jx.numpy())


def test_nce_draws_its_negatives():
    """F.nce through the nce rule: (B, 1) costs, positive and finite,
    differentiable in the input and weights (its draws are held against
    the reference's formula in test_torch_fluid_ops.py)."""
    x = torch.from_numpy(_f(4, 3)).requires_grad_(True)
    w = torch.from_numpy(_f(7, 3, seed=1)).requires_grad_(True)
    cost = T.nn.functional.nce(x, torch.tensor([[1], [6], [0], [3]]), 7,
                               num_neg_samples=3, weight=w)
    assert cost.shape == (4, 1) and bool((cost > 0).all())
    cost.sum().backward()
    assert torch.isfinite(x.grad).all() and torch.isfinite(w.grad).all()


def test_random_crop_takes_a_window_of_its_input():
    """F.random_crop through the random_crop rule: the trailing dims cut
    to `shape` at offsets it draws, every row of the batch at the same
    ones, as the reference's rule crops."""
    x = torch.arange(2 * 3 * 6 * 7, dtype=torch.float32).reshape(2, 3, 6, 7)
    out = T.nn.functional.random_crop(x, [4, 5], seed=3)
    assert out.shape == (2, 3, 4, 5)
    r0 = int(out[0, 0, 0, 0]) // 7 % 6
    c0 = int(out[0, 0, 0, 0]) % 7
    assert 0 <= r0 <= 2 and 0 <= c0 <= 2
    np.testing.assert_array_equal(out.numpy(),
                                  x[:, :, r0:r0 + 4, c0:c0 + 5].numpy())


def test_rnn_and_birnn_drive_cells_as_the_reference():
    x = _f(2, 4, 3)
    with _fresh_jax_stream(), Jdy.guard():
        cell = J.nn.SimpleRNNCell(3, 5)
        state = {k: np.asarray(v) for k, v in j_state(cell).items()}
        want = J.nn.functional.rnn(cell, J.to_tensor(x))[0].numpy()
    tcell = load_jax_state(T.nn.SimpleRNNCell(3, 5), state)
    got = T.nn.functional.rnn(tcell, torch.from_numpy(x))[0]
    np.testing.assert_allclose(got.detach().numpy(), want, **F32)
    out, _ = T.nn.functional.birnn(tcell, T.nn.SimpleRNNCell(3, 5),
                                   torch.from_numpy(x))
    assert out.shape == (2, 4, 10)


def test_reference_forms_that_raise_raise_in_the_port_too():
    """gru_unit's rule reads the activations as integer codes, so the
    functional's default names raise ValueError; F.lstm reads an Out
    slot the lstm rule does not give (KeyError); prelu with more than
    one alpha raises (its mode is 'all')."""
    gx, gh, gw = _f(2, 9), _f(2, 3, seed=1), _f(3, 9, seed=2)
    lx, lw, lb = _f(2, 4, 12), _f(3, 12, seed=1), _f(1, 12, seed=2)
    with Jdy.guard():
        with pytest.raises(ValueError):
            J.nn.functional.gru_unit(J.to_tensor(gx), J.to_tensor(gh),
                                     J.to_tensor(gw))
        with pytest.raises(KeyError):
            J.nn.functional.lstm(J.to_tensor(lx), None, None,
                                 J.to_tensor(lw), J.to_tensor(lb))
        with pytest.raises(Exception):
            J.nn.functional.prelu(J.to_tensor(_f(2, 3)),
                                  J.to_tensor(_f(3, seed=1)))
    with pytest.raises(ValueError):
        T.nn.functional.gru_unit(torch.from_numpy(gx), torch.from_numpy(gh),
                                 torch.from_numpy(gw))
    with pytest.raises(KeyError):
        T.nn.functional.lstm(torch.from_numpy(lx), None, None,
                             torch.from_numpy(lw), torch.from_numpy(lb))
    with pytest.raises(RuntimeError):
        T.nn.functional.prelu(torch.from_numpy(_f(2, 3)),
                              torch.from_numpy(_f(3, seed=1)))


def test_conv3d_int_padding_raises_in_the_reference_and_pads_in_the_port():
    """The reference's conv3d makes an int padding a pair its op cannot
    read (IndexError); the port pads every dim (ROADMAP queue 3)."""
    x, w = _VOL, _f(3, 2, 3, 3, 3, seed=1)
    with Jdy.guard():
        with pytest.raises(IndexError):
            J.nn.functional.conv3d(J.to_tensor(x), J.to_tensor(w),
                                   padding=1)
        want = J.nn.functional.conv3d(J.to_tensor(x), J.to_tensor(w),
                                      padding=[1, 1, 1]).numpy()
    got = T.nn.functional.conv3d(torch.from_numpy(x), torch.from_numpy(w),
                                 padding=1)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("fn,kw,what", [
    ("avg_pool1d", {"exclusive": False}, "exclusive"),
    ("avg_pool3d", {"divisor_override": 2}, "divisor_override"),
    ("conv3d_transpose", {"output_padding": 1}, "output_padding"),
    ("diag_embed", {"offset": 1}, "offset"),
    ("max_pool3d", {"return_mask": True}, "return_mask"),
])
def test_arguments_the_reference_ignores_raise(fn, kw, what):
    x = {"avg_pool1d": (_f(2, 3, 8), 2), "avg_pool3d": (_VOL, 2),
         "conv3d_transpose": (_f(1, 2, 3, 3, 3), _f(2, 3, 2, 2, 2, seed=1)),
         "diag_embed": (_f(2, 3),), "max_pool3d": (_VOL, 2)}[fn]
    args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in x]
    with pytest.raises(NotImplementedError, match=what):
        getattr(T.nn.functional, fn)(*args, **kw)


def test_guards_answer_as_the_reference():
    """The names the reference does not carry raise NotImplementedError
    with the same reason and alternative in the port."""
    from paddle_tpu_torch.nn.functional import extra
    guards = [n for n in extra.__all__
              if getattr(extra, n).__qualname__.startswith("_na")]
    for n in guards:
        msgs = []
        for F in (J.nn.functional, T.nn.functional):
            with pytest.raises(NotImplementedError) as e:
                getattr(F, n)()
            msgs.append(str(e.value))
        assert msgs[0].split(": ", 1)[1].split(" (SURVEY")[0] == \
            msgs[1].split(": ", 1)[1].split(". Use instead")[0], n
        assert msgs[0].rsplit("Use instead: ", 1)[1] == \
            msgs[1].rsplit("Use instead: ", 1)[1], n
