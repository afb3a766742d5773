"""The port's fluid.layers modules against paddle_tpu's on the CPU: for
each module (tensor, nn, loss, the learning-rate schedules,
math_op_patch, rnn, compat, sequence_lod) one program that calls its
layers is built by both packages, which must give the same Program JSON
(`to_dict()`); the reference's JSON then runs in both Executors from the
reference's startup values, and every fetch agrees.  Then compat's
raise-or-answer rule, and the `paddle.static` and top-level names.

Tolerances.  F32 (rtol 1e-5, atol 1e-6): a few float32 ops whose only
difference is the order of operations.  Integer and bool results are
compared by value: the reference gives int32 where the port keeps int64.
"""

import json

import numpy as np
import pytest

import paddle_tpu.fluid as JF
from paddle_tpu.fluid import flags as jax_flags
from paddle_tpu.fluid import unique_name as JU
from paddle_tpu.fluid.layers import compat as jcompat

import paddle_tpu_torch as T
import paddle_tpu_torch.fluid as TF
from paddle_tpu_torch.convert import load_jax_scope
from paddle_tpu_torch.fluid import unique_name as TU

F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _no_shared_aot_cache():
    old = jax_flags.get_flags("FLAGS_aot_cache")
    jax_flags.set_flags({"FLAGS_aot_cache": "off"})
    try:
        yield
    finally:
        jax_flags.set_flags({"FLAGS_aot_cache": old})


def _f(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _pos(*shape, seed=0):
    return np.abs(_f(*shape, seed=seed)) + 0.5


def _probs(n, c, seed=0):
    z = _f(n, c, seed=seed)
    e = np.exp(z - z.max(1, keepdims=True))
    return (e / e.sum(1, keepdims=True)).astype(np.float32)


def _ids(shape, high, seed=0):
    return np.random.RandomState(seed).randint(0, high, shape).astype(
        np.int64)


def _build(fluid, unique_name, builder):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), unique_name.guard():
        feeds, fetches = builder(fluid)
    return main, startup, feeds, fetches


def _json(prog):
    return json.dumps(prog.to_dict(), sort_keys=True, default=str)


def _both(builder, runs=1):
    """Build with both packages (the same JSON), run the reference's
    program in both Executors `runs` times; yields (want, got) fetch
    lists."""
    jm, js, feeds, fetches = _build(JF, JU, builder)
    tm, ts, _, _ = _build(TF, TU, builder)
    assert _json(tm) == _json(jm)
    assert _json(ts) == _json(js)
    names = [v.name for v in fetches]
    jexe, jscope = JF.Executor(), JF.Scope()
    jexe.run(js, scope=jscope)
    texe, tscope = TF.Executor(TF.CPUPlace()), TF.Scope()
    texe.run(TF.Program.from_dict(js.to_dict()), scope=tscope)
    load_jax_scope(tscope, {n: np.asarray(jscope.get(n))
                            for n in jscope.local_var_names()})
    tmain = TF.Program.from_dict(jm.to_dict())
    for _ in range(runs):
        want = jexe.run(jm, feed=feeds, fetch_list=names, scope=jscope)
        got = texe.run(tmain, feed=feeds, fetch_list=names, scope=tscope)
        yield names, [np.asarray(w) for w in want], \
            [np.asarray(g) for g in got]


def _check(builder, runs=1):
    for names, want, got in _both(builder, runs):
        for n, w, g in zip(names, want, got):
            assert g.shape == w.shape, (n, g.shape, w.shape)
            if np.issubdtype(w.dtype, np.floating):
                assert g.dtype == w.dtype, (n, g.dtype, w.dtype)
                np.testing.assert_allclose(g, w, err_msg=n, **F32)
            else:
                np.testing.assert_array_equal(g, w, err_msg=n)


# -- one program a module -------------------------------------------------------

def _tensor_module(fluid):
    L = fluid.layers
    x = fluid.data("x", [3, 4], "float32")
    y = fluid.data("y", [3, 4], "float32")
    i = fluid.data("i", [3], "int64")
    col = fluid.data("col", [3, 1], "int64")
    idx2 = fluid.data("idx2", [2, 2], "int64")
    upd = fluid.data("upd", [2, 4], "float32")
    upd1 = fluid.data("upd1", [2], "float32")
    pick = fluid.data("pick", [3, 2], "int64")
    v = fluid.data("v", [4], "float32")
    mask = L.greater_than(x, y)
    sorted_x, order = L.argsort(x, axis=1)
    counter = L.create_global_var([1], 2.0, "float32", persistable=True)
    param = L.create_parameter([4, 2], "float32", name="w_created")
    outs = [
        L.cast(x, "int32"), L.sums([x, y, x]), L.assign(x),
        L.assign(np.arange(6, dtype=np.float32).reshape(2, 3)),
        L.fill_constant_batch_size_like(x, [-1, 2], "float32", 1.5),
        L.ones([2, 2]), L.zeros([2], "int64"), L.ones_like(x),
        L.zeros_like(x), L.full_like(x, 2.0), L.full([2], 3.0),
        L.reverse(x, 1), L.range(0, 6, 2), L.linspace(0, 1, 5),
        L.eye(3, 4), L.diag(v), L.argmax(x, axis=1), L.argmin(x, axis=0),
        sorted_x, order, L.shape(x), L.slice(x, [1], [1], [3]),
        L.strided_slice(x, [1], [0], [4], [2]),
        L.stack([x, y], axis=0),
        *L.unstack(x, axis=0), L.expand(x, [2, 1]),
        L.expand_as(v, target_shape=[3, 4]), L.tile(x, [1, 2]),
        L.gather(x, i), L.gather_nd(x, idx2),
        L.scatter(x, L.slice(i, [0], [0], [2]), upd),
        L.scatter_nd_add(x, idx2, upd1), L.where(mask, x, y),
        L.index_select(x, i, axis=0), L.index_sample(x, pick),
        L.roll(x, 1, axis=1), L.flip(x, 0), L.tril(x), L.triu(x, 1),
        L.one_hot(col, 5), L.unsqueeze(x, [0]),
        L.squeeze(L.unsqueeze(x, [0]), [0]), L.cumsum(x, axis=1),
        *L.meshgrid([v, v]), L.increment(counter, 1.5, in_place=False),
        L.matmul(x, param)]
    feeds = {"x": _f(3, 4), "y": _f(3, 4, seed=1),
             "i": np.array([2, 0, 2], np.int64),
             "col": np.array([[1], [4], [0]], np.int64),
             "idx2": np.array([[1, 2], [0, 3]], np.int64),
             "upd": _f(2, 4, seed=2), "upd1": _f(2, seed=3),
             "pick": np.array([[3, 0], [1, 1], [2, 3]], np.int64),
             "v": _f(4, seed=4)}
    return feeds, outs


def _nn_module(fluid):
    L = fluid.layers
    x = fluid.data("x", [3, 4], "float32")
    y = fluid.data("y", [3, 4], "float32")
    p = fluid.data("p", [3, 4], "float32")
    z = fluid.data("z", [4, 2], "float32")
    x3 = fluid.data("x3", [2, 4, 3], "float32")
    z3 = fluid.data("z3", [2, 3, 5], "float32")
    img = fluid.data("img", [1, 2, 3, 3], "float32")
    col = fluid.data("col", [3, 1], "int64")
    logits = fluid.data("logits", [6, 2, 4], "float32")
    label = fluid.data("label", [2, 2], "int64")
    lens = fluid.data("lens", [2], "int64")
    lab_lens = fluid.data("lab_lens", [2], "int64")
    em = fluid.data("em", [2, 5, 3], "float32")
    tags = fluid.data("tags", [2, 5], "int64")
    em_lens = fluid.data("em_lens", [2], "int64")
    acts = [L.softmax(x), L.log_softmax(x), L.relu(x), L.relu6(x * 4.0),
            L.sigmoid(x), L.tanh(x), L.sqrt(p), L.rsqrt(p), L.square(x),
            L.abs(x), L.exp(x), L.log(p), L.floor(x), L.ceil(x), L.round(x),
            L.sin(x), L.cos(x), L.erf(x), L.reciprocal(p), L.sign(x),
            L.softsign(x), L.softplus(x), L.gelu(x), L.leaky_relu(x, 0.1),
            L.elu(x, 0.5), L.swish(x, 1.5), L.hard_sigmoid(x),
            L.hard_swish(x)]
    less = L.less_than(x, y)
    more = L.greater_than(x, y)
    math = [L.mean(x), L.mul(x, z), L.matmul(x, z), L.matmul(
        x, y, transpose_y=True, alpha=0.5), L.bmm(x3, z3), L.dot(x, y),
        L.elementwise_add(x, y), L.elementwise_sub(x, y),
        L.elementwise_mul(x, y), L.elementwise_div(x, p),
        L.elementwise_pow(p, y), L.elementwise_max(x, y),
        L.elementwise_min(x, y), L.elementwise_mod(x, p),
        L.elementwise_floordiv(x, p), L.equal(x, y), L.not_equal(x, y),
        less, L.less_equal(x, y), more, L.greater_equal(x, y),
        L.logical_and(less, more), L.logical_or(less, more),
        L.logical_xor(less, more), L.logical_not(less), L.maximum(x, y),
        L.minimum(x, y), L.reduce_sum(x, dim=1), L.reduce_mean(x),
        L.reduce_max(x, dim=[0]), L.reduce_min(x, dim=1, keep_dim=True),
        L.reduce_prod(x, dim=1), L.reduce_all(less, dim=1),
        L.reduce_any(less), L.clip(x, -0.5, 0.5), L.clip_by_norm(x, 1.0),
        L.scale(x, 2.0, 0.5), L.pow(p, 1.5), L.reshape(x, [4, 3]),
        L.transpose(x, [1, 0]), L.flatten(x3, 2), *L.topk(x, 2),
        L.one_hot(col, 5), L.l2_normalize(x, 1),
        L.pad(x, [1, 0, 0, 2], 0.5), L.pad2d(img, [1, 0, 2, 1],
                                             mode="reflect"),
        L.cumsum(x, axis=0), L.isfinite(x), L.row_conv(x3, 2)]
    seq = [L.warpctc(logits, label, input_length=lens,
                     label_length=lab_lens),
           *L.ctc_greedy_decoder(L.transpose(logits, [1, 0, 2]), 0,
                                 input_length=lens),
           *L.edit_distance(label, label * 0 + 1, input_length=lab_lens,
                            label_length=lab_lens),
           L.linear_chain_crf(em, tags, length=em_lens,
                              param_attr=fluid.ParamAttr(name="crfw")),
           L.crf_decoding(em, param_attr=fluid.ParamAttr(name="crfw"),
                          length=em_lens),
           L.crf_decoding(em, param_attr=fluid.ParamAttr(name="crfw"),
                          label=tags, length=em_lens)]
    feeds = {"x": _f(3, 4, scale=2), "y": _f(3, 4, seed=1), "p": _pos(3, 4),
             "z": _f(4, 2, seed=2), "x3": _f(2, 4, 3, seed=3),
             "z3": _f(2, 3, 5, seed=4), "img": _f(1, 2, 3, 3, seed=5),
             "col": np.array([[1], [4], [0]], np.int64),
             "logits": _f(6, 2, 4, seed=6),
             "label": np.array([[1, 2], [3, 3]], np.int64),
             "lens": np.array([6, 5], np.int64),
             "lab_lens": np.array([2, 1], np.int64),
             "em": _f(2, 5, 3, seed=7), "tags": _ids((2, 5), 3),
             "em_lens": np.array([5, 3], np.int64)}
    return feeds, acts + math + seq


def _loss_module(fluid):
    L = fluid.layers
    probs = fluid.data("probs", [4, 3], "float32")
    logits = fluid.data("logits", [4, 3], "float32")
    lab = fluid.data("lab", [4, 1], "int64")
    soft = fluid.data("soft", [4, 3], "float32")
    a = fluid.data("a", [4, 1], "float32")
    b = fluid.data("b", [4, 1], "float32")
    outs = [L.cross_entropy(probs, lab),
            L.softmax_with_cross_entropy(logits, lab),
            L.square_error_cost(a, b), L.mse_loss(a, b),
            L.sigmoid_cross_entropy_with_logits(logits, soft),
            L.log_loss(probs, soft), L.huber_loss(a, b, 0.8),
            L.smooth_l1(logits, soft, sigma=1.5),
            L.kldiv_loss(L.log(probs), soft, "batchmean")]
    feeds = {"probs": _probs(4, 3), "logits": _f(4, 3), "lab": _ids((4, 1), 3),
             "soft": _probs(4, 3, seed=1), "a": _f(4, 1, seed=2),
             "b": _f(4, 1, seed=3)}
    return feeds, outs


def _lr_module(fluid):
    L = fluid.layers
    outs = [L.noam_decay(64, 2), L.exponential_decay(0.1, 2, 0.5),
            L.natural_exp_decay(0.1, 2, 0.5, staircase=True),
            L.inverse_time_decay(0.1, 2, 0.5),
            L.polynomial_decay(0.1, 4, 0.001, power=2.0),
            L.piecewise_decay([2, 4], [0.1, 0.05, 0.01]),
            L.cosine_decay(0.1, 2, 4), L.linear_lr_warmup(0.1, 3, 0.0, 0.1)]
    return {}, outs


def _math_op_patch_module(fluid):
    x = fluid.data("x", [3, 4], "float32")
    y = fluid.data("y", [3, 4], "float32")
    p = fluid.data("p", [3, 4], "float32")
    z = fluid.data("z", [4, 2], "float32")
    outs = [x + y, x - y, x * y, x / p, p ** y, x % p, x // p, x @ z, -x,
            x + 2, 2 + x, x - 2, 2 - x, x * 3, 3 * x, x / 4, 4 / p, p ** 2,
            x % 3.0, x // 2.0, x == y, x != y, x < y, x <= y, x > y, x >= y,
            x < 0.5]
    feeds = {"x": np.round(_f(3, 4) * 2) / 2,
             "y": np.round(_f(3, 4, seed=1) * 2) / 2, "p": _pos(3, 4),
             "z": _f(4, 2, seed=2)}
    return feeds, outs


def _rnn_module(fluid):
    L = fluid.layers
    x = fluid.data("x", [2, 5, 12], "float32")
    x9 = fluid.data("x9", [2, 5, 9], "float32")
    h0 = fluid.data("h0", [2, 3], "float32")
    c0 = fluid.data("c0", [2, 3], "float32")
    pre_ids = fluid.data("pre_ids", [4, 1], "int64")
    pre_scores = fluid.data("pre_scores", [4, 1], "float32")
    ids = fluid.data("ids", [4, 3], "int64")
    scores = fluid.data("scores", [4, 3], "float32")
    step_ids = fluid.data("step_ids", [3, 4], "int64")
    parents = fluid.data("parents", [3, 4], "int64")
    step_scores = fluid.data("step_scores", [3, 4], "float32")
    outs = [*L.dynamic_lstm(x, 12), *L.dynamic_lstm(
        x, 12, is_reverse=True, candidate_activation="relu",
        cell_activation="sigmoid"), *L.dynamic_lstm(x, 12, h_0=h0, c_0=c0),
        L.rnn.dynamic_gru(x9, 3), L.rnn.dynamic_gru(
            x9, 3, h_0=h0, is_reverse=True, origin_mode=True),
        *L.beam_search(pre_ids, pre_scores, ids, scores, 2, 1),
        *L.beam_search(pre_ids, pre_scores, None, scores, 2, 1,
                       is_accumulated=False),
        *L.beam_search_decode(step_ids, parents, step_scores)]
    feeds = {"x": _f(2, 5, 12), "x9": _f(2, 5, 9, seed=1),
             "h0": _f(2, 3, seed=2), "c0": _f(2, 3, seed=3),
             "pre_ids": np.array([[3], [1], [2], [4]], np.int64),
             "pre_scores": _f(4, 1, seed=4), "ids": _ids((4, 3), 9),
             "scores": _f(4, 3, seed=5), "step_ids": _ids((3, 4), 9),
             "parents": np.array([[0, 1, 2, 3], [1, 1, 3, 2],
                                  [0, 0, 2, 2]], np.int64),
             "step_scores": _f(3, 4, seed=6)}
    return feeds, outs


def _compat_module(fluid):
    L = fluid.layers
    x = fluid.data("x", [3, 4], "float32")
    y = fluid.data("y", [3, 4], "float32")
    probs = fluid.data("probs", [3, 4], "float32")
    lab = fluid.data("lab", [3, 1], "int64")
    tree_ids = fluid.data("tree_ids", [3, 2, 2], "int64")
    tree_parents = fluid.data("tree_parents", [3, 2, 2], "int64")
    which = fluid.data("which", [3, 1], "int64")
    vals = fluid.data("vals", [6], "int64")
    idx2 = fluid.data("idx2", [2, 2], "int64")
    upd1 = fluid.data("upd1", [2], "float32")
    outs = [L.cos_sim(x, y), L.gather_tree(tree_ids, tree_parents),
            L.multiplex([x, y], which), L.unbind(x, 0),
            L.stanh(x, 0.5, 2.0), L.mish(x), L.size(x), *L.unique(vals),
            *L.unique_with_counts(vals), L.sum([x, y]),
            L.scatter_nd(idx2, upd1, [3, 4]), L.brelu(x, 0.0, 0.5),
            L.soft_relu(x, 1.0), L.has_inf(x), L.has_nan(x),
            L.dice_loss(probs, lab),
            L.sampled_softmax_with_cross_entropy(x, lab, 2)]
    feeds = {"x": _f(3, 4), "y": _f(3, 4, seed=1), "probs": _probs(3, 4),
             "lab": _ids((3, 1), 4), "tree_ids": _ids((3, 2, 2), 9),
             "tree_parents": np.array([[[0, 1], [1, 0]], [[1, 1], [0, 1]],
                                       [[1, 0], [0, 0]]], np.int64),
             "which": np.array([[1], [0], [1]], np.int64),
             "vals": np.array([3, 1, 3, 2, 1, 5], np.int64),
             "idx2": np.array([[1, 2], [1, 2]], np.int64),
             "upd1": _f(2, seed=3)}
    return feeds, outs


def _sequence_module(fluid):
    L = fluid.layers
    x = fluid.data("x", [3, 5, 4], "float32")
    lens = fluid.data("lens", [3], "int64")
    outs = [L.sequence_conv(x, 6, filter_size=3, length=lens, act="tanh"),
            L.sequence_conv(x, 2, filter_size=2, padding_start=-1,
                            bias_attr=False),
            *[L.sequence_pool(x, t, length=lens, pad_value=0.5)
              for t in ("sum", "average", "sqrt", "max", "last", "first")],
            L.sequence_first_step(x, length=lens),
            L.sequence_last_step(x, length=lens)]
    return {"x": _f(3, 5, 4), "lens": np.array([5, 2, 0], np.int64)}, outs


def _nn_bucket_module(fluid):
    """The layers of the nn bucket's rules (nn.py of the reference,
    :131-1234): the transposed and 3-D convolutions, depthwise conv2d,
    the norms, dropout in test mode, prelu, maxout, label_smooth,
    unfold, the resizes, bilinear_tensor_product, spectral_norm,
    data_norm and deform_conv2d."""
    L = fluid.layers
    img = fluid.data("img", [2, 4, 5, 5], "float32")
    vol = fluid.data("vol", [1, 2, 4, 4, 4], "float32")
    x = fluid.data("x", [3, 4], "float32")
    y = fluid.data("y", [3, 5], "float32")
    onehot = fluid.data("onehot", [3, 4], "float32")
    w = fluid.data("w", [4, 3, 2], "float32")
    off = fluid.data("off", [2, 18, 5, 5], "float32")
    msk = fluid.data("msk", [2, 9, 5, 5], "float32")
    outs = [L.conv2d(img, 4, 3, padding=1, groups=4),
            L.conv2d_transpose(img, 3, filter_size=3, stride=2, padding=1),
            L.conv2d_transpose(img, 2, output_size=9, stride=2, act="relu"),
            L.conv3d(vol, 3, 3, padding=1),
            L.conv3d_transpose(vol, 2, filter_size=2, stride=2),
            L.layer_norm(img, begin_norm_axis=2),
            L.layer_norm(x, scale=False, shift=False),
            L.instance_norm(img), L.group_norm(img, 2, act="relu"),
            L.dropout(x, 0.3, is_test=True),
            L.dropout(x, 0.3, is_test=True,
                      dropout_implementation="upscale_in_train"),
            L.prelu(img, "channel"), L.prelu(x, "all"),
            L.maxout(img, 2), L.label_smooth(onehot, epsilon=0.2),
            L.unfold(img, [2, 3], paddings=1),
            L.image_resize(img, out_shape=[7, 8]),
            L.resize_nearest(img, scale=2.0),
            L.resize_bilinear(img, out_shape=[3, 4]),
            L.interpolate(img, out_shape=[6, 6], mode="bilinear"),
            L.bilinear_tensor_product(x, y, 2, act="tanh"),
            L.spectral_norm(w, dim=1, power_iters=2),
            L.data_norm(x), L.deform_conv2d(img, off, msk, 3, 3, padding=1)]
    rng = np.random.RandomState(9)
    feeds = {"img": _f(2, 4, 5, 5), "vol": _f(1, 2, 4, 4, 4, seed=1),
             "x": _f(3, 4, seed=2), "y": _f(3, 5, seed=3),
             "onehot": np.eye(4, dtype=np.float32)[[0, 2, 3]],
             "w": _f(4, 3, 2, seed=4),
             "off": (rng.randn(2, 18, 5, 5) * 0.7).astype(np.float32),
             "msk": rng.rand(2, 9, 5, 5).astype(np.float32)}
    return feeds, outs


def _vision_compat_module(fluid):
    """compat's wrappers of the nn and vision buckets' rules."""
    L = fluid.layers
    img = fluid.data("img", [2, 8, 4, 4], "float32")
    grid = fluid.data("grid", [2, 3, 3, 2], "float32")
    theta = fluid.data("theta", [2, 2, 3], "float32")
    ch = fluid.data("ch", [8], "float32")
    small = fluid.data("small", [2, 8, 2, 3], "float32")
    vol = fluid.data("vol", [1, 2, 4, 4, 4], "float32")
    line = fluid.data("line", [2, 3, 5], "float32")
    lab = fluid.data("lab", [4, 1], "int64")
    feat = fluid.data("feat", [4, 5], "float32")
    left = fluid.data("left", [4, 1], "float32")
    right = fluid.data("right", [4, 1], "float32")
    sign = fluid.data("sign", [4, 1], "float32")
    outs = [L.affine_channel(img, ch, ch), L.affine_grid(theta, [2, 1, 3, 4]),
            L.grid_sampler(img, grid),
            L.pad_constant_like(img, small, pad_value=0.5),
            L.pixel_shuffle(img, 2), L.pool3d(vol, ksize=[2, 2, 2],
                                              strides=[2, 2, 2]),
            L.space_to_depth(img, 2), L.temporal_shift(img, 2, 0.25),
            L.lrn(img, 5, 1.0, 1e-3, 0.75),
            L.resize_trilinear(vol, out_d=6, out_h=3, out_w=5),
            L.resize_linear(line, out_w=8), L.selu(img),
            L.bpr_loss(feat, lab), L.rank_loss(sign, left, right),
            L.margin_rank_loss(sign, left, right, 0.1),
            L.crop(img, offsets=[0, 2, 1, 0], shape=[2, 4, 2, 3])]
    rng = np.random.RandomState(3)
    feeds = {"img": _f(2, 8, 4, 4), "grid": (rng.rand(2, 3, 3, 2) * 1.6
                                             - 0.8).astype(np.float32),
             "theta": _f(2, 2, 3, seed=1), "ch": _f(8, seed=2),
             "small": _f(2, 8, 2, 3, seed=3),
             "vol": _f(1, 2, 4, 4, 4, seed=4), "line": _f(2, 3, 5, seed=5),
             "lab": _ids((4, 1), 5), "feat": _f(4, 5, seed=6),
             "left": _f(4, 1, seed=7), "right": _f(4, 1, seed=8),
             "sign": np.array([[1.], [0.], [1.], [0.]], np.float32)}
    return feeds, outs


MODULES = {"tensor": _tensor_module, "nn": _nn_module, "loss": _loss_module,
           "math_op_patch": _math_op_patch_module, "rnn": _rnn_module,
           "compat": _compat_module, "sequence_lod": _sequence_module,
           "nn_bucket": _nn_bucket_module,
           "vision_compat": _vision_compat_module}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_layers_build_and_run_as_the_reference(name):
    _check(MODULES[name])


def test_split_raises_in_the_reference_and_splits_in_the_port():
    """paddle_tpu's fluid.layers.split calls its module's `range` layer
    where it means the builtin and raises TypeError (ROADMAP queue 3);
    the port's splits, as numpy does."""
    def build(fluid):
        x = fluid.data("x", [3, 4], "float32")
        return {"x": _f(3, 4)}, [*fluid.layers.split(x, 2, dim=1),
                                 *fluid.layers.split(x, [1, 2], dim=0)]

    with pytest.raises(TypeError, match="range"):
        _build(JF, JU, build)
    main, startup, feeds, fetches = _build(TF, TU, build)
    exe = TF.Executor(TF.CPUPlace())
    got = exe.run(main, feed=feeds, fetch_list=fetches, scope=TF.Scope())
    want = np.split(feeds["x"], 2, axis=1) + np.split(feeds["x"], [1],
                                                      axis=0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_learning_rate_schedules_over_four_runs():
    """The eight schedules share the one step counter; each run reads the
    next step, in both Executors."""
    _check(_lr_module, runs=4)


def test_rpow_is_not_defined_in_either_package():
    for fluid, unique_name in ((JF, JU), (TF, TU)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), unique_name.guard():
            x = fluid.data("x", [3, 4], "float32")
            with pytest.raises(TypeError):
                2 ** x
            assert hash(x) == id(x)


# -- compat: the reference's answer for each name --------------------------------

def _not_carried(fn):
    """The reason and alternative of an `_na` guard, or None when `fn`
    is a layer."""
    try:
        fn()
    except NotImplementedError as e:
        msg = str(e)
        if "is not carried by this" in msg:
            return msg.split("build: ", 1)[1]
        return None
    except Exception:  # noqa: BLE001 - a real layer called without args
        return None
    return None


# the reference's compat layers the port leaves out, with the queue item
# they wait for
LEFT_OUT = {
    "MultivariateNormalDiag",  # paddle.distribution (queue 1 item 12)
}


def test_compat_names_answer_as_the_reference():
    """Each name of the reference's compat table: where the reference
    raises (its `_na` guards), the port raises NotImplementedError with
    the same reason and alternative; where it has a layer, the port has
    one too, or leaves the name out (LEFT_OUT)."""
    raised = 0
    for name in jcompat.__all__:
        why = _not_carried(getattr(JF.layers, name))
        if name in LEFT_OUT:
            assert why is None and not hasattr(TF.layers, name), name
            continue
        port = getattr(TF.layers, name)
        assert _not_carried(port) == why, name
        raised += why is not None
    assert raised >= 50


@pytest.mark.parametrize("name", ["lstm", "lstm_unit", "gru_unit",
                                  "dynamic_lstmp", "dynamic_gru"])
def test_the_recurrent_compat_names_raise_in_both(name):
    for L in (JF.layers, TF.layers):
        with pytest.raises(NotImplementedError, match="is not carried"):
            getattr(L, name)()
    assert _not_carried(getattr(TF.layers, name)) == \
        _not_carried(getattr(JF.layers, name))


def test_rnn_module_dynamic_gru_computes_in_both():
    assert TF.layers.rnn.dynamic_gru is not TF.layers.dynamic_gru
    assert callable(JF.layers.rnn.dynamic_gru)


# -- paddle.static and the top level ----------------------------------------------

def test_static_and_top_level_names():
    static = T.static
    for name in ("Executor", "Program", "program_guard", "data",
                 "default_main_program", "default_startup_program",
                 "global_scope", "scope_guard", "append_backward",
                 "gradients", "Variable", "name_scope", "cpu_places",
                 "cuda_places", "create_global_var", "create_parameter",
                 "InputSpec", "set_program_state", "nn"):
        assert hasattr(static, name), name
    assert static.Executor is TF.Executor and static.data is \
        TF.layers.data
    assert static.nn.fc is TF.layers.fc
    assert static.nn.crf_decoding is TF.layers.crf_decoding
    for name in ("CompiledProgram", "BuildStrategy", "ExecutionStrategy"):
        assert getattr(static, name) is getattr(TF, name), name
    for name in ("load_inference_model", "save_inference_model"):
        assert not hasattr(static, name), name
    for name in ("Executor", "Program", "program_guard", "data", "CUDAPlace",
                 "CPUPlace", "elementwise_add", "elementwise_pow",
                 "reduce_sum", "reduce_prod", "fill_constant"):
        assert getattr(T, name) is getattr(TF.layers, name, None) \
            or getattr(T, name) is getattr(TF, name), name
    assert T.static.cpu_places(2)[1] == TF.CPUPlace() or \
        isinstance(T.static.cpu_places(2)[1], TF.CPUPlace)


def test_random_nn_layers_build_the_reference_program():
    """nce and training dropout draw (torch's bits, not jax.random's):
    their programs are held by the JSON, their rules by the fluid ops
    tests."""
    def build(fluid):
        L = fluid.layers
        x = fluid.data("x", [4, 3], "float32")
        lab = fluid.data("lab", [4, 1], "int64")
        return {}, [L.nce(x, lab, 7, num_neg_samples=3),
                    L.dropout(x, 0.5, seed=3)]

    jm, js, _, _ = _build(JF, JU, build)
    tm, ts, _, _ = _build(TF, TU, build)
    assert _json(tm) == _json(jm) and _json(ts) == _json(js)
