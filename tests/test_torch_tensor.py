"""The port's 2.x tensor API (paddle_tpu_torch.tensor) against
paddle_tpu.tensor on the CPU: every function the port added, on the same
seeded numpy inputs, over dtypes, broadcasting, `axis` None / int /
negative / list and `keepdim`, with ties and negative integers; and the
gradients of the differentiable ones (the reference's eager tape under
`fluid.dygraph.guard()`, torch autograd in the port) with the same
cotangents.

Tolerances.  F32 (rtol 1e-5, atol 1e-6): one float32 op (or a few),
whose only difference is the order of float32 operations.  Integer and
bool results are compared exactly, by value: the reference runs with
64-bit types off, so its int64 results come back int32 where the port
keeps Paddle's int64.  BF16 (2^-7 relative): one bf16 product under
`amp.auto_cast`.  Random draws differ by design and are held to their
distribution: means within 5 standard errors (a false alarm once in
~10^6).

Where the reference ignores an argument that would change the answer,
the port raises; the tests pin the reference's answer where the
argument makes no difference and check that the port raises where it
would.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as J
from paddle_tpu import tensor as JT
from paddle_tpu.fluid import dygraph as Jdy
from paddle_tpu.nn import functional as JF

import paddle_tpu_torch as T
from paddle_tpu_torch import tensor as TT
from paddle_tpu_torch.nn import functional as TF

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2 ** -7, atol=2 ** -7)


@pytest.fixture(autouse=True)
def _cpu_and_global_rngs():
    """The port on the CPU; numpy's and torch's global generators left
    as each test found them."""
    old = T.device._CURRENT[0]
    T.set_device("cpu")
    np_state, torch_state = np.random.get_state(), torch.get_rng_state()
    yield
    T.device._CURRENT[0] = old
    np.random.set_state(np_state)
    torch.set_rng_state(torch_state)


def _f(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _pos(*shape, seed=0):
    return np.abs(_f(*shape, seed=seed)) + 0.5


def _i(*shape, seed=0, lo=-9, hi=10, dtype=np.int64):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(dtype)


def _spd(n, seed=0):
    a = _f(n, n, seed=seed)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


TIES = np.array([[1., 3., 3., 0., 3., 2.], [5., 5., 1., 5., 0., 5.]],
                np.float32)
NEG = np.array([-7, 7, -7, 7, 5, -5, 0, -1], np.int64)
NEG_DIV = np.array([3, -3, -3, 3, -2, 2, 4, 3], np.int64)


class L(list):
    """A list of arrays passed as one argument (concat, stack, ...)."""


# name -> (function, positional args, keyword args, indices of the args
# whose gradient is compared)
CASES = {}


def case(name, fn, args, kw=None, grad=()):
    assert name not in CASES, name
    CASES[name] = (fn, args, kw or {}, tuple(grad))


# -- math: binary, broadcasting, dtypes -------------------------------------------
for dt in ("float32", "int32", "int64"):
    is_f = dt == "float32"
    x = _f(2, 3, 4) if is_f else _i(2, 3, 4, dtype=dt)
    y = _f(3, 1, seed=1) if is_f else _i(3, 1, seed=1, dtype=dt)
    g = (0, 1) if is_f else ()
    for fn in ("add", "subtract", "multiply", "maximum", "minimum"):
        case(f"{fn}_{dt}_broadcast", fn, [x, y], grad=g)
case("divide_float32", "divide", [_f(2, 3), _pos(3, seed=1)], grad=(0, 1))
case("divide_int64_true_division", "divide", [NEG, NEG_DIV])
for fn in ("mod", "remainder", "floor_mod", "floor_divide"):
    case(f"{fn}_negative_int64", fn, [NEG, NEG_DIV])
    case(f"{fn}_negative_float32", fn, [NEG.astype(np.float32),
                                        NEG_DIV.astype(np.float32)])
case("pow_scalar", "pow", [_pos(3, 4), 2.5], grad=(0,))
case("pow_int_scalar", "pow", [_i(5, lo=1), 3])
case("pow_tensor", "pow", [_pos(3, 4), _f(4, seed=1)], grad=(0, 1))
case("add_python_scalar", "add", [_f(3), 2.5], grad=(0,))

# -- math: unary -------------------------------------------------------------------
for fn in ("exp", "expm1", "abs", "ceil", "floor", "round", "sin", "cos",
           "tan", "atan", "sinh", "cosh", "tanh", "sign", "erf", "square"):
    case(fn, fn, [_f(3, 4)], grad=(0,))
for fn in ("log", "log2", "log10", "log1p", "sqrt", "rsqrt",
           "reciprocal"):
    case(fn, fn, [_pos(3, 4)], grad=(0,))
for fn in ("asin", "acos"):
    case(fn, fn, [np.tanh(_f(3, 4))], grad=(0,))
case("round_half_to_even", "round",
     [np.array([0.5, 1.5, 2.5, -0.5, -1.5], np.float32)])
case("abs_int", "abs", [NEG])
case("sign_int", "sign", [NEG])

# -- math: reductions over axis None / int / negative / list, keepdim ----------------
for fn in ("sum", "mean", "max", "min", "prod", "logsumexp"):
    for axis, keep in ((None, False), (None, True), (1, False), (-1, True),
                       ([0, 2], False), ([0, -1], True)):
        case(f"{fn}_axis{axis}_keep{keep}", fn, [_f(2, 3, 4)],
             dict(axis=axis, keepdim=keep), grad=(0,))
for fn in ("sum", "max", "min", "prod"):
    case(f"{fn}_int64", fn, [_i(3, 4, lo=-3, hi=4)], dict(axis=1))
case("mean_int_gives_float", "mean", [_i(3, 4)], dict(axis=0))
case("sum_bool", "sum", [_f(3, 4) > 0], dict(axis=1))
for fn in ("any", "all"):
    for axis in (None, 0, [0, 1]):
        case(f"{fn}_axis{axis}", fn, [_f(3, 4) > -0.5], dict(axis=axis))
for fn in ("std", "var"):
    for axis, unbiased, keep in ((None, True, False), (1, False, True),
                                 ([0, 2], True, False)):
        case(f"{fn}_axis{axis}_{unbiased}_{keep}", fn, [_f(2, 3, 4)],
             dict(axis=axis, unbiased=unbiased, keepdim=keep), grad=(0,))
for axis, keep in ((None, False), (1, True), (-1, False), ((0, 2), False)):
    case(f"median_axis{axis}_keep{keep}", "median", [_f(2, 3, 4)],
         dict(axis=axis, keepdim=keep))
case("median_even_count", "median", [_f(4, 6)], dict(axis=1))
case("median_int", "median", [_i(3, 5)], dict(axis=1))

# -- math: products and the rest -------------------------------------------------------
case("matmul", "matmul", [_f(2, 3, 4), _f(4, 5, seed=1)], grad=(0, 1))
case("matmul_transpose_y", "matmul", [_f(2, 1, 4), _f(2, 6, 4, seed=1)],
     dict(transpose_y=True), grad=(0, 1))
case("matmul_transpose_x", "matmul", [_f(4, 3), _f(4, 5, seed=1)],
     dict(transpose_x=True), grad=(0, 1))
case("matmul_vector", "matmul", [_f(4), _f(4, 5, seed=1)], grad=(0, 1))
case("mm", "mm", [_f(3, 4), _f(4, 5, seed=1)], grad=(0, 1))
case("bmm", "bmm", [_f(2, 3, 4), _f(2, 4, 5, seed=1)], grad=(0, 1))
case("dot", "dot", [_f(3, 4), _f(3, 4, seed=1)], grad=(0, 1))
case("mv", "mv", [_f(3, 4), _f(4, seed=1)], grad=(0, 1))
case("t", "t", [_f(3, 4)], grad=(0,))
case("kron", "kron", [_f(2, 3), _f(3, 2, seed=1)], grad=(0, 1))
case("addmm", "addmm", [_f(3, 5), _f(3, 4, seed=1), _f(4, 5, seed=2)],
     dict(beta=0.5, alpha=-2.0), grad=(0, 1, 2))
case("trace", "trace", [_f(3, 4, 2)], dict(offset=-1, axis1=0, axis2=1),
     grad=(0,))
case("cumsum_axis", "cumsum", [_f(3, 4)], dict(axis=-1), grad=(0,))
case("cumsum_flat", "cumsum", [_f(3, 4)], grad=(0,))
case("cumsum_int", "cumsum", [_i(3, 4)], dict(axis=0))
case("cumprod", "cumprod", [_f(3, 4)], dict(dim=1), grad=(0,))
case("cumprod_default_dim", "cumprod", [_f(3, 4)], grad=(0,))
case("cross", "cross", [_f(4, 3), _f(4, 3, seed=1)], grad=(0, 1))
case("cross_axis0", "cross", [_f(3, 2), _f(3, 2, seed=1)], dict(axis=0))
case("multiply_no_nan", "multiply_no_nan",
     [_f(3, 4), np.where(_f(3, 4, seed=1) > 0, _f(3, 4, seed=2), 0)
      .astype(np.float32)], grad=(0, 1))
case("scale", "scale", [_f(3, 4)], dict(scale=2.0, bias=0.5), grad=(0,))
case("scale_bias_first", "scale", [_f(3, 4)],
     dict(scale=-3.0, bias=0.25, bias_after_scale=False), grad=(0,))
case("increment", "increment", [_f(1)], dict(value=2.0), grad=(0,))
case("clip", "clip", [_f(3, 4)], dict(min=-0.5, max=0.7), grad=(0,))
case("clip_min_only", "clip", [_f(3, 4)], dict(min=0.1), grad=(0,))
case("stanh", "stanh", [_f(3, 4)], dict(scale_a=0.5, scale_b=2.0),
     grad=(0,))
special = _f(3, 4)
special.flat[1], special.flat[3], special.flat[4] = np.inf, -np.inf, np.nan
for fn in ("isnan", "isinf", "isfinite", "has_inf", "has_nan"):
    case(fn, fn, [special])
case("has_nan_none", "has_nan", [_f(3)])
for p, axis, keep in ((2, None, False), (1, None, False), (2, 1, True),
                      ("fro", (0, 1), False), (np.inf, -1, False),
                      (3, 0, False)):
    case(f"norm_{p}_{axis}_{keep}", "norm", [_f(3, 4)],
         dict(p=p, axis=axis, keepdim=keep), grad=(0,))
case("norm_vector", "norm", [_f(5)], dict(p=2), grad=(0,))
for p in (2, 1, 0, np.inf, -np.inf, 3):
    case(f"dist_{p}", "dist", [_f(2, 3), _f(3, seed=1)], dict(p=p))
case("logsumexp_list", "logsumexp", [_f(2, 3, 4)], dict(axis=[0, 1]))
case("addcmul", "addcmul", [_f(3, 4), _f(3, 4, seed=1), _f(4, seed=2)],
     dict(value=0.5), grad=(0, 1, 2))
case("add_n", "add_n", [L([_f(3, 4), _f(3, 4, seed=1), _f(3, 4, seed=2)])])
case("einsum", "einsum", ["ij,jk->ik", _f(3, 4), _f(4, 5, seed=1)],
     grad=(1, 2))
case("einsum_trace", "einsum", ["ii", _f(4, 4)])
case("inverse", "inverse", [_spd(4)], grad=(0,))
case("tensordot_int", "tensordot", [_f(2, 3, 4), _f(3, 4, 5, seed=1)],
     dict(axes=2), grad=(0, 1))
case("tensordot_lists", "tensordot", [_f(2, 3, 4), _f(4, 2, 5, seed=1)],
     dict(axes=[[0, 2], [1, 0]]), grad=(0, 1))
case("cholesky", "cholesky", [_spd(4)], grad=(0,))
case("cholesky_upper", "cholesky", [_spd(3, seed=1)], dict(upper=True),
     grad=(0,))
case("histogram", "histogram", [_f(4, 5)], dict(bins=6))
case("histogram_range", "histogram", [_f(4, 5)], dict(bins=4, min=-1,
                                                      max=1))
case("histogram_equal_data", "histogram", [np.full((5,), 2.0,
                                                   np.float32)],
     dict(bins=3))

# -- logic -----------------------------------------------------------------------------
for fn in ("equal", "not_equal", "greater_than", "greater_equal",
           "less_than", "less_equal"):
    case(f"{fn}_float_broadcast", fn, [_i(3, 4, lo=0, hi=3).astype(
        np.float32), _i(4, seed=1, lo=0, hi=3).astype(np.float32)])
    case(f"{fn}_int", fn, [_i(3, 4, lo=0, hi=3), _i(3, 4, seed=1, lo=0,
                                                    hi=3)])
for fn in ("logical_and", "logical_or", "logical_xor"):
    case(fn, fn, [_f(3, 4) > 0, _f(4, seed=1) > 0])
    case(f"{fn}_numbers", fn, [_i(3, 4, lo=0, hi=2), _i(3, 4, seed=1,
                                                        lo=0, hi=2)])
case("logical_not", "logical_not", [_f(3, 4) > 0])
case("equal_all_true", "equal_all", [_i(3, 4), _i(3, 4)])
case("equal_all_false", "equal_all", [_i(3, 4), _i(3, 4, seed=1)])
case("equal_all_shapes", "equal_all", [_i(3, 4), _i(4, 3)])
case("allclose", "allclose", [_f(3, 4), _f(3, 4) + 1e-7])
case("allclose_false", "allclose", [_f(3, 4), _f(3, 4) + 1e-3],
     dict(rtol=1e-6, atol=1e-6))
case("is_empty", "is_empty", [np.zeros((2, 0), np.float32)])
case("is_empty_false", "is_empty", [_f(2)])

# -- manipulation --------------------------------------------------------------------------
case("reshape", "reshape", [_f(2, 3, 4)], dict(shape=[0, -1, 2]),
     grad=(0,))
case("transpose", "transpose", [_f(2, 3, 4)], dict(perm=[2, 0, 1]),
     grad=(0,))
case("concat", "concat", [L([_f(2, 3), _f(2, 1, seed=1)])], dict(axis=1))
case("concat_negative_axis", "concat", [L([_f(2, 3), _f(4, 3, seed=1)])],
     dict(axis=-2))
case("stack", "stack", [L([_f(2, 3), _f(2, 3, seed=1)])], dict(axis=-1))
case("unstack", "unstack", [_f(3, 2, 4)], dict(axis=1))
case("unbind", "unbind", [_f(3, 2, 4)], dict(axis=-1))
case("split_num", "split", [_f(2, 6)], dict(num_or_sections=3, axis=1))
case("split_sections", "split", [_f(6, 2)],
     dict(num_or_sections=[2, -1, 1]))
case("chunk", "chunk", [_f(4, 6)], dict(chunks=2, axis=0))
case("squeeze_all", "squeeze", [_f(1, 3, 1)], grad=(0,))
case("squeeze_axes", "squeeze", [_f(2, 1, 3, 1)], dict(axis=[1, -1]))
case("squeeze_not_one", "squeeze", [_f(2, 3)], dict(axis=0))
case("unsqueeze", "unsqueeze", [_f(2, 3)], dict(axis=[0, -1]), grad=(0,))
case("unsqueeze_int", "unsqueeze", [_f(2, 3)], dict(axis=1))
case("flatten", "flatten", [_f(2, 3, 4, 5)], dict(start_axis=1,
                                                  stop_axis=-2))
case("flatten_all", "flatten", [_f(2, 3, 4)], grad=(0,))
case("gather", "gather", [_f(5, 3), np.array([4, 0, 2, 0], np.int64)],
     grad=(0,))
case("gather_axis1", "gather", [_f(2, 5, 3), np.array([3, 1], np.int64)],
     dict(axis=1), grad=(0,))
case("gather_nd", "gather_nd", [_f(3, 4, 5), np.array(
    [[2, 1], [0, 3]], np.int64)], grad=(0,))
case("scatter", "scatter", [_f(5, 3), np.array([3, 0], np.int64),
                            _f(2, 3, seed=1)], grad=(0, 2))
case("scatter_accumulate", "scatter",
     [_f(5, 3), np.array([3, 0, 3], np.int64), _f(3, 3, seed=1)],
     dict(overwrite=False), grad=(0, 2))
case("scatter_nd_add", "scatter_nd_add",
     [_f(3, 4), np.array([[1, 2], [0, 0], [1, 2]], np.int64),
      _f(3, seed=1)], grad=(0, 2))
case("scatter_nd", "scatter_nd", [np.array([[1], [3], [1]], np.int64),
                                  _f(3, 2)], dict(shape=[5, 2]))
case("index_select", "index_select", [_f(3, 5), np.array(
    [4, 1, 1], np.int64)], dict(axis=1), grad=(0,))
case("index_sample", "index_sample", [_f(3, 5), np.array(
    [[4, 0], [1, 1], [2, 3]], np.int64)], grad=(0,))
case("masked_select", "masked_select", [_f(3, 4), _f(3, 4, seed=1) > 0])
case("where", "where", [_f(3, 4) > 0, _f(3, 4, seed=1), _f(4, seed=2)],
     grad=(1, 2))
case("nonzero", "nonzero", [_i(3, 4, lo=0, hi=2)])
case("nonzero_tuple", "nonzero", [_i(3, 4, lo=0, hi=2)],
     dict(as_tuple=True))
case("unique_static", "unique", [np.array([[3, 1, 3], [2, 1, 3]],
                                          np.int64)])
case("unique_counts", "unique", [np.array([3, 1, 3, 2, 1, 3], np.int64)],
     dict(return_counts=True))
case("unique_every_output", "unique", [np.array([0.5, -1., 0.5, 2.],
                                                np.float32)],
     dict(return_index=True, return_inverse=True, return_counts=True))
case("unique_rows", "unique", [np.array([[1, 2], [0, 5], [1, 2]],
                                        np.int64)],
     dict(return_counts=True, axis=0))
case("flip", "flip", [_f(2, 3, 4)], dict(axis=[0, -1]), grad=(0,))
case("flip_int", "flip", [_f(2, 3)], dict(axis=1))
case("roll", "roll", [_f(3, 4)], dict(shifts=[1, -2], axis=[0, 1]),
     grad=(0,))
case("roll_flat", "roll", [_f(3, 4)], dict(shifts=5))
case("tile", "tile", [_f(2, 3)], dict(repeat_times=[2, 1, 3]), grad=(0,))
case("expand", "expand", [_f(3, 1)], dict(shape=[2, -1, 4]), grad=(0,))
case("broadcast_to", "broadcast_to", [_f(1, 4)], dict(shape=[3, 4]))
case("expand_as", "expand_as", [_f(1, 4), _f(3, 4, seed=1)], grad=(0,))
case("cast_int32", "cast", [_f(3, 4) * 4], dict(dtype="int32"))
case("cast_bool", "cast", [_f(3, 4)], dict(dtype="bool"))
case("cast_float16", "cast", [_f(3, 4)], dict(dtype="float16"), grad=(0,))
case("slice", "slice", [_f(4, 3, 5)], dict(axes=[0, 2], starts=[-3, 1],
                                           ends=[100, -1]), grad=(0,))
case("strided_slice", "strided_slice", [_f(6, 5)],
     dict(axes=[0, 1], starts=[1, 4], ends=[6, 0], strides=[2, -1]),
     grad=(0,))
case("shard_index", "shard_index", [np.array([[1], [6], [12], [19]],
                                             np.int64)],
     dict(index_num=20, nshards=2, shard_id=1))
case("multiplex", "multiplex", [L([_f(4, 3), _f(4, 3, seed=1)]),
                                np.array([[1], [0], [1], [1]], np.int64)])
case("tril", "tril", [_f(4, 5)], dict(diagonal=-1), grad=(0,))
case("triu", "triu", [_f(2, 4, 5)], dict(diagonal=1), grad=(0,))
case("diag_vector", "diag", [_f(3)], dict(offset=1, padding_value=0.5),
     grad=(0,))
case("diag_matrix", "diag", [_f(4, 5)], dict(offset=-1), grad=(0,))
case("meshgrid", "meshgrid", [_f(3), _f(4, seed=1)])
case("meshgrid_list", "meshgrid", [L([_f(2), _f(3, seed=1), _f(4,
                                                              seed=2)])])
case("assign", "assign", [_f(3, 4)], grad=(0,))
case("assign_numpy", "assign", [_i(3)])
case("clone", "clone", [_f(3, 4)], grad=(0,))
case("numel", "numel", [_f(3, 4)])
case("rank", "rank", [_f(3, 4, 2)])
case("shape", "shape", [_f(3, 4, 2)])
case("empty_like", "empty_like", [_f(3, 4)])

# -- search: ties keep lax.top_k's and jnp.argsort's order ------------------------------------
case("argmax_flat", "argmax", [TIES])
case("argmax_axis_keepdim_ties", "argmax", [TIES], dict(axis=1,
                                                        keepdim=True))
case("argmax_int32", "argmax", [TIES], dict(axis=0, dtype="int32"))
case("argmin_axis_ties", "argmin", [-TIES], dict(axis=-1))
case("argmin_vector", "argmin", [TIES[1]])
case("argsort_ties", "argsort", [TIES])
case("argsort_ties_descending", "argsort", [TIES], dict(descending=True))
case("argsort_axis0_int", "argsort", [_i(5, 3, lo=0, hi=3)], dict(axis=0))
case("sort_ties_descending", "sort", [TIES], dict(descending=True),
     grad=(0,))
case("sort_axis0", "sort", [_f(4, 3)], dict(axis=0), grad=(0,))
case("topk_ties", "topk", [TIES], dict(k=3), grad=(0,))
case("topk_smallest_axis0", "topk", [TIES.T.copy()],
     dict(k=2, axis=0, largest=False), grad=(0,))
case("mode_vector", "mode", [np.array([3, 1, 3, 2, 1, 3, 1], np.int64)])
case("mode_vector_ties", "mode", [np.array([2., 1., 2., 1.], np.float32)])


def _ref_args(args, grad):
    out = []
    for i, a in enumerate(args):
        if isinstance(a, L):
            out.append([J.to_tensor(v) for v in a])
        elif isinstance(a, np.ndarray):
            out.append(J.to_tensor(a, stop_gradient=i not in grad))
        else:
            out.append(a)
    return out


def _port_args(args, grad):
    out = []
    for i, a in enumerate(args):
        if isinstance(a, L):
            out.append([torch.from_numpy(v) for v in a])
        elif isinstance(a, np.ndarray):
            t = torch.from_numpy(a.copy())
            out.append(t.requires_grad_(True) if i in grad else t)
        else:
            out.append(a)
    return out


def _flat(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _cotangents(outs, seed=7):
    rng = np.random.RandomState(seed)
    return [np.asarray(rng.randn(*o.shape), np.float32) for o in outs]


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.dtype in (torch.float16, torch.bfloat16)
                else t).numpy(), t.dtype
    a = np.asarray(t.numpy())
    return a, a.dtype


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_the_reference(name):
    fn, args, kw, grad = CASES[name]
    with Jdy.guard():
        jargs = _ref_args(args, grad)
        jouts = _flat(getattr(JT, fn)(*jargs, **kw))
        want = [np.asarray(o.numpy()) for o in jouts]
        jgrads = {}
        if grad:
            floats = [o for o, w in zip(jouts, want)
                      if np.issubdtype(w.dtype, np.floating)]
            cts = _cotangents(floats)
            loss = JT.add_n([JT.sum(JT.multiply(
                JT.cast(o, "float32"), J.to_tensor(c)))
                for o, c in zip(floats, cts)])
            loss.backward()
            jgrads = {i: jargs[i].grad for i in grad}
    targs = _port_args(args, grad)
    touts = _flat(getattr(TT, fn)(*targs, **kw))
    assert len(touts) == len(want)
    for k, (t, w) in enumerate(zip(touts, want)):
        g, gdt = _np(t)
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            assert gdt == {np.dtype("float32"): torch.float32,
                           np.dtype("float16"): torch.float16}.get(
                               w.dtype, gdt), (k, gdt, w.dtype)
            np.testing.assert_allclose(g, w, err_msg=str(k), **F32)
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(k))
    if grad:
        floats = [t for t, w in zip(touts, want)
                  if np.issubdtype(w.dtype, np.floating)]
        loss = sum((t.float() * torch.from_numpy(c)).sum()
                   for t, c in zip(floats, _cotangents(floats)))
        loss.backward()
        for i in grad:
            np.testing.assert_allclose(targs[i].grad.numpy(),
                                       np.asarray(jgrads[i].numpy()),
                                       err_msg=f"grad {i}", **F32)


def test_every_new_function_is_covered():
    """Each function of paddle_tpu.tensor the port added has a case
    above (creation and the draws are held elsewhere)."""
    held_elsewhere = {
        "to_tensor", "zeros", "ones", "full", "zeros_like", "ones_like",
        "full_like", "arange", "linspace", "eye", "rand", "randn",
        "randint", "randperm", "uniform", "normal", "seed", "bernoulli",
        "multinomial", "empty", "set_default_dtype", "get_default_dtype",
        "set_printoptions", "get_tensor_from_selected_rows", "is_tensor",
        "broadcast_shape", "pow_", "Tensor", "core", "np", "trace_fn",
        "trace_op"}
    public = {n for n in dir(JT) if not n.startswith("_")
              and callable(getattr(JT, n))}
    covered = {c[0] for c in CASES.values()}
    assert public - held_elsewhere - covered == set()
    assert public - {"Tensor", "core", "np", "trace_fn", "trace_op"} \
        <= set(dir(TT))


# -- arguments the reference ignores: the port raises where they matter -----------------------

def _ref(fn, *args, **kw):
    with Jdy.guard():
        return np.asarray(fn(*[J.to_tensor(a) if isinstance(a, np.ndarray)
                               else a for a in args], **kw).numpy())


def test_mode_raises_along_an_axis_and_pins_the_whole_tensor_answer():
    x = np.array([[1, 2, 2], [3, 3, 3]], np.int64)
    # the reference's answer is the whole tensor's mode whatever axis says
    assert _ref(JT.mode, x, axis=1).tolist() == 3
    assert _ref(JT.mode, x, axis=0, keepdim=True).tolist() == 3
    with pytest.raises(NotImplementedError, match="axis"):
        TT.mode(torch.from_numpy(x), axis=1)
    with pytest.raises(NotImplementedError, match="keepdim"):
        TT.mode(torch.from_numpy(x[0]), keepdim=True)


def test_cumsum_and_cumprod_raise_on_a_cast():
    x = _f(3, 4)
    want = _ref(JT.cumsum, x, axis=1, dtype="float64")
    assert want.dtype == np.float32  # the reference ignored dtype
    np.testing.assert_allclose(TT.cumsum(torch.from_numpy(x), axis=1,
                                         dtype="float32").numpy(), want,
                               **F32)
    for fn, kw in ((TT.cumsum, dict(axis=1)), (TT.cumprod, dict(dim=1))):
        with pytest.raises(NotImplementedError, match="dtype"):
            fn(torch.from_numpy(x), dtype="float64", **kw)


def test_scale_raises_on_act():
    x = _f(3, 4)
    np.testing.assert_array_equal(_ref(JT.scale, x, 2.0, act="relu"),
                                  _ref(JT.scale, x, 2.0))
    with pytest.raises(NotImplementedError, match="act"):
        TT.scale(torch.from_numpy(x), 2.0, act="relu")


def test_argmin_without_axis_raises_beyond_one_axis():
    x = _f(3, 4)
    # the reference reduced the last axis, not the flattened tensor
    np.testing.assert_array_equal(_ref(JT.argmin, x), x.argmin(-1))
    with pytest.raises(NotImplementedError, match="flatten"):
        TT.argmin(torch.from_numpy(x))


def test_unique_along_an_axis_raises_beyond_one_axis():
    x = np.array([[3, 1], [3, 2]], np.int64)
    np.testing.assert_array_equal(_ref(JT.unique, x, axis=0),
                                  _ref(JT.unique, x))
    with pytest.raises(NotImplementedError, match="axis"):
        TT.unique(torch.from_numpy(x), axis=0)


def test_unstack_raises_on_a_wrong_num():
    x = _f(3, 2)
    with Jdy.guard():
        assert len(JT.unstack(J.to_tensor(x), axis=0, num=5)) == 3
    with pytest.raises(NotImplementedError, match="num"):
        TT.unstack(torch.from_numpy(x), axis=0, num=5)
    assert len(TT.unstack(torch.from_numpy(x), axis=0, num=3)) == 3


def test_frobenius_norm_over_every_axis_raises():
    x = _f(3, 4)
    # the reference reduced no axis: |x|
    np.testing.assert_allclose(_ref(JT.norm, x), np.abs(x), **F32)
    with pytest.raises(NotImplementedError, match="reduce_all"):
        TT.norm(torch.from_numpy(x))


# -- the rest: defaults, devices, amp, draws ---------------------------------------------------

def test_median_and_norm_over_a_list_of_axes():
    """The reference's median and norm take a tuple of axes (held above)
    and raise on a list; the port takes both, as numpy does a tuple."""
    x = _f(2, 3, 4)
    with pytest.raises((TypeError, ValueError)):
        _ref(JT.median, x, axis=[0, 2])
    with pytest.raises((TypeError, ValueError)):
        _ref(JT.norm, x, p="fro", axis=[0, 2])
    np.testing.assert_allclose(
        TT.median(torch.from_numpy(x), axis=[0, 2]).numpy(),
        np.median(x, axis=(0, 2)), **F32)
    np.testing.assert_allclose(
        TT.norm(torch.from_numpy(x), p="fro", axis=[0, 2]).numpy(),
        np.linalg.norm(x, axis=(0, 2)), **F32)


def test_default_dtype_moves_float_creation():
    assert TT.get_default_dtype() == "float32"
    try:
        TT.set_default_dtype("float64")
        assert TT.zeros([2]).dtype == torch.float64
        assert TT.to_tensor([1.5]).dtype == torch.float64
        assert TT.to_tensor(np.ones(2, np.float32)).dtype == torch.float32
        assert TT.to_tensor([1]).dtype == torch.int64
    finally:
        TT.set_default_dtype("float32")
    assert TT.ones([2]).dtype == torch.float32
    with pytest.raises(TypeError):
        TT.set_default_dtype("int32")


def test_python_numbers_land_on_the_operand_device_and_dtype():
    x = torch.arange(4, dtype=torch.int64)
    assert TT.add(x, 2).dtype == torch.int64
    assert TT.multiply(x, 0.5).dtype == torch.float32
    np.testing.assert_array_equal(TT.mod(x - 2, 3).numpy(),
                                  np.mod(np.arange(4) - 2, 3))


def test_amp_casts_by_the_op_type_lists():
    """Under auto_cast O1 the white-list op (matmul_v2) computes in bf16
    and the others keep float32, in both packages."""
    x, y = _f(4, 8), _f(8, 3, seed=1)
    with Jdy.guard(), J.amp.auto_cast():
        jm = JT.matmul(J.to_tensor(x), J.to_tensor(y))
        ja = JT.add(J.to_tensor(x), J.to_tensor(x))
        want = np.asarray(jm.numpy()).astype(np.float32)
        want_dt = str(jm.numpy().dtype)
    with T.amp.auto_cast():
        tm = TT.matmul(torch.from_numpy(x), torch.from_numpy(y))
        ta = TT.add(torch.from_numpy(x), torch.from_numpy(x))
    assert want_dt == "bfloat16" and tm.dtype == torch.bfloat16
    assert ta.dtype == torch.float32 and str(ja.numpy().dtype) == "float32"
    np.testing.assert_allclose(tm.float().numpy(), want, **BF16)


def test_sequence_mask():
    lengths = np.array([3, 0, 5, 1], np.int64)
    with Jdy.guard():
        want = np.asarray(JF.sequence_mask(J.to_tensor(lengths)).numpy())
        want6 = np.asarray(JF.sequence_mask(J.to_tensor(lengths), maxlen=6,
                                            dtype="float32").numpy())
    got = TF.sequence_mask(torch.from_numpy(lengths))
    got6 = TF.sequence_mask(torch.from_numpy(lengths), maxlen=6,
                            dtype="float32")
    assert got.dtype == torch.int64 and got6.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got6.numpy(), want6)


def test_bernoulli_and_multinomial_draw_their_distribution():
    torch.manual_seed(0)
    n = 40000
    p = torch.full((n,), 0.3)
    b = TT.bernoulli(p)
    assert b.dtype == torch.float32 and set(b.unique().tolist()) <= {0, 1}
    assert abs(float(b.mean()) - 0.3) < 5 * (0.3 * 0.7 / n) ** 0.5
    w = torch.tensor([[1.0, 3.0, 0.0, 4.0]])
    m = TT.multinomial(w, n, replacement=True)
    assert m.shape == (1, n) and m.dtype == torch.int64
    freq = np.bincount(m[0].numpy(), minlength=4) / n
    for f, q in zip(freq, [0.125, 0.375, 0.0, 0.5]):
        assert abs(f - q) <= 5 * (q * (1 - q) / n) ** 0.5
    m2 = TT.multinomial(torch.tensor([[1.0, 1.0, 1.0]]), 3)
    assert sorted(m2[0].tolist()) == [0, 1, 2]  # no replacement


def test_the_rest_of_the_tail():
    assert TT.is_tensor(torch.zeros(1)) and not TT.is_tensor(np.zeros(1))
    assert TT.broadcast_shape([2, 1, 3], [4, 1]) == \
        JT.broadcast_shape([2, 1, 3], [4, 1]) == [2, 4, 3]
    x = torch.zeros(2)
    assert TT.get_tensor_from_selected_rows(x) is x
    with pytest.raises(TypeError):
        TT.get_tensor_from_selected_rows(np.zeros(2))
    assert TT.empty([2, 3]).shape == (2, 3)
    out = torch.zeros(3)
    assert TT.assign(np.array([1., 2., 3.], np.float32), out) is out
    np.testing.assert_array_equal(out.numpy(), [1, 2, 3])
    src = torch.ones(2, requires_grad=True)
    cp = TT.clone(src)
    assert cp is not src and cp.requires_grad
    TT.set_printoptions(precision=3)
    TT.set_printoptions(precision=4)


def test_top_level_exports_match_the_reference():
    names = ["concat", "matmul", "unsqueeze", "sum", "cast", "max", "min",
             "all", "any", "slice", "mode", "expm1", "unique", "topk",
             "add_n", "einsum", "shape", "floor_mod", "scatter_nd"]
    for n in names:
        assert getattr(T, n) is getattr(TT, n), n
    assert {n for n in dir(J) if callable(getattr(J, n, None))
            and getattr(J, n, None) is getattr(JT, n, object())} - \
        {"pow_"} <= set(dir(T))
