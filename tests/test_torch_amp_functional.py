"""Every public function of paddle_tpu_torch.nn.functional under
`amp.auto_cast` at O1 and at O2 against paddle_tpu.nn.functional on the
CPU: the same seeded float32 inputs, the result's dtype and its values.

The reference casts by op type inside `trace_op` (O1: the white list;
O2: every op but the black list), and not inside `trace_fn`; a
functional that chains several ops casts at each.  The port casts at the
same points, by the same op types (`amp.cast_inputs`).

Tolerances.  F32 (rtol 1e-5, atol 1e-6): a few float32 ops whose only
difference is the order of operations.  BF16 (rtol and atol 2^-6): up to
four bfloat16 roundings (2^-8 each) of the same chain, in other orders.
Integer results are compared by value, and an int64 result matches the
reference's int32 (it runs with 64-bit types off).
"""

import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as J
from paddle_tpu.fluid import dygraph as Jdy
from paddle_tpu.nn import functional as JF

import paddle_tpu_torch as T
from paddle_tpu_torch.nn import functional as TF

from test_torch_nn_remainder import FUNCTIONAL as REMAINDER
from test_torch_nn_remainder import HELD_BELOW

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2 ** -6, atol=2 ** -6)


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


_IMG = _f(2, 3, 6, 6)
_LOGITS = _f(4, 5)

# name -> [(args, kwargs), ...]: numpy arrays become each package's tensors
CASES = {
    "adaptive_avg_pool2d": [((_IMG, 2), {})],
    "adaptive_max_pool2d": [((_IMG, 2), {})],
    "avg_pool2d": [((_IMG, 2), {"stride": 2})],
    "max_pool2d": [((_IMG, 3), {"stride": 2, "padding": 1})],
    "batch_norm": [((_IMG, _f(3, seed=1), np.abs(_f(3, seed=2)) + 0.5,
                     _f(3, seed=3), _f(3, seed=4)), {"training": False})],
    "binary_cross_entropy": [
        ((_probs(4, 3), _probs(4, 3, seed=1)), {}),
        ((_probs(4, 3), _probs(4, 3, seed=1)),
         {"weight": _probs(4, 3, seed=2), "reduction": "sum"})],
    "binary_cross_entropy_with_logits": [
        ((_f(4, 3), _probs(4, 3, seed=1)), {}),
        ((_f(4, 3), _probs(4, 3, seed=1)),
         {"weight": _probs(4, 3, seed=2), "pos_weight": _f(3, seed=3) + 2,
          "reduction": "none"})],
    "conv2d": [((_IMG, _f(4, 3, 3, 3, seed=1), _f(4, seed=2)),
                {"padding": 1})],
    "cross_entropy": [((_LOGITS, _ids((4, 1), 5)), {})],
    "dropout": [((_f(4, 8),), {"p": 0.5, "training": False}),
                ((_f(4, 8),), {"p": 0.0, "training": True})],
    "embedding": [((_ids((2, 3), 10), _f(10, 4)), {})],
    "fused_feedforward": [((_f(2, 3, 8), _f(8, 16, seed=1), _f(16, seed=2),
                            _f(16, 8, seed=3), _f(8, seed=4)),
                           {"act_dropout": 0.0})],
    "gelu": [((_f(4, 8),), {}), ((_f(4, 8),), {"approximate": True})],
    "kl_div": [((np.log(_probs(4, 3)), _probs(4, 3, seed=1)), {}),
               ((np.log(_probs(4, 3)), _probs(4, 3, seed=1)),
                {"reduction": "batchmean"})],
    "l1_loss": [((_f(4, 3), _f(4, 3, seed=1)), {})],
    "layer_norm": [((_f(2, 3, 4), 4, _f(4, seed=1), _f(4, seed=2)), {})],
    "linear": [((_f(3, 4), _f(4, 5, seed=1), _f(5, seed=2)), {})],
    "log_softmax": [((_f(4, 8),), {})],
    "margin_ranking_loss": [((_f(4,), _f(4, seed=1),
                              np.sign(_f(4, seed=2))), {"margin": 0.1})],
    "mse_loss": [((_f(4, 8), _f(4, 8, seed=1)), {}),
                 ((_f(4, 8), _f(4, 8, seed=1)), {"reduction": "sum"})],
    "nll_loss": [((np.log(_probs(4, 5)), _ids((4,), 5)), {})],
    "relu": [((_f(4, 8),), {})],
    "relu6": [((_f(4, 8, scale=4),), {})],
    "scaled_dot_product_attention": [((_f(2, 4, 2, 8), _f(2, 4, 2, 8, seed=1),
                                       _f(2, 4, 2, 8, seed=2)), {})],
    "sequence_mask": [((np.array([3, 0, 5], np.int64),), {"maxlen": 6})],
    "smooth_l1_loss": [((_f(4, 3), _f(4, 3, seed=1)), {})],
    "softmax": [((_f(4, 8),), {})],
    "softmax_with_cross_entropy": [((_LOGITS, _ids((4, 1), 5)), {})],
    "tanh": [((_f(4, 8),), {})],
}

# the functions of the 2.x remainder, with the inputs of their value
# tests (tests/test_torch_nn_remainder.py)
for _name, _forms in REMAINDER.items():
    CASES.setdefault(_name, [])
    CASES[_name] += [(a, k) for a, k, _ in _forms]

# public functions held elsewhere, with the reason: the reference's
# guards raise in both; the rest draw, drive cells, or raise in both
HELD_ELSEWHERE = dict(HELD_BELOW, **{
    n: "the reference's guard: raises NotImplementedError in both"
    for n in ("hash", "filter_by_instag", "similarity_focus",
              "roi_perspective_transform", "deformable_roi_pooling",
              "multi_box_head", "merge_selected_rows",
              "reorder_lod_tensor_by_rank", "lod_append", "dynamic_lstmp",
              "autoincreased_step_counter")})

# public functions of the port's functional that are no op of the
# reference's: nothing to hold them against
NOT_IN_THE_REFERENCE = {
    "batch_norm_train": "the port's training batch norm helper (the "
                        "reference computes it inside its batch_norm op)",
    "rng_scope": "a context manager for the dropout generators, not an op",
}


def _public():
    return {n for n, f in vars(TF).items()
            if not n.startswith("_") and inspect.isfunction(f)
            and f.__module__ in (TF.__name__, TF.__name__ + ".extra")}


def test_every_public_function_has_a_case():
    assert _public() == set(CASES) | set(NOT_IN_THE_REFERENCE) | \
        set(HELD_ELSEWHERE)
    assert not set(NOT_IN_THE_REFERENCE) & set(dir(JF))


def _outs(v):
    """A result as a list: a dict (every slot of a multi-output op, as
    the reference's trace_op returns it) in slot order."""
    if isinstance(v, dict):
        return [t for k in sorted(v) for t in v[k]]
    return list(v) if isinstance(v, (tuple, list)) else [v]


def _reference(name, args, kwargs, level):
    conv = lambda a: J.to_tensor(a) if isinstance(a, np.ndarray) else a
    with Jdy.guard(), J.amp.auto_cast(level=level):
        out = getattr(JF, name)(*map(conv, args),
                                **{k: conv(v) for k, v in kwargs.items()})
    return [np.asarray(o.numpy()) for o in _outs(out)]


def _port(name, args, kwargs, level):
    conv = lambda a: (torch.from_numpy(a.copy()) if isinstance(a, np.ndarray)
                      else a)
    with T.amp.auto_cast(level=level):
        out = getattr(TF, name)(*map(conv, args),
                                **{k: conv(v) for k, v in kwargs.items()})
    return _outs(out)


def _dtype_name(d):
    name = str(d).replace("torch.", "")
    return {"int64": "int32"}.get(name, name)


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_functional_dtype_and_value_under_amp(name, level):
    for args, kwargs in CASES[name]:
        want = _reference(name, args, kwargs, level)
        got = _port(name, args, kwargs, level)
        assert len(got) == len(want)
        for w, g in zip(want, got):
            assert _dtype_name(g.dtype) == _dtype_name(w.dtype), \
                (kwargs, g.dtype, w.dtype)
            assert tuple(g.shape) == w.shape
            if g.is_floating_point():
                tol = BF16 if g.dtype == torch.bfloat16 else F32
                np.testing.assert_allclose(g.detach().float().numpy(),
                                           w.astype(np.float32), **tol)
            else:
                np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("name", [
    "gelu", "dropout", "mse_loss", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "kl_div"])
def test_the_six_functionals_compute_in_bfloat16_under_o2(name):
    """The six that skipped the cast: their first form under O2 gives
    bfloat16 in the port, as in the reference."""
    args, kwargs = CASES[name][0]
    assert _port(name, args, kwargs, "O2")[0].dtype == torch.bfloat16
    assert str(_reference(name, args, kwargs, "O2")[0].dtype) == "bfloat16"
