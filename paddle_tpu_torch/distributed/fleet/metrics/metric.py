"""Fleet distributed metrics (counterpart of paddle_tpu/distributed/fleet/
metrics/metric.py): reduce the local metric state over the workers, then
finish the formula on the reduced values.  Each function takes a numpy
array, a tensor, a Variable, a var name (read from the scope), or a LIST
of per-worker arrays, which it reduces on the host; a single value is
all-reduced over the live process group (itself with no group)."""

from __future__ import annotations

import builtins

import numpy as np
import torch

__all__ = ["sum", "max", "min", "auc", "mae", "rmse", "mse", "acc"]


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _fetch(x, scope):
    if isinstance(x, (list, tuple)):
        return [_fetch(v, scope) for v in x]
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return _host(x)
    if hasattr(x, "name"):
        x = x.name
    if isinstance(x, str):
        if scope is None:
            from ....fluid.executor import global_scope
            scope = global_scope()
        return _host(scope.get(x))
    return np.asarray(x)


def _reduce(x, scope, mode="sum"):
    vals = _fetch(x, scope)
    if isinstance(vals, list):
        stack = np.stack([np.asarray(v, np.float64) for v in vals])
        red = {"sum": np.sum, "max": np.max, "min": np.min}[mode]
        return red(stack, axis=0)
    from ... import comm

    vals = np.asarray(vals, np.float64)
    if comm.live():
        return comm.host_all_reduce(vals, mode, comm.default_group())
    return vals


def sum(input, scope=None):  # noqa: A001 - reference API name
    return _reduce(input, scope, "sum")


def max(input, scope=None):  # noqa: A001
    return _reduce(input, scope, "max")


def min(input, scope=None):  # noqa: A001
    return _reduce(input, scope, "min")


def auc(stat_pos, stat_neg, scope=None):
    """Global ROC-AUC from (allreduced) threshold-bucket stats — the
    same trapezoid walk as the reference (metric.py:140, high threshold
    to low)."""
    pos = _reduce(stat_pos, scope, "sum").reshape(-1)
    neg = _reduce(stat_neg, scope, "sum").reshape(-1)
    area = 0.0
    new_pos = 0.0
    new_neg = 0.0
    total_ins_num = 0.0
    old_pos = 0.0
    old_neg = 0.0
    for i in range(len(pos) - 1, -1, -1):
        new_pos = old_pos + pos[i]
        new_neg = old_neg + neg[i]
        total_ins_num += pos[i] + neg[i]
        area += (new_neg - old_neg) * (old_pos + new_pos) / 2
        old_pos, old_neg = new_pos, new_neg
    if new_pos == 0 or new_neg == 0 or total_ins_num == 0:
        return 0.5
    return float(area / (new_pos * new_neg))


def mae(abserr, total_ins_num, scope=None):
    e = float(np.sum(_reduce(abserr, scope, "sum")))
    n = float(np.sum(_reduce(total_ins_num, scope, "sum")))
    return e / builtins.max(n, 1.0)


def rmse(sqrerr, total_ins_num, scope=None):
    e = float(np.sum(_reduce(sqrerr, scope, "sum")))
    n = float(np.sum(_reduce(total_ins_num, scope, "sum")))
    return float(np.sqrt(e / builtins.max(n, 1.0)))


def mse(sqrerr, total_ins_num, scope=None):
    e = float(np.sum(_reduce(sqrerr, scope, "sum")))
    n = float(np.sum(_reduce(total_ins_num, scope, "sum")))
    return e / builtins.max(n, 1.0)


def acc(correct, total, scope=None):
    c = float(np.sum(_reduce(correct, scope, "sum")))
    t = float(np.sum(_reduce(total, scope, "sum")))
    return c / builtins.max(t, 1.0)
