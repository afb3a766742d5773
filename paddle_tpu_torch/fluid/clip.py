"""Gradient clipping (a copy of paddle_tpu/fluid/clip.py): each
`ClipGradBy*` is a callable over (param, grad) pairs that appends the clip
ops to the program; the optimizer applies its `grad_clip`, or else the
program-wide one of `set_gradient_clip`, before regularization."""

from __future__ import annotations

from .layer_helper import LayerHelper


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        from .layers import nn

        out = []
        for p, g in params_grads:
            if g is None:
                continue
            out.append((p, nn.clip(g, self.min, self.max)))
        return out


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        from .layers import nn

        out = []
        for p, g in params_grads:
            if g is None:
                continue
            out.append((p, nn.clip_by_norm(g, self.clip_norm)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """g_i <- g_i clip_norm / max(global_norm, clip_norm), with
    global_norm = sqrt(sum_i ||g_i||^2)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        from .layers import nn, tensor

        helper = LayerHelper("global_norm_clip")
        sq_sums = []
        for p, g in params_grads:
            if g is None:
                continue
            sq = helper.create_variable_for_type_inference(dtype=g.dtype)
            helper.append_op("squared_l2_norm", inputs={"X": [g]},
                             outputs={"Out": [sq]}, attrs={"op_role": 1})
            sq_sums.append(sq)
        total = helper.create_variable_for_type_inference(dtype="float32")
        helper.append_op("sum", inputs={"X": sq_sums},
                         outputs={"Out": [total]}, attrs={"op_role": 1})
        global_norm = nn.sqrt(total)
        clip_var = tensor.fill_constant([1], "float32", self.clip_norm)
        scale = clip_var / nn.elementwise_max(global_norm, clip_var)
        out = []
        for p, g in params_grads:
            if g is None:
                continue
            out.append((p, nn.elementwise_mul(g, scale)))
        return out


# the 1.x names
GradientClipByValue = ClipGradByValue
GradientClipByNorm = ClipGradByNorm
GradientClipByGlobalNorm = ClipGradByGlobalNorm


class ErrorClipByValue:
    """Paddle's clip of the error flowing into an intermediate var.  Not
    applied, as in the reference (clip.py:86-112): constructing one warns,
    and a ClipGradBy* on the optimizer is the working alternative."""

    def __init__(self, max, min=None):
        import warnings

        warnings.warn(
            "ErrorClipByValue is not applied on this build (the "
            "backward has no per-var gradient hook); use "
            "ClipGradByValue/ClipGradByNorm on the optimizer instead.",
            RuntimeWarning, stacklevel=2)
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def _clip(self, grad_np):
        import numpy as np

        return np.clip(grad_np, self.min, self.max)


_GLOBAL_GRAD_CLIP = [None]


def set_gradient_clip(clip, param_list=None, program=None):
    """The program-wide gradient clip that minimize() applies when the
    optimizer has no grad_clip of its own."""
    if clip is not None and not isinstance(clip, ClipGradBase):
        raise TypeError(
            "set_gradient_clip expects a ClipGradBy* instance or None")
    _GLOBAL_GRAD_CLIP[0] = clip


def _global_gradient_clip():
    return _GLOBAL_GRAD_CLIP[0]
