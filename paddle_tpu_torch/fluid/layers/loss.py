"""Loss layers (counterpart of paddle_tpu/fluid/layers/loss.py)."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "square_error_cost",
    "sigmoid_cross_entropy_with_logits", "log_loss", "huber_loss",
    "smooth_l1", "kldiv_loss", "mse_loss",
]


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("cross_entropy",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax = helper.create_variable_for_type_inference(dtype=logits.dtype)
    loss = helper.create_variable_for_type_inference(dtype=logits.dtype)
    helper.append_op("softmax_with_cross_entropy",
                     inputs={"Logits": [logits], "Label": [label]},
                     outputs={"Softmax": [softmax], "Loss": [loss]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index, "axis": axis,
                            "numeric_stable_mode": numeric_stable_mode})
    if return_softmax:
        return loss, softmax
    return loss


def square_error_cost(input, label):
    """(input - label)^2, composed from elementwise ops."""
    from .nn import elementwise_sub, square

    return square(elementwise_sub(input, label))


def mse_loss(input, label):
    from .nn import reduce_mean

    return reduce_mean(square_error_cost(input, label))


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      name=None, normalize=False):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x], "Label": [label]},
                     outputs={"Out": [out]},
                     attrs={"ignore_index": ignore_index,
                            "normalize": normalize})
    return out


def log_loss(input, label, epsilon=1e-4, name=None):
    from .nn import elementwise_add  # composed form

    helper = LayerHelper("log_loss", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("bce_loss", inputs={"X": [input], "Label": [label]},
                     outputs={"Out": [out]})
    return out


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    residual = helper.create_variable_for_type_inference(
        dtype=input.dtype, stop_gradient=True)
    helper.append_op("huber_loss", inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out], "Residual": [residual]},
                     attrs={"delta": float(delta)})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    diff = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                     stop_gradient=True)
    helper.append_op("smooth_l1_loss", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out], "Diff": [diff]},
                     attrs={"sigma": float(sigma or 1.0)})
    return out


def kldiv_loss(x, target, reduction="mean", name=None):
    helper = LayerHelper("kldiv_loss", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("kldiv_loss", inputs={"X": [x], "Target": [target]},
                     outputs={"Loss": [out]},
                     attrs={"reduction": reduction})
    return out
