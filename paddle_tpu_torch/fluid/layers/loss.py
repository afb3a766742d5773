"""Loss layers (counterpart of paddle_tpu/fluid/layers/loss.py:
cross_entropy, softmax_with_cross_entropy, square_error_cost, mse_loss)."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["cross_entropy", "softmax_with_cross_entropy",
           "square_error_cost", "mse_loss"]


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
