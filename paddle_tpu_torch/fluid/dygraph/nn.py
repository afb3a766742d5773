"""fluid.dygraph 1.x layer classes (counterpart of
paddle_tpu/fluid/dygraph/nn.py): subclasses of the port's 2.x layers with
the 1.x constructor signatures (channel-first argument names, `act=`
epilogues), and the five 1.x LR decay classes with their 1.x
signatures.  Imported on first use (`fluid.dygraph.__getattr__`), after
`nn` is loaded, so the import cannot cycle."""

from __future__ import annotations

import numpy as np

from ... import nn as _nn
from ...nn.layer.extra_layers import Pool2D  # noqa: F401 (1.x name)


def _act(out, act):
    if not act:
        return out
    from ...nn import functional as F

    return getattr(F, act)(out)


class Linear(_nn.Linear):
    """1.x Linear(input_dim, output_dim, act=None)."""

    def __init__(self, input_dim, output_dim, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__(input_dim, output_dim,
                         weight_attr=param_attr, bias_attr=bias_attr)
        self._act1x = act

    def forward(self, x):
        return _act(super().forward(x), self._act1x)


class Conv2D(_nn.Conv2D):
    """1.x Conv2D(num_channels, num_filters, filter_size, ...)."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, use_cudnn=True, act=None,
                 dtype="float32"):
        super().__init__(num_channels, num_filters, filter_size,
                         stride=stride, padding=padding,
                         dilation=dilation, groups=groups,
                         weight_attr=param_attr, bias_attr=bias_attr)
        self._act1x = act

    def forward(self, x):
        return _act(super().forward(x), self._act1x)


class Conv2DTranspose(_nn.Conv2DTranspose):
    def __init__(self, num_channels, num_filters, filter_size,
                 output_size=None, padding=0, stride=1, dilation=1,
                 groups=1, param_attr=None, bias_attr=None,
                 use_cudnn=True, act=None, dtype="float32"):
        super().__init__(num_channels, num_filters, filter_size,
                         stride=stride, padding=padding,
                         dilation=dilation, groups=groups,
                         weight_attr=param_attr, bias_attr=bias_attr)
        self._act1x = act
        self._output_size1x = output_size

    def forward(self, x):
        out = super().forward(x, output_size=self._output_size1x)
        return _act(out, self._act1x)


class Conv3D(_nn.Conv3D):
    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, use_cudnn=True, act=None,
                 dtype="float32"):
        super().__init__(num_channels, num_filters, filter_size,
                         stride=stride, padding=padding,
                         dilation=dilation, groups=groups,
                         weight_attr=param_attr, bias_attr=bias_attr)
        self._act1x = act

    def forward(self, x):
        return _act(super().forward(x), self._act1x)


class Conv3DTranspose(_nn.Conv3DTranspose):
    def __init__(self, num_channels, num_filters, filter_size,
                 padding=0, stride=1, dilation=1, groups=1,
                 param_attr=None, bias_attr=None, use_cudnn=True,
                 act=None, dtype="float32"):
        super().__init__(num_channels, num_filters, filter_size,
                         stride=stride, padding=padding,
                         dilation=dilation, groups=groups,
                         weight_attr=param_attr, bias_attr=bias_attr)
        self._act1x = act

    def forward(self, x):
        return _act(super().forward(x), self._act1x)


class BatchNorm(_nn.BatchNorm):
    """1.x BatchNorm(num_channels, act=...)."""

    def __init__(self, num_channels, act=None, is_test=False,
                 momentum=0.9, epsilon=1e-5, param_attr=None,
                 bias_attr=None, dtype="float32", data_layout="NCHW",
                 in_place=False, moving_mean_name=None,
                 moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False):
        super().__init__(num_channels, momentum=momentum,
                         epsilon=epsilon, weight_attr=param_attr,
                         bias_attr=bias_attr, data_format=data_layout,
                         use_global_stats=use_global_stats or None)
        self._act1x = act
        if is_test:
            self.eval()

    def forward(self, x):
        return _act(super().forward(x), self._act1x)


class Embedding(_nn.Embedding):
    def __init__(self, size, is_sparse=False, is_distributed=False,
                 padding_idx=None, param_attr=None, dtype="float32"):
        super().__init__(size[0], size[1], padding_idx=padding_idx,
                         sparse=is_sparse, weight_attr=param_attr)


class Dropout(_nn.Dropout):
    def __init__(self, p=0.5, seed=None,
                 dropout_implementation="downgrade_in_infer",
                 is_test=False):
        # 1.x's "downgrade_in_infer" is 2.x's "downscale_in_infer"
        super().__init__(p, mode="upscale_in_train"
                         if dropout_implementation == "upscale_in_train"
                         else "downscale_in_infer")
        if is_test:
            self.eval()


class Flatten(_nn.Flatten):
    """Same (start_axis, stop_axis) signature as the reference's 1.x
    class and the 2.0 layer."""


class PRelu(_nn.PReLU):
    def __init__(self, mode="all", channel=None, input_shape=None,
                 param_attr=None, dtype="float32"):
        if mode == "all":
            num = 1
        elif mode == "channel":
            num = channel
        else:
            num = int(np.prod(input_shape[1:]))
        super().__init__(num_parameters=num, weight_attr=param_attr)


class BilinearTensorProduct(_nn.BilinearTensorProduct):
    def __init__(self, input1_dim, input2_dim, output_dim, name=None,
                 act=None, param_attr=None, bias_attr=None,
                 dtype="float32"):
        super().__init__(input1_dim, input2_dim, output_dim,
                         weight_attr=param_attr, bias_attr=bias_attr)
        self._act1x = act

    def forward(self, x, y):
        return _act(super().forward(x, y), self._act1x)


class GRUUnit(_nn.Layer):
    """1.x GRUUnit eager layer over the gru_unit lowering (reference
    dygraph/nn.py GRUUnit:3060)."""

    def __init__(self, size, param_attr=None, bias_attr=None,
                 activation="tanh", gate_activation="sigmoid",
                 origin_mode=False, dtype="float32"):
        super().__init__()
        d = size // 3
        self.weight = self.create_parameter([d, d * 3], attr=param_attr)
        self.bias = self.create_parameter([1, d * 3], attr=bias_attr,
                                          is_bias=True)
        self._cfg = (activation, gate_activation, origin_mode)

    def forward(self, input, hidden):
        from ...nn import functional as F

        a, ga, om = self._cfg
        return F.gru_unit(input, hidden, self.weight, bias=self.bias,
                          activation=a, gate_activation=ga,
                          origin_mode=om)


class NCE(_nn.Layer):
    """1.x NCE eager layer over the nce lowering.  Only uniform
    negative sampling is carried — anything else fails loudly (a
    silently different sampling distribution would change the loss)."""

    def __init__(self, num_total_classes, dim, sample_weight=None,
                 param_attr=None, bias_attr=None, num_neg_samples=None,
                 sampler="uniform", custom_dist=None, seed=0,
                 is_sparse=False, dtype="float32"):
        super().__init__()
        if sampler != "uniform" or custom_dist is not None \
                or sample_weight is not None:
            raise NotImplementedError(
                "NCE supports only uniform negative sampling on this "
                "build (sampler='uniform', no custom_dist/"
                "sample_weight); other distributions would silently "
                "change the loss")
        self.weight = self.create_parameter([num_total_classes, dim],
                                            attr=param_attr)
        self.bias = self.create_parameter([num_total_classes, 1],
                                          attr=bias_attr, is_bias=True)
        self._cfg = (num_total_classes, num_neg_samples, seed)

    def forward(self, input, label, sample_weights=None):
        from ...nn import functional as F

        n, k, seed = self._cfg
        return F.nce(input, label, n, num_neg_samples=k, seed=seed,
                     weight=self.weight, bias=self.bias)


def TreeConv(*args, **kwargs):
    raise NotImplementedError(
        "fluid.dygraph.TreeConv (tree-based convolution over AST "
        "structures, tree_conv_op.cc) is not carried by this build — "
        "its gather patterns are expressible with paddle.gather + "
        "nn.Conv1D over flattened node sequences.")


# -- 1.x LR decay classes (reference dygraph/learning_rate_scheduler.py:
# NOT the 2.0 signatures — e.g. NaturalExpDecay takes (lr, decay_steps,
# decay_rate, staircase), CosineDecay (lr, step_each_epoch, epochs)) --

from ...optimizer.lr import LRScheduler as _LRS  # noqa: E402


class NaturalExpDecay(_LRS):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1, dtype="float32"):
        self._ds, self._dr, self._stair = decay_steps, decay_rate, \
            staircase
        super().__init__(learning_rate)

    def get_lr(self):
        t = self.last_epoch / self._ds
        if self._stair:
            t = np.floor(t)
        return self.base_lr * float(np.exp(-self._dr * t))


class ExponentialDecay(_LRS):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1, dtype="float32"):
        self._ds, self._dr, self._stair = decay_steps, decay_rate, \
            staircase
        super().__init__(learning_rate)

    def get_lr(self):
        t = self.last_epoch / self._ds
        if self._stair:
            t = np.floor(t)
        return self.base_lr * float(self._dr ** t)


class InverseTimeDecay(_LRS):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1, dtype="float32"):
        self._ds, self._dr, self._stair = decay_steps, decay_rate, \
            staircase
        super().__init__(learning_rate)

    def get_lr(self):
        t = self.last_epoch / self._ds
        if self._stair:
            t = np.floor(t)
        return self.base_lr / (1 + self._dr * t)


class CosineDecay(_LRS):
    def __init__(self, learning_rate, step_each_epoch, epochs, begin=0,
                 step=1, dtype="float32"):
        self._spe, self._epochs = step_each_epoch, epochs
        super().__init__(learning_rate)

    def get_lr(self):
        epoch = np.floor(self.last_epoch / self._spe)
        return 0.5 * self.base_lr * float(
            np.cos(epoch * np.pi / self._epochs) + 1)


class PiecewiseDecay(_LRS):
    """1.x signature (boundaries, values, begin)."""

    def __init__(self, boundaries, values, begin=0, step=1,
                 dtype="float32"):
        self._bounds = list(boundaries)
        self._values = list(values)
        super().__init__(float(values[0]))
        self.step(begin)

    def get_lr(self):
        for b, v in zip(self._bounds, self._values):
            if self.last_epoch < b:
                return v
        return self._values[len(self._bounds)]
