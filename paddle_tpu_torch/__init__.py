"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for one NVIDIA
H100 (Hopper, sm_90a).

The JAX package `paddle_tpu` stays beside this one as the reference each
part of the port is held against (tests/test_torch_*.py).  This package
imports torch and numpy only: never jax, never paddle_tpu.

Its front ends: BERT served through `serving.Engine` and decoded through
`serving.AutoregressiveEngine` (the hand-written CUDA kernels under
`csrc/`), the Fluid static graph (`fluid`: Program, Executor), and the
2.x eager API below, whose Tensor is `torch.Tensor` and whose tape is
torch autograd:

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.models import LeNet

    model = paddle.Model(LeNet())
    model.prepare(paddle.optimizer.Adam(learning_rate=1e-3,
                                        parameters=model.parameters()),
                  paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
    model.fit(dataset, batch_size=64, epochs=1)

Entry points run on `cuda` unless the caller passes `device="cpu"` (or
calls `set_device("cpu")`); with no GPU and no device given they raise.
"""

import torch

from .device import get_device, set_device  # noqa: F401
from . import amp, fluid, hapi, io, metric, nn, optimizer, tensor  # noqa
from . import vision  # noqa: F401
from . import inference, static  # noqa: F401
from . import dataset, reader, text  # noqa: F401
from .batch import batch  # noqa: F401
from .fluid.dygraph import (disable_dygraph, enable_dygraph, grad,  # noqa
                            no_grad, to_variable)
from .fluid.dygraph.parallel import DataParallel  # noqa: F401
from .fluid.framework import in_dygraph_mode  # noqa: F401
from .fluid.param_attr import ParamAttr  # noqa: F401
from .framework_io import load, save  # noqa: F401
from .hapi import Model, summary  # noqa: F401
from .nn import Layer  # noqa: F401
from .tensor import (to_tensor, zeros, ones, full, zeros_like,  # noqa
                     ones_like, full_like, arange, linspace, eye, rand,
                     randn, randint, randperm, uniform, normal, bernoulli,
                     multinomial, seed, concat, stack, split, squeeze,
                     unsqueeze, reshape, transpose, flatten, cast, matmul,
                     bmm, dot, mv, t, kron, addmm, tril, triu, diag,
                     meshgrid, where, nonzero, unique, flip, roll, tile,
                     expand, expand_as, broadcast_to, gather, gather_nd,
                     scatter, scatter_nd_add, index_select, index_sample,
                     masked_select, argmax, argmin, argsort, sort, topk,
                     add, subtract, multiply, divide, pow, clip, scale,
                     isnan, isinf, isfinite, norm, dist, equal, not_equal,
                     greater_than, greater_equal, less_than, less_equal,
                     logical_and, logical_or, logical_not, logical_xor,
                     equal_all, allclose, cumsum, cumprod, assign, clone,
                     numel, std, var, median, logsumexp, sum, mean, prod,
                     exp, log, sqrt, rsqrt, abs, ceil, floor, round, sin,
                     cos, tan, tanh, reciprocal, square, sign, erf,
                     maximum, minimum, max, min)
# the 2.x top-level tail (reference python/paddle/__init__.py)
from .tensor import (acos, asin, atan, cosh, sinh, log1p, log2,  # noqa
                     log10, mod, remainder, floor_divide, floor_mod, trace,
                     cross, cholesky, histogram, increment, is_empty,
                     empty, empty_like, chunk, stanh, shard_index, unstack,
                     strided_slice, add_n, addcmul, broadcast_shape, einsum,
                     has_inf, has_nan, inverse, is_tensor, mm, multiplex,
                     rank, scatter_nd, tensordot, unbind, set_default_dtype,
                     get_default_dtype, set_printoptions,
                     get_tensor_from_selected_rows, shape, all, any, slice,
                     expm1, mode)

# the static-graph names of the top level (reference
# python/paddle/__init__.py): `shape` stays the 2.x tensor function
from .fluid import (CPUPlace, CUDAPinnedPlace, CUDAPlace, TPUPlace,  # noqa
                    Executor, LoDTensor, LoDTensorArray, Program, Variable,
                    append_backward, cpu_places, cuda_places,
                    default_main_program, default_startup_program,
                    global_scope, is_compiled_with_cuda, program_guard,
                    scope_guard, tpu_places)
from .fluid.dygraph import enable_dygraph as disable_static_mode  # noqa
from .fluid.flags import get_flags, set_flags  # noqa: F401
from .fluid.layers import (create_global_var, create_parameter,  # noqa
                           elementwise_add, elementwise_sub,
                           elementwise_mul, elementwise_div,
                           elementwise_floordiv, elementwise_mod,
                           elementwise_pow, fill_constant, reduce_max,
                           reduce_mean, reduce_min, reduce_prod,
                           reduce_sum)
from .fluid.layers.tensor import data  # noqa: F401

Tensor = torch.Tensor


def enable_static():
    disable_dygraph()


def disable_static(place=None):
    enable_dygraph(place)


def get_cuda_rng_state():
    """The state of each card's torch CUDA generator (the reference, with
    no CUDA generators, returns [])."""
    return torch.cuda.get_rng_state_all() if torch.cuda.is_available() \
        else []


def set_cuda_rng_state(state_list):
    """Restore what get_cuda_rng_state gave, one state a card."""
    if state_list:
        torch.cuda.set_rng_state_all(state_list)
