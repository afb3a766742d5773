"""Fused transformer FFN, forward and backward (counterpart of
paddle_tpu/ops/pallas/ffn.py).

    out = dropout(act(x @ w1 + b1), p) @ w2 + b2

`ffn_forward` is the wrapper of the hand-written CUDA kernel
`csrc/ffn_fwd.cu` (which replaces the Pallas `_fwd_kernel`), and
`ffn_backward` the wrapper of the two kernels of `csrc/ffn_bwd.cu`
(which replace `_bwd_dw_kernel` and `_bwd_dx_kernel`): on a CUDA tensor
each launches its kernels or raises; on a CPU tensor it runs the plain
PyTorch version (`ffn_forward_reference`, `ffn_backward_reference`),
which computes the same function.  `FusedFFNFunction` ties the two
together for autograd.  The (tokens, d_ff) hidden activation never
reaches device memory: the backward recomputes it per tile from x.
Dropout uses `_ffn_keep`, the TPU kernel's stateless hash of (seed,
token, d_ff column), bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from .attention import _M32, _finalize, _mul32, _threshold
from .build import LaunchCounter, check, library

FFN_FWD = LaunchCounter("ffn_fwd")
FFN_BWD_DW = LaunchCounter("ffn_bwd_dw")
FFN_BWD_DX = LaunchCounter("ffn_bwd_dx")

_ACT_IDS = {"gelu": 0, "gelu_tanh": 1, "relu": 2}
_KERNEL_HIDDEN = (128, 256, 512, 768, 1024)
# the backward kernels hold x and g tiles side by side in shared memory,
# which leaves no room at d_model 1024
_KERNEL_HIDDEN_BWD = (128, 256, 512, 768)
_BLOCK_F = 64  # the kernels' d_ff step
_DW_BLOCK_T, _DW_BLOCK_F = 32, 16  # the dW kernel's token tile and slice


def _erf(x: torch.Tensor) -> torch.Tensor:
    """erf via Abramowitz-Stegun 7.1.26 (max abs err 1.5e-7) — the
    formula of paddle_tpu's `_erf`, which both of its FFN arms use."""
    a1, a2, a3 = 0.254829592, -0.284496736, 1.421413741
    a4, a5, p = -1.453152027, 1.061405429, 0.3275911
    s = torch.sign(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + p * ax)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    return s * (1.0 - poly * torch.exp(-ax * ax))


def _act(h: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "gelu":
        return h * 0.5 * (1.0 + _erf(h * 0.7071067811865476))
    if activation == "gelu_tanh":
        c = 0.7978845608028654  # sqrt(2/pi)
        return h * (0.5 * (1.0 + torch.tanh(c * (h + 0.044715 * h ** 3))))
    if activation == "relu":
        return torch.relu(h)
    raise NotImplementedError(activation)


def _act_grad(pre: torch.Tensor, activation: str) -> torch.Tensor:
    """d act(pre) / d pre in f32 (paddle_tpu's `_act_grad`)."""
    if activation == "relu":
        return (pre > 0).to(pre.dtype)
    if activation == "gelu":
        cdf = 0.5 * (1.0 + _erf(pre * 0.7071067811865476))
        pdf = 0.3989422804014327 * torch.exp(-0.5 * pre * pre)
        return cdf + pre * pdf
    if activation == "gelu_tanh":
        c = 0.7978845608028654  # sqrt(2/pi)
        t = torch.tanh(c * (pre + 0.044715 * pre ** 3))
        return 0.5 * (1 + t) + 0.5 * pre * (1 - t ** 2) * c * (
            1 + 3 * 0.044715 * pre ** 2)
    raise NotImplementedError(activation)


def _ffn_keep(seed, t0, f0, block_t, block_f, dropout_p,
              device=None) -> torch.Tensor:
    """(block_t, block_f) keep mask for the tile at absolute (t0, f0) —
    paddle_tpu's `_ffn_keep`, bit for bit."""
    r = (t0 + torch.arange(block_t, dtype=torch.int64,
                           device=device)).view(-1, 1)
    c = (f0 + torch.arange(block_f, dtype=torch.int64,
                           device=device)).view(1, -1)
    x = _mul32(r, 0x9E3779B1) ^ _mul32(c, 0x85EBCA77)
    x = x ^ ((int(seed) & _M32) * 0x165667B1 & _M32)
    return _finalize(x) >= _threshold(dropout_p)


def ffn_forward_reference(x, w1, b1, w2, b2, activation="gelu",
                          dropout_p=0.0, seed=0):
    """Plain PyTorch version of the FFN forward kernel.  x (T, H) ->
    (T, H) in x's dtype.  Both products accumulate in f32; the hidden
    tile is activated in f32 and cast to x's dtype before the second
    product, as in the kernel."""
    pre = x.float() @ w1.float() + b1.float()
    h = _act(pre, activation)
    if dropout_p > 0.0:
        keep = _ffn_keep(seed, 0, 0, x.shape[0], w1.shape[1], dropout_p,
                         device=x.device)
        h = torch.where(keep, h / (1.0 - dropout_p), torch.zeros_like(h))
    out = h.to(x.dtype).float() @ w2.float() + b2.float()
    return out.to(x.dtype)


def _lib():
    lib = library("ffn_fwd")
    fn = lib.ffn_fwd_bf16
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci,
                       ctypes.c_uint, ctypes.c_float, ctypes.c_uint, vp]
        fn.restype = ci
    return lib


def _ffn_forward_cuda(x, w1, b1, w2, b2, activation, dropout_p, seed):
    t, h = x.shape
    f = w1.shape[1]
    ts = (x, w1, b1, w2, b2)
    if any(a.dtype != torch.bfloat16 for a in ts):
        raise NotImplementedError(
            "ffn_fwd kernel takes bf16 x/w1/b1/w2/b2, got "
            + "/".join(str(a.dtype) for a in ts))
    if activation not in _ACT_IDS:
        raise NotImplementedError(activation)
    if h not in _KERNEL_HIDDEN or f % _BLOCK_F:
        raise NotImplementedError(
            f"ffn_fwd kernel takes d_model in {_KERNEL_HIDDEN} and d_ff a "
            f"multiple of {_BLOCK_F}, got {h} and {f}")
    if (w1.shape != (h, f) or b1.shape != (f,) or w2.shape != (f, h)
            or b2.shape != (h,)):
        raise ValueError("ffn weight shapes do not match x")
    x, w1, b1, w2, b2 = (a.contiguous() for a in ts)
    out = torch.empty_like(x)
    thresh = _threshold(dropout_p) if dropout_p > 0.0 else 0
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ffn_fwd_bf16(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), t, h, f, _ACT_IDS[activation],
        thresh, float(1.0 - dropout_p), int(seed) & _M32, stream)
    check(lib, err, "ffn_fwd")
    FFN_FWD.add()
    return out


def ffn_forward(x, w1, b1, w2, b2, activation="gelu", dropout_p=0.0,
                seed=0):
    """x (T, H) -> (T, H): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (and nothing else for either)."""
    if x.is_cuda:
        return _ffn_forward_cuda(x, w1, b1, w2, b2, activation,
                                 float(dropout_p), seed)
    return ffn_forward_reference(x, w1, b1, w2, b2, activation,
                                 float(dropout_p), seed)


# -- backward -------------------------------------------------------------------

def ffn_backward_reference(x, w1, b1, w2, b2, seed, g, activation="gelu",
                           dropout_p=0.0):
    """Plain PyTorch version of the two FFN backward kernels (paddle_tpu's
    `_ffn_backward`): the hidden tile is recomputed from x, never saved.
    Returns (dx, dw1, db1, dw2, db2) in the dtypes of x, w1, b1, w2, b2;
    products accumulate in f32, and h and dpre are cast to the operand
    dtype before the products that take them, as in the kernels."""
    pre = x.float() @ w1.float() + b1.float()
    h = _act(pre, activation)
    dh = g.float() @ w2.float().t()
    if dropout_p > 0.0:
        keep = _ffn_keep(seed, 0, 0, x.shape[0], w1.shape[1], dropout_p,
                         device=x.device)
        h = torch.where(keep, h / (1.0 - dropout_p), torch.zeros_like(h))
        dh = torch.where(keep, dh / (1.0 - dropout_p), torch.zeros_like(dh))
    dpre = dh * _act_grad(pre, activation)
    dpre_c = dpre.to(x.dtype).float()
    dw2 = h.to(g.dtype).float().t() @ g.float()
    dw1 = x.float().t() @ dpre_c
    dx = dpre_c @ w1.float().t()
    return (dx.to(x.dtype), dw1.to(w1.dtype), dpre.sum(0).to(b1.dtype),
            dw2.to(w2.dtype), g.float().sum(0).to(b2.dtype))


def _bwd_lib():
    lib = library("ffn_bwd")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    tail = [ctypes.c_uint, ctypes.c_float, ctypes.c_uint, vp]
    if lib.ffn_bwd_dw_bf16.argtypes is None:
        lib.ffn_bwd_dw_bf16.argtypes = [vp] * 9 + [ci] * 5 + tail
        lib.ffn_bwd_dw_bf16.restype = ci
    if lib.ffn_bwd_dx_bf16.argtypes is None:
        lib.ffn_bwd_dx_bf16.argtypes = [vp] * 6 + [ci] * 4 + tail
        lib.ffn_bwd_dx_bf16.restype = ci
    return lib


def _dw_splits(t: int, f: int, device) -> int:
    """Token splits of the dW kernel: enough CTAs for two per SM, each
    split summing its own f32 partials (reduced in a fixed order)."""
    n_f = f // _DW_BLOCK_F
    n_t = -(-t // _DW_BLOCK_T)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(n_t, -(-2 * sms // n_f)))


def _ffn_bwd_launchers(x, w1, b1, w2, b2, seed, g, activation, dropout_p):
    """Check the operands and allocate the outputs; return
    ((dx, dw1, db1, dw2, db2), launch_dw, launch_dx), each launcher
    running its kernel once (the dW launcher: the dW pass and its reduce
    over token splits).  db2 = sum g is a torch reduction, outside the
    kernels as in JAX (:325)."""
    t, h = x.shape
    f = w1.shape[1]
    ts = (x, w1, b1, w2, b2, g)
    if any(a.dtype != torch.bfloat16 for a in ts):
        raise NotImplementedError(
            "ffn_bwd kernels take bf16 x/w1/b1/w2/b2/g, got "
            + "/".join(str(a.dtype) for a in ts))
    if activation not in _ACT_IDS:
        raise NotImplementedError(activation)
    if h not in _KERNEL_HIDDEN_BWD or f % _BLOCK_F:
        raise NotImplementedError(
            f"ffn_bwd kernels take d_model in {_KERNEL_HIDDEN_BWD} and d_ff "
            f"a multiple of {_BLOCK_F}, got {h} and {f}")
    if (w1.shape != (h, f) or b1.shape != (f,) or w2.shape != (f, h)
            or b2.shape != (h,) or g.shape != x.shape):
        raise ValueError("ffn backward operand shapes do not match x")
    x, w1, b1, w2, g = (a.contiguous() for a in (x, w1, b1, w2, g))
    n_split = _dw_splits(t, f, x.device)
    dx = torch.empty_like(x)
    dw1, db1, dw2 = (torch.empty_like(a) for a in (w1, b1, w2))
    ws = torch.empty((n_split, 2 * h * f + f), dtype=torch.float32,
                     device=x.device)
    db2 = g.float().sum(0).to(b2.dtype)
    thresh = _threshold(dropout_p) if dropout_p > 0.0 else 0
    rng = (thresh, float(1.0 / (1.0 - dropout_p)), int(seed) & _M32,
           torch.cuda.current_stream(x.device).cuda_stream)
    ins = (x.data_ptr(), g.data_ptr(), w1.data_ptr(), b1.data_ptr(),
           w2.data_ptr())
    lib = _bwd_lib()
    keep = (x, w1, b1, w2, g, ws)  # alive while the launchers are

    def launch_dw():
        err = lib.ffn_bwd_dw_bf16(*ins, dw1.data_ptr(), db1.data_ptr(),
                                  dw2.data_ptr(), ws.data_ptr(), t, h, f,
                                  _ACT_IDS[activation], n_split, *rng)
        check(lib, err, "ffn_bwd_dw")
        FFN_BWD_DW.add()
        return keep

    def launch_dx():
        err = lib.ffn_bwd_dx_bf16(*ins, dx.data_ptr(), t, h, f,
                                  _ACT_IDS[activation], *rng)
        check(lib, err, "ffn_bwd_dx")
        FFN_BWD_DX.add()
        return keep

    return (dx, dw1, db1, dw2, db2), launch_dw, launch_dx


def _ffn_backward_cuda(*args):
    grads, launch_dw, launch_dx = _ffn_bwd_launchers(*args)
    launch_dw()
    launch_dx()
    return grads


def ffn_backward(x, w1, b1, w2, b2, seed, g, activation="gelu",
                 dropout_p=0.0):
    """(dx, dw1, db1, dw2, db2) of ffn_forward: the CUDA kernels for CUDA
    tensors, the plain version for CPU tensors (and nothing else for
    either)."""
    if x.is_cuda:
        return _ffn_backward_cuda(x, w1, b1, w2, b2, seed, g, activation,
                                  float(dropout_p))
    return ffn_backward_reference(x, w1, b1, w2, b2, seed, g, activation,
                                  float(dropout_p))


class FusedFFNFunction(torch.autograd.Function):
    """The fused FFN with the kernels' own backward (the custom_vjp of
    paddle_tpu's `_fused_ffn`): saves only x, the weights and the host
    seed; the hidden activation is recomputed, never kept."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, activation, dropout_p, seed):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.args = (seed, activation, dropout_p)
        return ffn_forward(x, w1, b1, w2, b2, activation, dropout_p, seed)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, b2 = ctx.saved_tensors
        seed, activation, dropout_p = ctx.args
        grads = ffn_backward(x, w1, b1, w2, b2, seed, g, activation,
                             dropout_p)
        return (*grads, None, None, None)


def fused_ffn(x, w1, b1, w2, b2, activation="gelu", dropout_p=0.0,
              dropout_seed=None):
    """dropout(act(x @ w1 + b1), p) @ w2 + b2 over any leading dims,
    differentiable in x and the four weights.  x: (..., H); w1 (H, F);
    w2 (F, H).  Returns (..., H)."""
    lead = x.shape[:-1]
    seed = 0 if dropout_seed is None else int(dropout_seed)
    out = FusedFFNFunction.apply(x.reshape(-1, x.shape[-1]), w1, b1, w2, b2,
                                 activation, float(dropout_p), seed)
    return out.reshape(*lead, x.shape[-1])
