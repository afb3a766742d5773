"""Fused transformer FFN forward (counterpart of paddle_tpu/ops/pallas/ffn.py,
forward part).

    out = dropout(act(x @ w1 + b1), p) @ w2 + b2

`ffn_forward` is the wrapper of the hand-written CUDA kernel
`csrc/ffn_fwd.cu` (which replaces the Pallas `_fwd_kernel`): on a CUDA
tensor it launches the kernel or raises; on a CPU tensor it runs the
plain PyTorch version `ffn_forward_reference`, which computes the same
function.  The (tokens, d_ff) hidden activation of the kernel never
reaches device memory.  Dropout uses `_ffn_keep`, the TPU kernel's
stateless hash of (seed, token, d_ff column), bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from .attention import _M32, _finalize, _mul32, _threshold
from .build import LaunchCounter, check, library

FFN_FWD = LaunchCounter("ffn_fwd")

_ACT_IDS = {"gelu": 0, "gelu_tanh": 1, "relu": 2}
_KERNEL_HIDDEN = (128, 256, 512, 768, 1024)
_BLOCK_F = 64  # the kernel's d_ff step


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


def fused_ffn(x, w1, b1, w2, b2, activation="gelu", dropout_p=0.0,
              dropout_seed=None):
    """dropout(act(x @ w1 + b1), p) @ w2 + b2 over any leading dims.
    x: (..., H); w1 (H, F); w2 (F, H).  Returns (..., H)."""
    lead = x.shape[:-1]
    seed = 0 if dropout_seed is None else int(dropout_seed)
    out = ffn_forward(x.reshape(-1, x.shape[-1]), w1, b1, w2, b2,
                      activation, dropout_p, seed)
    return out.reshape(*lead, x.shape[-1])
