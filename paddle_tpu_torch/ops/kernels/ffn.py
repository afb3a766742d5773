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
reaches device memory: the backward recomputes it from x (the dx pass
writes its gradient dpre once, then multiplies it by W1^T).
Dropout uses `_ffn_keep`, the TPU kernel's stateless hash of (seed,
token, d_ff column), bit for bit.  `_fwd_plan`, `_dw_plan` and `_dx_plan`
are plain functions of the shapes (and the card's SM count): how the
forward, dW and dx kernels cut their work into CTAs, how many f32
workspace splits the first two sum in a fixed order, and the bf16 dpre
workspace that the dx pass writes once and reads back.

`fused_ffn` dispatches as paddle_tpu's does (ffn.py:372-516): the
kernels are opt-in.  By default it runs the library arm,
`FFNLibraryFunction` (two cuBLAS products around `ffn_act_fwd`, the
element pass of `csrc/ffn_act.cu`, and the products of the gradient
around `ffn_act_bwd`), as the reference runs XLA dots by default.
`enable_fused_ffn()` or `PADDLE_TPU_FUSED_FFN=1` (read at import, the
reference's variable) opens the kernel arm for the shapes and dtypes the
kernels take (`_ffn_arm`).  On CPU tensors each arm runs its plain
version.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ... import profiler
from .attention import (_M32, _finalize, _mul32, _threshold,
                        register_grads)
from .build import LaunchCounter, check, library, sm_count as _sm_count

FFN_FWD = LaunchCounter("ffn_fwd")
FFN_BWD_DW = LaunchCounter("ffn_bwd_dw")
FFN_BWD_DX = LaunchCounter("ffn_bwd_dx")
FFN_ACT_FWD = LaunchCounter("ffn_act_fwd")
FFN_ACT_BWD = LaunchCounter("ffn_act_bwd")

# None: the kernel arm is open; else why it is closed (paddle_tpu's
# `_FFN_DISABLED`, with its default and its variable)
_FFN_DISABLED = (
    None if os.environ.get("PADDLE_TPU_FUSED_FFN") == "1"
    else "opt-in (paddle_tpu's default: the library arm)")

_ACT_IDS = {"gelu": 0, "gelu_tanh": 1, "relu": 2}
_KERNEL_HIDDEN = (128, 256, 512, 768, 1024)
_BLOCK_F = 64  # the kernels' d_ff step
_FWD_BLOCK_T, _FWD_BLOCK_F = 64, 128  # the forward kernel's tile and step
_FWD_WS_CAP = 32 << 20  # bytes of f32 partials the forward's splits may take
_DW_BLOCK_T, _DW_BLOCK_F = 32, 16  # the dW kernel's token tile and slice
_DW_WS_CAP = 64 << 20  # bytes of f32 partials the dW kernel's splits may take
_DX_BLOCK_T, _DX_BLOCK_F, _DX_BLOCK_N = 128, 128, 128  # the dx kernels' tiles


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
                          dropout_p=0.0, seed=0, col_offset=0):
    """Plain PyTorch version of the FFN forward kernel.  x (T, H) ->
    (T, H) in x's dtype.  Both products accumulate in f32; the hidden
    tile is activated in f32 and cast to x's dtype before the second
    product, as in the kernel.  The dropout hash takes d_ff column c as
    column `col_offset + c` (a tensor-parallel rank's columns)."""
    pre = x.float() @ w1.float() + b1.float()
    h = _act(pre, activation)
    if dropout_p > 0.0:
        keep = _ffn_keep(seed, 0, col_offset, x.shape[0], w1.shape[1],
                         dropout_p, device=x.device)
        h = torch.where(keep, h / (1.0 - dropout_p), torch.zeros_like(h))
    out = h.to(x.dtype).float() @ w2.float() + b2.float()
    return out.to(x.dtype)


def _lib():
    lib = library("ffn_fwd")
    fn = lib.ffn_fwd_bf16
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 7 + [ci] * 5 + [
            ctypes.c_uint, ctypes.c_float, ctypes.c_uint, ci, vp]
        fn.restype = ci
    return lib


def _split_ranges(n: int, n_split: int):
    """The units [begin, end) of each split, as the kernels cut n units
    (128-column d_ff steps for the forward, 32-token tiles for dW):
    ceil(n / n_split) a split, the last one shorter."""
    per = max(1, -(-n // n_split))
    return [(b, min(n, b + per)) for b in range(0, n, per)]


def _fwd_groups(h: int) -> int:
    """Output-column groups of the forward kernel's grid: a CTA owns the
    largest multiple of 128 columns that divides h and is at most 384
    (csrc/ffn_fwd.cu::ncol_of), so its accumulator fits the registers."""
    return h // (384 if h % 384 == 0 else 256 if h % 256 == 0 else 128)


def _fwd_plan(t: int, h: int, f: int, sms: int):
    """(block_t, n_split) of the forward kernel.  Its grid is (token tiles
    of block_t, d_ff splits, output-column groups: `_fwd_groups(h)`).
    The d_ff splits, in steps of 128 columns (the last step of an odd
    number of 64-column units is 64 wide), bring the grid as close to one
    wave of `sms` CTAs as d_ff allows, with the f32 partials of the splits
    (n_split x t x h x 4 bytes) under _FWD_WS_CAP; one split at large t.
    No split is empty."""
    n_steps = -(-f // _FWD_BLOCK_F)
    ctas = max(1, -(-t // _FWD_BLOCK_T)) * _fwd_groups(h)
    n_split = max(1, min(n_steps, sms // ctas,
                         _FWD_WS_CAP // (max(1, t) * h * 4)))
    return _FWD_BLOCK_T, len(_split_ranges(n_steps, n_split))


def _aligned(a: torch.Tensor) -> torch.Tensor:
    """a, contiguous and 16-byte aligned, as the kernels' TMA loads need."""
    a = a.contiguous()
    return a if a.data_ptr() % 16 == 0 else a.clone()


def _ffn_forward_cuda(x, w1, b1, w2, b2, activation, dropout_p, seed,
                      col_offset=0):
    t, h = x.shape
    f = w1.shape[1]
    ts = (x, w1, b1, w2, b2)
    if any(a.dtype != torch.bfloat16 for a in ts):
        raise NotImplementedError(
            "ffn_fwd kernel takes bf16 x/w1/b1/w2/b2, got "
            + "/".join(str(a.dtype) for a in ts))
    if activation not in _ACT_IDS:
        raise NotImplementedError(activation)
    if h not in _KERNEL_HIDDEN or f % _BLOCK_F or f == 0:
        raise NotImplementedError(
            f"ffn_fwd kernel takes d_model in {_KERNEL_HIDDEN} and d_ff a "
            f"multiple of {_BLOCK_F}, got {h} and {f}")
    if (w1.shape != (h, f) or b1.shape != (f,) or w2.shape != (f, h)
            or b2.shape != (h,)):
        raise ValueError("ffn weight shapes do not match x")
    out = torch.empty((t, h), dtype=x.dtype, device=x.device)
    x, w1, b1, w2, b2 = (_aligned(a) for a in ts)
    _, n_split = _fwd_plan(t, h, f, _sm_count(x.device.index or 0))
    ws = (torch.empty((n_split, t, h), dtype=torch.float32, device=x.device)
          if n_split > 1 else None)
    thresh = _threshold(dropout_p) if dropout_p > 0.0 else 0
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ffn_fwd_bf16(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
        t, h, f, _ACT_IDS[activation], n_split, thresh,
        float(1.0 - dropout_p), int(seed) & _M32, int(col_offset), stream)
    check(lib, err, "ffn_fwd")
    FFN_FWD.add()
    return out


# The forward as an operator, `paddle_tpu_torch::ffn_forward` (as
# attention.py's flash_forward): an exported graph records it and
# launches the kernel on the card.
@torch.library.custom_op("paddle_tpu_torch::ffn_forward", mutates_args=())
def _ffn_forward_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor, activation: str,
                    dropout_p: float, seed: int,
                    col_offset: int = 0) -> torch.Tensor:
    if x.is_cuda:
        raise RuntimeError("ffn_forward: no CUDA implementation reached")
    return ffn_forward_reference(x, w1, b1, w2, b2, activation, dropout_p,
                                 seed, col_offset)


@_ffn_forward_op.register_kernel("cuda")
def _(x, w1, b1, w2, b2, activation, dropout_p, seed, col_offset=0):
    return _ffn_forward_cuda(x, w1, b1, w2, b2, activation, dropout_p, seed,
                             col_offset)


@_ffn_forward_op.register_fake
def _(x, w1, b1, w2, b2, activation, dropout_p, seed, col_offset=0):
    return x.new_empty((x.shape[0], w2.shape[1]))


register_grads(_ffn_forward_op, ffn_forward_reference)


def ffn_forward(x, w1, b1, w2, b2, activation="gelu", dropout_p=0.0,
                seed=0, col_offset=0):
    """x (T, H) -> (T, H), through the operator
    `paddle_tpu_torch::ffn_forward`: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors (and nothing else for either).
    `col_offset`: the dropout hash takes d_ff column c as col_offset + c
    (a tensor-parallel rank's columns); 0 gives the one-process bits."""
    if col_offset:
        return _ffn_forward_op(x, w1, b1, w2, b2, str(activation),
                               float(dropout_p), int(seed), int(col_offset))
    return _ffn_forward_op(x, w1, b1, w2, b2, str(activation),
                           float(dropout_p), int(seed))


# -- backward -----------------------------------------------------------------

def ffn_backward_reference(x, w1, b1, w2, b2, seed, g, activation="gelu",
                           dropout_p=0.0, col_offset=0):
    """Plain PyTorch version of the two FFN backward kernels (paddle_tpu's
    `_ffn_backward`): the hidden tile is recomputed from x, never saved.
    Returns (dx, dw1, db1, dw2, db2) in the dtypes of x, w1, b1, w2, b2;
    products accumulate in f32, and h and dpre are cast to the operand
    dtype before the products that take them, as in the kernels."""
    pre = x.float() @ w1.float() + b1.float()
    h = _act(pre, activation)
    dh = g.float() @ w2.float().t()
    if dropout_p > 0.0:
        keep = _ffn_keep(seed, 0, col_offset, x.shape[0], w1.shape[1],
                         dropout_p, device=x.device)
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
    tail = [ctypes.c_uint, ctypes.c_float, ctypes.c_uint, ci, vp]
    if lib.ffn_bwd_dw_bf16.argtypes is None:
        lib.ffn_bwd_dw_bf16.argtypes = [vp] * 9 + [ci] * 5 + tail
        lib.ffn_bwd_dw_bf16.restype = ci
    if lib.ffn_bwd_dx_bf16.argtypes is None:
        lib.ffn_bwd_dx_bf16.argtypes = [vp] * 7 + [ci] * 4 + tail
        lib.ffn_bwd_dx_bf16.restype = ci
    return lib


def _dw_plan(t: int, h: int, f: int, sms: int):
    """(block_t, block_f, n_split) of the dW kernel: one CTA per (block_f
    d_ff columns, token split), each split summing its own f32 partials
    (reduced in a fixed order).  The number of splits puts the largest
    share of the CTAs in whole waves of `sms` (fewest splits among
    equals), at most 8, with the workspace (n_split x (2hf + f) x 4 bytes)
    under _DW_WS_CAP.  No split is empty."""
    n_f = f // _DW_BLOCK_F
    n_t = -(-t // _DW_BLOCK_T)
    cap = max(1, _DW_WS_CAP // ((2 * h * f + f) * 4))
    best, best_eff = 1, 0.0
    for s in range(1, min(n_t, cap, 8) + 1):
        eff = n_f * s / (-(-(n_f * s) // sms) * sms)
        if eff > best_eff + 1e-9:
            best, best_eff = s, eff
    return _DW_BLOCK_T, _DW_BLOCK_F, max(1, len(_split_ranges(n_t, best)))


def _dx_plan(t: int, h: int, f: int):
    """The dx pass's two launches: the dpre kernel's grid (d_ff tiles of
    128, the last one 64 columns wide when f is an odd number of 64-column
    units; token tiles of 128), the dx kernel's grid (d_model tiles of
    128; token tiles of 128), the column tile varying fastest in both,
    and the bf16 dpre workspace, t x f x 2 bytes, that the first writes
    and the second reads."""
    mt = -(-t // _DX_BLOCK_T)
    return dict(block_t=_DX_BLOCK_T, block_f=_DX_BLOCK_F,
                block_n=_DX_BLOCK_N, dpre_grid=(-(-f // _DX_BLOCK_F), mt),
                dx_grid=(h // _DX_BLOCK_N, mt), workspace_bytes=t * f * 2)


def _ffn_bwd_launchers(x, w1, b1, w2, b2, seed, g, activation, dropout_p,
                       col_offset=0):
    """Check the operands and allocate the outputs; return
    ((dx, dw1, db1, dw2, db2), launch_dw, launch_dx), each launcher
    running its kernels once (the dW launcher: the dW pass and its reduce
    over token splits; the dx launcher: dpre into a workspace, then dx).  db2 = sum g is a torch reduction, outside the
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
    if h not in _KERNEL_HIDDEN or f % _BLOCK_F or f == 0:
        raise NotImplementedError(
            f"ffn_bwd kernels take d_model in {_KERNEL_HIDDEN} and d_ff a "
            f"multiple of {_BLOCK_F}, got {h} and {f}")
    if (w1.shape != (h, f) or b1.shape != (f,) or w2.shape != (f, h)
            or b2.shape != (h,) or g.shape != x.shape):
        raise ValueError("ffn backward operand shapes do not match x")
    x, w1, b1, w2, g = (_aligned(a) for a in (x, w1, b1, w2, g))
    _, _, n_split = _dw_plan(t, h, f, _sm_count(x.device.index or 0))
    dx = torch.empty_like(x)
    dw1, db1, dw2 = (torch.empty_like(a) for a in (w1, b1, w2))
    ws = torch.empty((n_split, 2 * h * f + f), dtype=torch.float32,
                     device=x.device)
    db2 = g.float().sum(0).to(b2.dtype)
    thresh = _threshold(dropout_p) if dropout_p > 0.0 else 0
    rng = (thresh, float(1.0 / (1.0 - dropout_p)), int(seed) & _M32,
           int(col_offset))
    # the stream is read at each launch, so a launcher runs on the stream
    # current when it is called (a CUDA graph's capture stream included)
    stream = lambda: torch.cuda.current_stream(x.device).cuda_stream
    ins = (x.data_ptr(), g.data_ptr(), w1.data_ptr(), b1.data_ptr(),
           w2.data_ptr())
    lib = _bwd_lib()
    keep = (x, w1, b1, w2, g, ws)  # alive while the launchers are

    def launch_dw():
        err = lib.ffn_bwd_dw_bf16(*ins, dw1.data_ptr(), db1.data_ptr(),
                                  dw2.data_ptr(), ws.data_ptr(), t, h, f,
                                  _ACT_IDS[activation], n_split, *rng,
                                  stream())
        check(lib, err, "ffn_bwd_dw")
        FFN_BWD_DW.add()
        return keep

    dpre_elems = _dx_plan(t, h, f)["workspace_bytes"] // x.element_size()

    def launch_dx():
        # the dpre workspace lives for this call only
        dpre = torch.empty(dpre_elems, dtype=x.dtype, device=x.device)
        err = lib.ffn_bwd_dx_bf16(*ins, dx.data_ptr(), dpre.data_ptr(), t, h,
                                  f, _ACT_IDS[activation], *rng, stream())
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
                 dropout_p=0.0, col_offset=0):
    """(dx, dw1, db1, dw2, db2) of ffn_forward: the CUDA kernels for CUDA
    tensors, the plain version for CPU tensors (and nothing else for
    either); `col_offset` as ffn_forward's."""
    if x.is_cuda:
        return _ffn_backward_cuda(x, w1, b1, w2, b2, seed, g, activation,
                                  float(dropout_p), col_offset)
    return ffn_backward_reference(x, w1, b1, w2, b2, seed, g, activation,
                                  float(dropout_p), col_offset)


class FusedFFNFunction(torch.autograd.Function):
    """The fused FFN with the kernels' own backward (the custom_vjp of
    paddle_tpu's `_fused_ffn`): saves only x, the weights and the host
    seed; the hidden activation is recomputed, never kept."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, activation, dropout_p, seed,
                col_offset=0):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.args = (seed, activation, dropout_p, col_offset)
        return ffn_forward(x, w1, b1, w2, b2, activation, dropout_p, seed,
                           col_offset)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, b2 = ctx.saved_tensors
        seed, activation, dropout_p, col_offset = ctx.args
        grads = ffn_backward(x, w1, b1, w2, b2, seed, g, activation,
                             dropout_p, col_offset)
        return (*grads, None, None, None, None)


# -- the library arm: cuBLAS products around one element pass -----------------

def _drop_kept(x, keep, dropout_p):
    """x / (1 - p) where `keep`, else 0, an IEEE f32 division on either
    device, as the element-pass kernel divides (CUDA's division by a
    Python scalar multiplies by its reciprocal, one f32 unit off)."""
    div = torch.full((), 1.0 - dropout_p, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / div, torch.zeros_like(x))


def ffn_act_fwd_reference(pre, b1, activation="gelu", dropout_p=0.0,
                          seed=0, col_offset=0):
    """Plain PyTorch version of `ffn_act_fwd`: h = drop(act(pre + b1)) in
    f32, rounded once to pre's dtype; drop keeps a value where
    `_ffn_keep(seed, 0, col_offset, T, F, p)` holds and divides it by
    1 - p."""
    a = _act(pre.float() + b1.float(), activation)
    if dropout_p > 0.0:
        keep = _ffn_keep(seed, 0, col_offset, pre.shape[0], pre.shape[1],
                         dropout_p, device=pre.device)
        a = _drop_kept(a, keep, dropout_p)
    return a.to(pre.dtype)


def ffn_act_bwd_reference(pre, b1, dh, activation="gelu", dropout_p=0.0,
                          seed=0, col_offset=0):
    """Plain PyTorch version of `ffn_act_bwd`: (dpre, h) with dpre =
    drop(dh) * act'(pre + b1) in f32 and h as `ffn_act_fwd_reference`
    gives it, each rounded once to pre's dtype."""
    x = pre.float() + b1.float()
    a, d = _act(x, activation), dh.float()
    if dropout_p > 0.0:
        keep = _ffn_keep(seed, 0, col_offset, pre.shape[0], pre.shape[1],
                         dropout_p, device=pre.device)
        a, d = _drop_kept(a, keep, dropout_p), _drop_kept(d, keep, dropout_p)
    return (d * _act_grad(x, activation)).to(pre.dtype), a.to(pre.dtype)


# the element pass's dtype ids (csrc/ffn_act.cu)
_ACT_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _act_lib():
    lib = library("ffn_act")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    tail = [ci, ci, ci, ctypes.c_uint, ctypes.c_float, ctypes.c_uint, ci, vp]
    if lib.ffn_act_fwd.argtypes is None:
        lib.ffn_act_fwd.argtypes = [ci] + [vp] * 3 + [ctypes.c_longlong] + tail
        lib.ffn_act_fwd.restype = ci
    if lib.ffn_act_bwd.argtypes is None:
        lib.ffn_act_bwd.argtypes = [ci] + [vp] * 5 + [ctypes.c_longlong] + tail
        lib.ffn_act_bwd.restype = ci
    return lib


def _act_operands(pre, b1, others, activation):
    """Check the element pass's operands; (pre, b1, *others) contiguous."""
    ts = (pre, b1, *others)
    if pre.dtype not in _ACT_DTYPES or any(a.dtype != pre.dtype for a in ts):
        raise NotImplementedError(
            "ffn_act kernels take bf16 or f32 operands of one dtype, "
            "got " + "/".join(str(a.dtype) for a in ts))
    if activation not in _ACT_IDS:
        raise NotImplementedError(activation)
    if pre.ndim != 2 or b1.shape != (pre.shape[1],) or any(
            a.shape != pre.shape for a in others):
        raise ValueError("ffn_act operand shapes do not match pre (T, F)")
    return tuple(a.contiguous() for a in ts)


def _act_rng(dropout_p, seed, col_offset=0):
    drop = dropout_p > 0.0
    return (int(drop), _threshold(dropout_p) if drop else 0,
            float(1.0 - dropout_p), int(seed) & _M32, int(col_offset))


def _ffn_act_fwd_cuda(pre, b1, activation, dropout_p, seed, col_offset=0):
    pre, b1 = _act_operands(pre, b1, (), activation)
    h = torch.empty_like(pre)
    lib = _act_lib()
    err = lib.ffn_act_fwd(
        _ACT_DTYPES[pre.dtype], pre.data_ptr(), b1.data_ptr(), h.data_ptr(),
        *pre.shape, _ACT_IDS[activation],
        *_act_rng(float(dropout_p), seed, col_offset),
        torch.cuda.current_stream(pre.device).cuda_stream)
    check(lib, err, "ffn_act_fwd")
    FFN_ACT_FWD.add()
    return h


# The element pass as an operator, `paddle_tpu_torch::ffn_act_fwd` (as
# attention.py's flash_forward).
@torch.library.custom_op("paddle_tpu_torch::ffn_act_fwd", mutates_args=())
def _ffn_act_fwd_op(pre: torch.Tensor, b1: torch.Tensor, activation: str,
                    dropout_p: float, seed: int,
                    col_offset: int = 0) -> torch.Tensor:
    if pre.is_cuda:
        raise RuntimeError("ffn_act_fwd: no CUDA implementation reached")
    return ffn_act_fwd_reference(pre, b1, activation, dropout_p, seed,
                                 col_offset)


@_ffn_act_fwd_op.register_kernel("cuda")
def _(pre, b1, activation, dropout_p, seed, col_offset=0):
    return _ffn_act_fwd_cuda(pre, b1, activation, dropout_p, seed,
                             col_offset)


@_ffn_act_fwd_op.register_fake
def _(pre, b1, activation, dropout_p, seed, col_offset=0):
    return pre.new_empty(pre.shape)


register_grads(_ffn_act_fwd_op, ffn_act_fwd_reference)


def ffn_act_fwd(pre, b1, activation="gelu", dropout_p=0.0, seed=0,
                col_offset=0):
    """h = drop(act(pre + b1)), (T, F), through the operator
    `paddle_tpu_torch::ffn_act_fwd`: the kernel `ffn_act_fwd`
    (csrc/ffn_act.cu) for CUDA tensors, the plain version for CPU
    tensors (and nothing else for either).  `col_offset` as
    ffn_forward's."""
    if col_offset:
        return _ffn_act_fwd_op(pre, b1, str(activation), float(dropout_p),
                               int(seed), int(col_offset))
    return _ffn_act_fwd_op(pre, b1, str(activation), float(dropout_p),
                           int(seed))


def ffn_act_bwd(pre, b1, dh, activation="gelu", dropout_p=0.0, seed=0,
                col_offset=0):
    """(dpre, h): dpre = drop(dh) * act'(pre + b1) and the forward's h,
    recomputed in the same pass: the kernel `ffn_act_bwd` for CUDA
    tensors, the plain version for CPU tensors (and nothing else for
    either)."""
    if not pre.is_cuda:
        return ffn_act_bwd_reference(pre, b1, dh, activation,
                                     float(dropout_p), seed, col_offset)
    pre, b1, dh = _act_operands(pre, b1, (dh,), activation)
    dpre, h = torch.empty_like(pre), torch.empty_like(pre)
    lib = _act_lib()
    err = lib.ffn_act_bwd(
        _ACT_DTYPES[pre.dtype], pre.data_ptr(), b1.data_ptr(), dh.data_ptr(),
        dpre.data_ptr(), h.data_ptr(), *pre.shape, _ACT_IDS[activation],
        *_act_rng(float(dropout_p), seed, col_offset),
        torch.cuda.current_stream(pre.device).cuda_stream)
    check(lib, err, "ffn_act_bwd")
    FFN_ACT_BWD.add()
    return dpre, h


class FFNLibraryFunction(torch.autograd.Function):
    """The library arm of `fused_ffn`, the counterpart of paddle_tpu's
    non-kernel arm (ffn.py:506-516): pre = x @ W1 (cuBLAS, f32
    accumulation, rounded to x's dtype), h = `ffn_act_fwd`(pre, b1), out
    = h @ W2 + b2.  It saves pre, not h: the backward's `ffn_act_bwd`
    recomputes h in the pass that forms dpre, for dW2 = h^T g; dW1 = x^T
    dpre, dx = dpre W1^T, db1 and db2 are the column sums of dpre and g
    in f32."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, activation, dropout_p, seed,
                col_offset=0):
        pre = torch.matmul(x, w1)
        h = ffn_act_fwd(pre, b1, activation, dropout_p, seed, col_offset)
        ctx.save_for_backward(x, w1, b1, w2, pre)
        ctx.args = (activation, dropout_p, seed, b2.dtype, col_offset)
        return torch.addmm(b2, h, w2)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, pre = ctx.saved_tensors
        activation, dropout_p, seed, b2_dtype, col_offset = ctx.args
        dpre, h = ffn_act_bwd(pre, b1, torch.matmul(g, w2.t()), activation,
                              dropout_p, seed, col_offset)
        return (torch.matmul(dpre, w1.t()), torch.matmul(x.t(), dpre),
                dpre.sum(0, dtype=torch.float32).to(b1.dtype),
                torch.matmul(h.t(), g),
                g.sum(0, dtype=torch.float32).to(b2_dtype), None, None, None,
                None)


# -- the dispatch -------------------------------------------------------------

def disable_fused_ffn(reason):
    """Close the kernel arm: `fused_ffn` runs the library arm."""
    global _FFN_DISABLED
    _FFN_DISABLED = reason


def enable_fused_ffn():
    """Open the kernel arm for the shapes and dtypes the kernels take."""
    global _FFN_DISABLED
    _FFN_DISABLED = None


def _ffn_arm(dtypes, h: int, f: int) -> str:
    """"kernel" or "library": the arm `fused_ffn` takes, from the switch,
    the operands' dtypes and the widths alone, before anything launches.
    The kernel arm needs the switch open, bf16 x and weights, d_model in
    the kernels' set and d_ff a whole number of their 64-column steps
    (the port's form of the reference's H % 128 == 0, ffn.py:477)."""
    if (_FFN_DISABLED is None
            and all(d == torch.bfloat16 for d in dtypes)
            and h in _KERNEL_HIDDEN and f > 0 and f % _BLOCK_F == 0):
        return "kernel"
    return "library"


def fused_ffn(x, w1, b1, w2, b2, activation="gelu", dropout_p=0.0,
              dropout_seed=None, col_offset=0):
    """dropout(act(x @ w1 + b1), p) @ w2 + b2 over any leading dims,
    differentiable in x and the four weights.  x: (..., H); w1 (H, F);
    w2 (F, H).  Returns (..., H).

    The arm comes from `_ffn_arm`: `FusedFFNFunction` (the kernels) or
    `FFNLibraryFunction`; never chosen after a failure, so a kernel that
    fails to build or launch raises.  Each call is counted as
    `ffn_dispatch_kernel` or `ffn_dispatch_library` (the reference's
    `ffn_dispatch_xla`).  `col_offset`: the d_ff columns' place among a
    tensor-parallel model's, for the dropout hash (ffn_forward)."""
    lead = x.shape[:-1]
    seed = 0 if dropout_seed is None else int(dropout_seed)
    arm = _ffn_arm((x.dtype, w1.dtype, b1.dtype, w2.dtype, b2.dtype),
                   x.shape[-1], w1.shape[1])
    profiler.stat_add(f"ffn_dispatch_{arm}")
    fn = FusedFFNFunction if arm == "kernel" else FFNLibraryFunction
    out = fn.apply(x.reshape(-1, x.shape[-1]), w1, b1, w2, b2, activation,
                   float(dropout_p), seed, int(col_offset))
    return out.reshape(*lead, x.shape[-1])
