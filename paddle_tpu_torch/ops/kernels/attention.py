"""Flash-attention forward (counterpart of paddle_tpu/ops/pallas/attention.py,
forward part).

`flash_forward` is the wrapper of the hand-written CUDA kernel
`csrc/flash_fwd.cu` (which replaces the Pallas `_flash_fwd_kernel`): on a
CUDA tensor it launches the kernel or raises; on a CPU tensor it runs the
plain PyTorch version `flash_forward_reference`, which computes the same
function.  `flash_attention` is the shim around it, and
`scaled_dot_product_attention` the dispatcher the nn layers call.

Layout contract (paddle 2.x MultiHeadAttention): q/k/v are
(batch, seq, num_heads, head_dim).  The kernel reads that layout in place
by strides and masks ragged sequence edges itself, so the TPU shim's
transpose to (B*H, S, D) and padding to block multiples do not exist here.

Dropout inside attention uses `_keep_mask3`, the TPU kernel's stateless
hash of (seed, batch*head, q, k), bit for bit — so the port and the JAX
package drop the same probabilities for the same seed.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import LaunchCounter, check, library

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

FLASH_FWD = LaunchCounter("flash_fwd")

_M32 = 0xFFFFFFFF
_KERNEL_HEAD_DIMS = (16, 32, 64, 128)


# -- counter-based dropout hash -------------------------------------------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32): the product is split
    in two 16-bit halves of c so no int64 product overflows (torch has
    no uint32 multiply on the CPU)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _finalize(x: torch.Tensor) -> torch.Tensor:
    """The lowbias32 finalizer of the TPU kernels' hash."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _threshold(dropout_p: float) -> int:
    return min(int(dropout_p * 2 ** 32), 2 ** 32 - 1)


def _keep_mask3(seed, bh0, q0, k0, block_h, block_q, block_k, dropout_p,
                device=None) -> torch.Tensor:
    """(block_h, block_q, block_k) keep mask for block_h consecutive
    batch-heads starting at bh0 — paddle_tpu's `_keep_mask3`, bit for bit:
    a 32-bit hash of (seed, bh, absolute q, absolute k), computed in int64
    masked to 32 bits after every multiply."""
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    r = (q0 + ar(block_q)).view(1, -1, 1)
    c = (k0 + ar(block_k)).view(1, 1, -1)
    bh = (bh0 + ar(block_h)).view(-1, 1, 1)
    x = _mul32(r, 0x9E3779B1) ^ _mul32(c, 0x85EBCA77)
    x = x ^ _mul32(bh + 1, 0x27D4EB2F)
    x = x ^ ((int(seed) & _M32) * 0x165667B1 & _M32)
    return _finalize(x) >= _threshold(dropout_p)


# -- plain PyTorch version ------------------------------------------------------

def flash_forward_reference(q, k, v, key_bias=None, seed=0, causal=False,
                            causal_offset=None, scale=None, dropout_p=0.0):
    """Plain PyTorch version of the flash forward kernel.

    q (B, Sq, H, D), k/v (B, Sk, H, D); key_bias (B, Sk) f32 or None.
    Returns (out (B, Sq, H, D) in q's dtype, lse (B, H, Sq) f32).  Scores
    and softmax in f32; the dropped probabilities are cast to v's dtype
    before the second product, as in the kernel."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if causal_offset is None:
        causal_offset = sk - sq
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(qi + causal_offset >= ki, s,
                        torch.full_like(s, DEFAULT_MASK_VALUE))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(l)).squeeze(-1)
    if dropout_p > 0.0:
        keep = _keep_mask3(seed, 0, 0, 0, b * h, sq, sk, dropout_p,
                           device=q.device).view(b, h, sq, sk)
        p = torch.where(keep, p / (1.0 - dropout_p), torch.zeros_like(p))
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = acc / l.permute(0, 2, 1, 3)
    return out.to(q.dtype), lse


# -- the CUDA kernel's wrapper --------------------------------------------------

def _lib():
    lib = library("flash_fwd")
    fn = lib.flash_fwd_bf16
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                       ctypes.POINTER(ctypes.c_longlong), ci, ci,
                       ctypes.c_float, ctypes.c_uint, ctypes.c_float,
                       ctypes.c_uint, vp]
        fn.restype = ci
    return lib


def _kernel_ready(t: torch.Tensor) -> torch.Tensor:
    """The kernel reads rows of 16 bytes: last dim contiguous, other
    strides multiples of 8 elements, base 16-byte aligned."""
    if (t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1])
            or t.data_ptr() % 16):
        t = t.contiguous()
    return t


def _flash_forward_cuda(q, k, v, key_bias, seed, causal, causal_offset,
                        scale, dropout_p):
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise NotImplementedError(
            f"flash_fwd kernel takes bf16 q/k/v, got {q.dtype}/{k.dtype}/"
            f"{v.dtype}")
    if d not in _KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_fwd kernel takes head_dim in {_KERNEL_HEAD_DIMS}, got {d}")
    if k.shape != (b, sk, h, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / "
                         f"v {tuple(v.shape)} do not match")
    if sk < 1 or b * h > 65535:
        raise ValueError(f"flash_fwd kernel needs Sk >= 1 and B*H <= 65535 "
                         f"(got Sk={sk}, B*H={b * h})")
    q, k, v = _kernel_ready(q), _kernel_ready(k), _kernel_ready(v)
    if key_bias is not None:
        key_bias = key_bias.to(torch.float32).contiguous()
        if key_bias.shape != (b, sk):
            raise ValueError(f"key_bias must be (B, Sk)=({b}, {sk}), got "
                             f"{tuple(key_bias.shape)}")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 9)(
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
        k.stride(2), v.stride(0), v.stride(1), v.stride(2))
    thresh = _threshold(dropout_p) if dropout_p > 0.0 else 0
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if key_bias is None else key_bias.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, h, sq, sk, d, strides,
        int(bool(causal)), int(causal_offset), float(scale), thresh,
        float(1.0 - dropout_p), int(seed) & _M32, stream)
    check(lib, err, "flash_fwd")
    FLASH_FWD.add()
    return out, lse


def flash_forward(q, k, v, key_bias=None, seed=0, causal=False,
                  causal_offset=None, scale=None, dropout_p=0.0):
    """(out, lse) of the flash forward: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors (and nothing else for either)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if causal_offset is None:
        causal_offset = k.shape[1] - q.shape[1]
    if q.is_cuda:
        return _flash_forward_cuda(q, k, v, key_bias, seed, causal,
                                   causal_offset, scale, dropout_p)
    return flash_forward_reference(q, k, v, key_bias, seed, causal,
                                   causal_offset, scale, dropout_p)


# -- shim, mask normalization, dispatcher ---------------------------------------

def flash_attention(q, k, v, key_bias=None, is_causal=False, scale=None,
                    dropout_p=0.0, dropout_seed=None):
    """(B, S, H, D) flash attention (paddle_tpu `flash_attention`).

    key_bias: optional (B, Sk) additive bias applied to every query row
    (the kernel's form of a key-padding mask), treated as a constant.
    Any Sq/Sk is accepted: the kernel masks the ragged edges, so there is
    no padding of the inputs and no slicing of the output."""
    if key_bias is not None:
        key_bias = key_bias.detach().to(torch.float32)
    seed = 0 if (dropout_p <= 0.0 or dropout_seed is None) \
        else int(dropout_seed)
    out, _ = flash_forward(q, k, v, key_bias, seed, is_causal,
                           k.shape[1] - q.shape[1], scale, float(dropout_p))
    return out


def _mask_as_key_bias(mask, batch, sk) -> Optional[torch.Tensor]:
    """Reduce a mask to a (B, Sk) additive f32 key bias if it is constant
    over query and head dims; None when it is not expressible."""
    if mask is None:
        return None
    m = mask
    if m.ndim == 4:
        if m.shape[1] != 1 or m.shape[2] != 1:
            return None
        m = m[:, 0, 0, :]
    elif m.ndim == 3:
        if m.shape[1] != 1:
            return None
        m = m[:, 0, :]
    elif m.ndim != 2:
        return None
    if m.shape[-1] != sk:
        return None
    if m.dtype == torch.bool:
        m = torch.where(m, 0.0, DEFAULT_MASK_VALUE)
    return torch.broadcast_to(m.to(torch.float32), (batch, sk))


def scaled_dot_product_attention(q, k, v, mask=None, is_causal=False,
                                 scale=None, dropout_p=0.0,
                                 dropout_seed=None):
    """Dispatcher: the flash kernel for CUDA tensors, its plain version for
    CPU tensors.  Key-padding masks (any form constant over query and
    head dims, bool or additive) run in the kernel as a key bias; a mask
    that varies per query or per head raises NotImplementedError.
    q/k/v: (batch, seq, heads, head_dim)."""
    key_bias = _mask_as_key_bias(mask, q.shape[0], k.shape[1])
    if mask is not None and key_bias is None:
        raise NotImplementedError(
            f"attention mask of shape {tuple(mask.shape)} varies per query "
            "or per head; the flash kernel takes key-padding masks only")
    return flash_attention(q, k, v, key_bias=key_bias, is_causal=is_causal,
                           scale=scale, dropout_p=dropout_p,
                           dropout_seed=dropout_seed)


def dense_attention(q, k, v, mask=None, is_causal=False, scale=None):
    """(B, S, H, D) attention materializing the full score matrix
    (counterpart of `_xla_attention`, without dropout).  A test oracle;
    the port never calls it."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, DEFAULT_MASK_VALUE) \
            if mask.dtype == torch.bool else logits + mask
    if is_causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        causal = torch.ones((sq, sk), dtype=torch.bool,
                            device=q.device).tril(sk - sq)
        logits = torch.where(causal, logits, DEFAULT_MASK_VALUE)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
