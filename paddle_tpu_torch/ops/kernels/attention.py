"""Flash attention, forward and backward, and ragged paged attention
(counterpart of paddle_tpu/ops/pallas/attention.py).

`flash_forward` is the wrapper of the hand-written CUDA kernel
`csrc/flash_fwd.cu` (which replaces the Pallas `_flash_fwd_kernel`),
`flash_backward` the wrapper of the two kernels of `csrc/flash_bwd.cu`
(which replace `_flash_bwd_dkv_kernel` and `_flash_bwd_dq_kernel`), and
`ragged_paged_forward` (behind `paged_attention`) the wrapper of
`csrc/ragged_paged.cu` (which replaces `_ragged_paged_kernel`): on a
CUDA tensor each launches its kernels or raises; on a CPU tensor it runs
the plain PyTorch version (`flash_forward_reference`,
`flash_backward_reference`, `ragged_paged_reference`), which computes
the same function.
`FlashAttentionFunction` ties the two together for autograd (the
`custom_vjp` of the JAX package), `flash_attention` is the shim around
it, and `scaled_dot_product_attention` the dispatcher the nn layers call:
it sends a mask that varies per query or per head to `dense_attention`,
plain torch ops on either device, as the JAX package sends it to
`_xla_attention` outside its Pallas kernel.

Layout contract (paddle 2.x MultiHeadAttention): q/k/v are
(batch, seq, num_heads, head_dim).  The kernel reads that layout in place
by strides and masks ragged sequence edges itself, so the TPU shim's
transpose to (B*H, S, D) and padding to block multiples do not exist here.

Dropout inside attention uses `_keep_mask3`, the TPU kernel's stateless
hash of (seed, batch*head, q, k), bit for bit — so the port and the JAX
package drop the same probabilities for the same seed.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from ... import profiler
from .build import LaunchCounter, check, library, sm_count as _sm_count

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

FLASH_FWD = LaunchCounter("flash_fwd")
FLASH_BWD_DKV = LaunchCounter("flash_bwd_dkv")
FLASH_BWD_DQ = LaunchCounter("flash_bwd_dq")
RAGGED_PAGED = LaunchCounter("ragged_paged")

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
                device=None, heads=None, heads_total=None,
                head_offset=0) -> torch.Tensor:
    """(block_h, block_q, block_k) keep mask for block_h consecutive
    batch-heads starting at bh0 — paddle_tpu's `_keep_mask3`, bit for bit:
    a 32-bit hash of (seed, bh, absolute q, absolute k), computed in int64
    masked to 32 bits after every multiply.  With `heads` (the heads of
    the tensor the batch-heads index) and `heads_total` / `head_offset`,
    local batch-head b*heads + h hashes as global b*heads_total +
    head_offset + h: a tensor-parallel rank's heads draw the one-process
    masks of the heads they are."""
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    r = (q0 + ar(block_q)).view(1, -1, 1)
    c = (k0 + ar(block_k)).view(1, 1, -1)
    bh = (bh0 + ar(block_h)).view(-1, 1, 1)
    if heads is not None:
        bh = (bh // heads) * (heads_total or heads) + head_offset \
            + bh % heads
    x = _mul32(r, 0x9E3779B1) ^ _mul32(c, 0x85EBCA77)
    x = x ^ _mul32(bh + 1, 0x27D4EB2F)
    x = x ^ ((int(seed) & _M32) * 0x165667B1 & _M32)
    return _finalize(x) >= _threshold(dropout_p)


# -- plain PyTorch version ------------------------------------------------------

def _scores(q, k, key_bias, causal, causal_offset, scale):
    """(B, H, Sq, Sk) f32 scores as the kernels form them: q k^T * scale
    + key bias, DEFAULT_MASK_VALUE above the causal diagonal."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(qi + causal_offset >= ki, s,
                        torch.full_like(s, DEFAULT_MASK_VALUE))
    return s


def flash_forward_reference(q, k, v, key_bias=None, seed=0, causal=False,
                            causal_offset=None, scale=None, dropout_p=0.0,
                            heads_total=0, head_offset=0):
    """Plain PyTorch version of the flash forward kernel.

    q (B, Sq, H, D), k/v (B, Sk, H, D); key_bias (B, Sk) f32 or None.
    Returns (out (B, Sq, H, D) in q's dtype, lse (B, H, Sq) f32).  Scores
    and softmax in f32; the dropped probabilities are cast to v's dtype
    before the second product, as in the kernel.  The dropout hash takes
    head h as head `head_offset + h` of `heads_total` (0: H), a
    tensor-parallel rank's heads."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if causal_offset is None:
        causal_offset = sk - sq
    s = _scores(q, k, key_bias, causal, causal_offset, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(l)).squeeze(-1)
    if dropout_p > 0.0:
        keep = _keep_mask3(seed, 0, 0, 0, b * h, sq, sk, dropout_p,
                           device=q.device, heads=h, heads_total=heads_total,
                           head_offset=head_offset).view(b, h, sq, sk)
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
        fn.argtypes = [vp, vp, vp, vp, ci, vp, vp, ci, ci, ci, ci, ci,
                       ctypes.POINTER(ctypes.c_longlong), ci, ci, ci,
                       ctypes.c_float, ctypes.c_uint, ctypes.c_float,
                       ctypes.c_uint, ci, ci, vp]
        fn.restype = ci
    return lib


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """A (B, S, H, D) operand as the flash kernels' 4-D tensor maps take
    it: last dim contiguous, the other strides multiples of 8 elements
    that nest (each at least the extent below it), base 16-byte aligned;
    another layout is copied to a contiguous one."""
    _, s, h, d = t.shape
    sb, ss, sh, sd = t.stride()
    if (sd != 1 or any(x % 8 for x in (sb, ss, sh)) or t.data_ptr() % 16
            or not (sh >= d and ss >= sh * h and sb >= ss * s)):
        t = t.contiguous()
    return t


_FLASH_BLOCK_M, _FLASH_BLOCK_K = 64, 64  # a warpgroup's queries; a key tile


def _flash_plan(b: int, h: int, sq: int, sk: int, d: int, sms: int):
    """(block_q, block_k, ctas) of the flash forward kernel: a CTA holds
    one or two warpgroups of 64 queries each (block_q 64 or 128) that
    share each K/V tile of block_k keys; its grid is (query tiles,
    batch*head).  128 is taken unless it leaves the card with less than
    one wave of `sms` CTAs (the decode prefills: one sequence of 64-256
    queries), where 64 doubles the CTAs.  `sk` and `d` do not change the
    plan."""
    del sk, d
    bh = b * h
    big = -(-sq // (2 * _FLASH_BLOCK_M)) * bh
    block_q = 2 * _FLASH_BLOCK_M if big >= sms else _FLASH_BLOCK_M
    return block_q, _FLASH_BLOCK_K, -(-sq // block_q) * bh


def _f32_rows_for_tma(x: torch.Tensor):
    """(rows, row stride) of a 2-D tensor as the kernels' 2-D f32 tensor
    maps read it: the tensor itself when it is contiguous f32 with 16-byte
    aligned rows, else a copy whose rows are padded to a multiple of 4
    values (the pad is never read: a map's extent is the tensor's)."""
    x = x.to(torch.float32).contiguous()
    if x.shape[1] % 4 or x.data_ptr() % 16:
        x = torch.nn.functional.pad(x, (0, -x.shape[1] % 4))
    return x, x.shape[1]


def _bias_for_tma(key_bias, b: int, sk: int):
    """(bias, row stride) as the flash kernels' TMA reads the (B, Sk) key
    biases (`_f32_rows_for_tma`); (None, 0) without one."""
    if key_bias is None:
        return None, 0
    if key_bias.shape != (b, sk):
        raise ValueError(f"key_bias must be (B, Sk)=({b}, {sk}), got "
                         f"{tuple(key_bias.shape)}")
    return _f32_rows_for_tma(key_bias)


def _flash_forward_cuda(q, k, v, key_bias, seed, causal, causal_offset,
                        scale, dropout_p, heads_total=0, head_offset=0):
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
    if sq < 1 or sk < 1 or b * h > 65535:
        raise ValueError(f"flash_fwd kernel needs Sq, Sk >= 1 and B*H <= "
                         f"65535 (got Sq={sq}, Sk={sk}, B*H={b * h})")
    q, k, v = _tma_ready(q), _tma_ready(k), _tma_ready(v)
    kb, bias_ld = _bias_for_tma(key_bias, b, sk)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 9)(
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
        k.stride(2), v.stride(0), v.stride(1), v.stride(2))
    block_q, _, _ = _flash_plan(b, h, sq, sk, d,
                                _sm_count(q.device.index or 0))
    thresh = _threshold(dropout_p) if dropout_p > 0.0 else 0
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if kb is None else kb.data_ptr(), bias_ld, out.data_ptr(), lse.data_ptr(), b, h, sq, sk, d, strides, block_q,
        int(bool(causal)), int(causal_offset), float(scale), thresh,
        float(1.0 - dropout_p), int(seed) & _M32, int(heads_total or h),
        int(head_offset), stream)
    check(lib, err, "flash_fwd")
    FLASH_FWD.add()
    return out, lse


def register_grads(op, plain):
    """Autograd of a kernel's forward operator on the CPU: the plain
    version's own autograd, recomputed, as it was before the forward
    became an operator.  On the card the training paths differentiate
    through their autograd.Functions (whose forward runs with grad off),
    and a gradient asked of the operator itself raises."""

    def setup(ctx, inputs, output):
        ctx.save_for_backward(*[x for x in inputs
                                if isinstance(x, torch.Tensor)])
        ctx.others = [None if isinstance(x, torch.Tensor) else x
                      for x in inputs]
        ctx.tensor_at = {i for i, x in enumerate(inputs)
                         if isinstance(x, torch.Tensor)}

    def backward(ctx, *grads):
        if any(g is not None and g.is_cuda for g in grads):
            raise NotImplementedError(
                f"{op}: differentiate through the kernels' autograd "
                f"Function (FlashAttentionFunction, FusedFFNFunction, "
                f"FFNLibraryFunction), whose backward is a kernel")
        saved = iter(ctx.saved_tensors)
        leaves = [next(saved).detach().requires_grad_(need)
                  if i in ctx.tensor_at else x
                  for i, (x, need) in enumerate(zip(ctx.others,
                                                    ctx.needs_input_grad))]
        with torch.enable_grad():
            outs = plain(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wrt = [x for x in leaves if isinstance(x, torch.Tensor)
               and x.requires_grad]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [g for _, g in pairs],
            allow_unused=True) if pairs and wrt else [None] * len(wrt))
        return tuple(next(got) if isinstance(x, torch.Tensor)
                     and x.requires_grad else None for x in leaves)

    op.register_autograd(backward, setup_context=setup)


# The forward as an operator, `paddle_tpu_torch::flash_forward`: its CUDA
# implementation launches the kernel, its CPU implementation is the plain
# version.  A graph traced by torch.export records the operator, not the
# branch one of them takes, so an exported model launches the kernel on
# the card.
@torch.library.custom_op("paddle_tpu_torch::flash_forward", mutates_args=())
def _flash_forward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      key_bias: Optional[torch.Tensor], seed: int,
                      causal: bool, causal_offset: int, scale: float,
                      dropout_p: float, heads_total: int = 0,
                      head_offset: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    if q.is_cuda:
        raise RuntimeError("flash_forward: no CUDA implementation reached")
    return flash_forward_reference(q, k, v, key_bias, seed, causal,
                                   causal_offset, scale, dropout_p,
                                   heads_total, head_offset)


@_flash_forward_op.register_kernel("cuda")
def _(q, k, v, key_bias, seed, causal, causal_offset, scale, dropout_p,
      heads_total=0, head_offset=0):
    return _flash_forward_cuda(q, k, v, key_bias, seed, causal,
                               causal_offset, scale, dropout_p, heads_total,
                               head_offset)


@_flash_forward_op.register_fake
def _(q, k, v, key_bias, seed, causal, causal_offset, scale, dropout_p,
      heads_total=0, head_offset=0):
    b, sq, h, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((b, h, sq), dtype=torch.float32))


register_grads(_flash_forward_op, flash_forward_reference)


def flash_forward(q, k, v, key_bias=None, seed=0, causal=False,
                  causal_offset=None, scale=None, dropout_p=0.0,
                  heads_total=0, head_offset=0):
    """(out, lse) of the flash forward, through the operator
    `paddle_tpu_torch::flash_forward`: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors (and nothing else for either).
    `heads_total` / `head_offset`: the dropout hash takes head h as head
    head_offset + h of heads_total (0: q's H), a tensor-parallel rank's
    heads; the defaults give the one-process bits."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if causal_offset is None:
        causal_offset = k.shape[1] - q.shape[1]
    if heads_total or head_offset:
        return _flash_forward_op(q, k, v, key_bias, int(seed), bool(causal),
                                 int(causal_offset), float(scale),
                                 float(dropout_p), int(heads_total),
                                 int(head_offset))
    return _flash_forward_op(q, k, v, key_bias, int(seed), bool(causal),
                             int(causal_offset), float(scale),
                             float(dropout_p))


# -- backward: plain version -----------------------------------------------------

def flash_backward_reference(q, k, v, key_bias, seed, out, lse, g,
                             causal=False, causal_offset=None, scale=None,
                             dropout_p=0.0, heads_total=0, head_offset=0):
    """Plain PyTorch version of the two flash backward kernels: the
    formulas of paddle_tpu's `_flash_bwd_dkv_kernel` and
    `_flash_bwd_dq_kernel` in the (B, S, H, D) layout, scores in f32,
    from the forward's saved out and lse (not autograd through the
    forward).  Returns (dq, dk, dv) in the dtypes of q, k, v."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if causal_offset is None:
        causal_offset = sk - sq
    s = _scores(q, k, key_bias, causal, causal_offset, scale)
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    if dropout_p > 0.0:
        keep = _keep_mask3(seed, 0, 0, 0, b * h, sq, sk, dropout_p,
                           device=q.device, heads=h, heads_total=heads_total,
                           head_offset=head_offset).view(b, h, sq, sk)
        inv = 1.0 / (1.0 - dropout_p)
        p_drop = torch.where(keep, p * inv, torch.zeros_like(p))
        dp = torch.where(keep, dp * inv, torch.zeros_like(dp))
    else:
        p_drop = p
    delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1)  # (B,H,Sq)
    ds = p * (dp - delta[..., None]) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p_drop.to(g.dtype).float(),
                      g.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- backward: the CUDA kernels' wrapper -----------------------------------------

_NST = 3  # ring stages of csrc/flash_bwd.cu (flash_common.cuh's NST)


def _flash_bwd_smem_bytes(d: int, dkv: bool) -> int:
    """Dynamic shared memory of a backward CTA (csrc/flash_bwd.cu's DqSmem
    and DkvSmem): two resident bf16 operands of 128 rows (Q and G, or K
    and V), NST stages of two streamed (64, D) bf16 tiles and of one
    (dq: key biases) or two (dkv: lse, delta) rows of 64 f32 values, the
    mbarriers and the stage counts, and 1024 bytes to align the base."""
    resident = 2 * 2 * _FLASH_BLOCK_M * d * 2
    ring = _NST * (2 * _FLASH_BLOCK_K * d * 2
                   + (2 if dkv else 1) * _FLASH_BLOCK_K * 4)
    return resident + ring + (_NST + 1) * 8 + _NST * 4 + 1024


def _flash_bwd_plan(b: int, h: int, sq: int, sk: int, d: int, sms: int):
    """The two backward passes' launch plan: the dq pass takes the forward's
    plan over the queries (the same CTAs, so it skips the key tiles the
    forward skipped above the causal diagonal), the dkv pass the same rule
    over the keys (64 or 128 keys a CTA); with the grids' CTA counts and
    the shared-memory bytes each CTA asks for."""
    dq_block, _, dq_ctas = _flash_plan(b, h, sq, sk, d, sms)
    dkv_block, _, dkv_ctas = _flash_plan(b, h, sk, sq, d, sms)
    return dict(dq_block=dq_block, dq_ctas=dq_ctas,
                dq_smem=_flash_bwd_smem_bytes(d, False),
                dkv_block=dkv_block, dkv_ctas=dkv_ctas,
                dkv_smem=_flash_bwd_smem_bytes(d, True))


def _bwd_lib():
    lib = library("flash_bwd")
    for fn in (lib.flash_bwd_dkv_bf16, lib.flash_bwd_dq_bf16):
        if fn.argtypes is None:
            vp, ci = ctypes.c_void_p, ctypes.c_int
            outs = [vp, vp] if fn is lib.flash_bwd_dkv_bf16 else [vp]
            fn.argtypes = ([vp] * 5 + [ci, vp, vp, ci] + outs + [ci] * 5
                           + [ctypes.POINTER(ctypes.c_longlong), ci, ci, ci,
                              ctypes.c_float, ctypes.c_uint, ctypes.c_float,
                              ctypes.c_uint, ci, ci, vp])
            fn.restype = ci
    return lib


def _flash_bwd_launchers(q, k, v, key_bias, seed, out, lse, g, causal,
                         causal_offset, scale, dropout_p, heads_total=0,
                         head_offset=0):
    """Check the operands, allocate dq/dk/dv and compute delta; return
    ((dq, dk, dv), launch_dkv, launch_dq), each launcher running its
    kernel once (chip_smoke times the two kernels apart)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if not all(t.dtype == torch.bfloat16 for t in (q, k, v, out, g)):
        raise NotImplementedError(
            "flash_bwd kernels take bf16 q/k/v/out/g, got "
            + "/".join(str(t.dtype) for t in (q, k, v, out, g)))
    if d not in _KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_bwd kernels take head_dim in {_KERNEL_HEAD_DIMS}, got {d}")
    if (k.shape != (b, sk, h, d) or v.shape != k.shape
            or out.shape != q.shape or g.shape != q.shape
            or lse.shape != (b, h, sq)):
        raise ValueError("flash_bwd operand shapes do not match q "
                         f"{tuple(q.shape)}")
    if sk < 1 or b * h > 65535:
        raise ValueError(f"flash_bwd kernels need Sk >= 1 and B*H <= 65535 "
                         f"(got Sk={sk}, B*H={b * h})")
    q, k, v, g = (_tma_ready(t) for t in (q, k, v, g))
    kb, bias_ld = _bias_for_tma(key_bias, b, sk)
    lse, rows_ld = _f32_rows_for_tma(lse.reshape(b * h, sq))
    # delta = rowsum(g * out), outside the kernels as in JAX (:395)
    delta, _ = _f32_rows_for_tma(
        (g.float() * out.float()).sum(-1).permute(0, 2, 1).reshape(b * h, sq))
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(st for t in (q, k, v, g) for st in t.stride()[:3]))
    plan = _flash_bwd_plan(b, h, sq, sk, d, _sm_count(q.device.index or 0))
    thresh = _threshold(dropout_p) if dropout_p > 0.0 else 0
    lib = _bwd_lib()
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
              None if kb is None else kb.data_ptr(), bias_ld,
              lse.data_ptr(), delta.data_ptr(), rows_ld)
    dims = (b, h, sq, sk, d, strides)
    tail = (int(bool(causal)), int(causal_offset), float(scale), thresh,
            float(1.0 / (1.0 - dropout_p)), int(seed) & _M32,
            int(heads_total or h), int(head_offset))
    keep = (q, k, v, g, kb, lse, delta)  # alive while launchers are
    # the stream current at each launch (a CUDA graph's capture stream)
    stream = lambda: torch.cuda.current_stream(q.device).cuda_stream

    def launch_dkv():
        err = lib.flash_bwd_dkv_bf16(
            *common, dk.data_ptr(), dv.data_ptr(), *dims, plan["dkv_block"],
            *tail, stream())
        check(lib, err, "flash_bwd_dkv")
        FLASH_BWD_DKV.add()
        return keep

    def launch_dq():
        err = lib.flash_bwd_dq_bf16(
            *common, dq.data_ptr(), *dims, plan["dq_block"], *tail, stream())
        check(lib, err, "flash_bwd_dq")
        FLASH_BWD_DQ.add()
        return keep

    return (dq, dk, dv), launch_dkv, launch_dq


def _flash_backward_cuda(*args):
    grads, launch_dkv, launch_dq = _flash_bwd_launchers(*args)
    launch_dkv()
    launch_dq()
    return grads


def flash_backward(q, k, v, key_bias, seed, out, lse, g, causal=False,
                   causal_offset=None, scale=None, dropout_p=0.0,
                   heads_total=0, head_offset=0):
    """(dq, dk, dv) of the flash forward: the CUDA kernels for CUDA
    tensors, the plain version for CPU tensors (and nothing else for
    either); `heads_total` / `head_offset` as flash_forward's."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if causal_offset is None:
        causal_offset = k.shape[1] - q.shape[1]
    if q.is_cuda:
        return _flash_backward_cuda(q, k, v, key_bias, seed, out, lse, g,
                                    causal, causal_offset, scale,
                                    float(dropout_p), heads_total,
                                    head_offset)
    return flash_backward_reference(q, k, v, key_bias, seed, out, lse, g,
                                    causal, causal_offset, scale,
                                    float(dropout_p), heads_total,
                                    head_offset)


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with the kernels' own backward (the custom_vjp of
    paddle_tpu's `_flash_attention`): saves q, k, v, key bias, out, lse
    and the host seed; key bias and seed get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, seed, causal, causal_offset, scale,
                dropout_p, heads_total=0, head_offset=0):
        out, lse = flash_forward(q, k, v, key_bias, seed, causal,
                                 causal_offset, scale, dropout_p,
                                 heads_total, head_offset)
        ctx.save_for_backward(q, k, v, key_bias, out, lse)
        ctx.args = (seed, causal, causal_offset, scale, dropout_p,
                    heads_total, head_offset)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_bias, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, key_bias, ctx.args[0], out, lse,
                                    g, *ctx.args[1:])
        return dq, dk, dv, None, None, None, None, None, None, None, None


# -- shim, mask normalization, dispatcher ---------------------------------------

def flash_attention(q, k, v, key_bias=None, is_causal=False, scale=None,
                    dropout_p=0.0, dropout_seed=None, heads_total=0,
                    head_offset=0):
    """(B, S, H, D) flash attention (paddle_tpu `flash_attention`).

    key_bias: optional (B, Sk) additive bias applied to every query row
    (the kernel's form of a key-padding mask), treated as a constant.
    Any Sq/Sk is accepted: the kernels mask the ragged edges, so there is
    no padding of the inputs and no slicing of the output.
    Differentiable in q, k and v through the backward kernels.
    `heads_total` / `head_offset`: the heads' global indices in the
    dropout hash (a tensor-parallel rank's heads; flash_forward)."""
    if key_bias is not None:
        key_bias = key_bias.detach().to(torch.float32)
    seed = 0 if (dropout_p <= 0.0 or dropout_seed is None) \
        else int(dropout_seed)
    return FlashAttentionFunction.apply(
        q, k, v, key_bias, seed, is_causal, k.shape[1] - q.shape[1], scale,
        float(dropout_p), int(heads_total), int(head_offset))


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


def _flash_takes(dtypes, head_dim: int) -> bool:
    """Whether the flash kernels take q/k/v of these dtypes and head_dim:
    bf16 and a head_dim in _KERNEL_HEAD_DIMS (the port's form of
    paddle_tpu's `_flash_ok`, attention.py:828-841).  The reference's
    Sq, Sk >= 128 condition is left out: it is a TPU speed heuristic, not
    a limit of what the kernels compute."""
    return (all(d == torch.bfloat16 for d in dtypes)
            and head_dim in _KERNEL_HEAD_DIMS)


# -- sequence-parallel scopes ----------------------------------------------------

class SeqSplit(NamedTuple):
    """A sequence split: this thread's activations (B, S/size, ...) are
    tokens [rank S/size, (rank + 1) S/size) of each sequence, over the
    ranks of `mesh`'s `axis` (`group`).  `mode` routes attention: "ring",
    "ulysses" or "gather" (K/V gathered over the axis).  Dropout draws
    the whole sequence's mask and keeps the rank's tokens, and the fused
    FFN's dropout hash takes them by their global index
    (`nn.functional.dropout`, `fused_feedforward`)."""
    mode: str
    mesh: object
    axis: str
    group: object
    rank: int
    size: int


_SEQ_CTX = threading.local()  # per thread, like F.rng_scope


@contextlib.contextmanager
def sequence_split(mode, mesh, axis="sp"):
    """Enter the sequence split of `mesh`'s `axis` (SeqSplit) for this
    thread; yields it."""
    from ...parallel import mesh as mesh_lib

    old = getattr(_SEQ_CTX, "split", None)
    _SEQ_CTX.split = SeqSplit(mode, mesh, axis,
                              mesh_lib.axis_group(mesh, axis),
                              mesh_lib.axis_rank(mesh, axis),
                              int(mesh.shape[axis]))
    try:
        yield _SEQ_CTX.split
    finally:
        _SEQ_CTX.split = old


def seq_split() -> Optional[SeqSplit]:
    """The enclosing `sequence_split`, or None."""
    return getattr(_SEQ_CTX, "split", None)


def ring_attention_scope(mesh, axis="sp"):
    """Route the attention calls made inside through ring attention over
    `mesh`'s `axis` (parallel/ring_attention.py): q/k/v are then the
    rank's sequence shards.  Model code stays as it is: the layers reach
    it through `scaled_dot_product_attention`."""
    return sequence_split("ring", mesh, axis)


def ulysses_attention_scope(mesh, axis="sp"):
    """Route the attention calls made inside through Ulysses' all-to-all
    sequence parallelism (parallel/ulysses.py).  Key-padding masks are
    taken (each rank sees every key of its head group); attention dropout
    is not."""
    return sequence_split("ulysses", mesh, axis)


def gathered_kv_scope(mesh, axis="sp"):
    """Route the attention calls made inside through the sequence-split
    layout the reference leaves to GSPMD (a batch cut over `axis` with
    neither ring nor Ulysses): the rank's queries against K/V all-gathered
    over the axis, in the flash kernels with the causal offset of the
    rank's first query; the gather's backward sums dK / dV back to their
    owners.  Attention dropout is refused: the kernels' hash would index
    the rank's queries from 0."""
    return sequence_split("gather", mesh, axis)


def _seq_parallel(q, k, v, mask, is_causal, scale, dropout_p):
    """The attention of an active sequence-parallel scope (None without
    one), with the reference's refusals."""
    split = seq_split()
    if split is None:
        return None
    if split.mode == "ulysses":
        if dropout_p != 0.0:
            raise ValueError(
                "ulysses_attention_scope is active but attention dropout "
                "is not supported by the all-to-all path; set attention "
                "dropout to 0 or exit the scope.")
        key_mask = _mask_as_key_bias(mask, q.shape[0],
                                     k.shape[1] * split.size)
        if mask is not None and key_mask is None:
            raise ValueError(
                "ulysses_attention_scope supports key-padding masks "
                "(constant over query/head dims); got mask shape "
                f"{tuple(mask.shape)}")
        from ...parallel.ulysses import ulysses_attention_local

        return ulysses_attention_local(q, k, v, split.group, mask=key_mask,
                                       is_causal=is_causal, scale=scale)
    if split.mode == "ring":
        if mask is not None or dropout_p != 0.0:
            raise ValueError(
                "ring_attention_scope is active but this attention call "
                "cannot be ring-routed: attention masks and attention "
                "dropout are not supported by the ring path yet. Set "
                "attention dropout to 0 (and drop the mask) or exit the "
                "scope.")
        from ...parallel.ring_attention import ring_attention_local

        return ring_attention_local(q, k, v, split.group, is_causal, scale)
    if dropout_p != 0.0:
        raise NotImplementedError(
            "attention dropout over a sequence split without ring or "
            "Ulysses: the kernels' hash would draw the rank's queries as "
            "the first ones (ROADMAP queue 3)")
    from ...distributed import comm

    kf, vf = (comm.all_gather_diff(x.movedim(1, 0).contiguous(), split.group)
              .movedim(0, 1) for x in (k, v))
    profiler.stat_add("seq_parallel_gather_bytes",
                      2 * kf.numel() * kf.element_size())
    key_bias = _mask_as_key_bias(mask, q.shape[0], kf.shape[1])
    if mask is not None and key_bias is None:
        raise ValueError("a sequence split takes key-padding masks only; "
                         f"got mask shape {tuple(mask.shape)}")
    if key_bias is not None:
        key_bias = key_bias.detach()
    return FlashAttentionFunction.apply(
        q, kf, vf, key_bias, 0, is_causal,
        split.rank * q.shape[1], scale, 0.0, 0, 0)


def scaled_dot_product_attention(q, k, v, mask=None, is_causal=False,
                                 scale=None, dropout_p=0.0,
                                 dropout_seed=None, heads_total=0,
                                 head_offset=0):
    """Dispatcher, as paddle_tpu's (attention.py:1110-1161): inside
    `ulysses_attention_scope`, `ring_attention_scope` or
    `gathered_kv_scope` the sequence-parallel path of the scope (with the
    reference's refusals: the ring takes no mask and no attention
    dropout, Ulysses key-padding masks only and no dropout); else a key-padding
    mask (any form constant over query and head dims, bool or additive)
    or no mask runs in the flash kernels as a key bias (their plain
    versions for CPU tensors); any other mask (per query, per head, or a
    full (B, H, Sq, Sk) one), and a CUDA call the kernels do not take
    (`_flash_takes`: not bf16, or another head_dim), go to
    `dense_attention`, the counterpart of `_xla_attention`, as the
    reference computes them outside its Pallas kernel.  Each call sent
    there is counted as `attention_dispatch_dense`.  q/k/v: (batch, seq,
    heads, head_dim).  `heads_total` / `head_offset` place q's heads
    among a tensor-parallel model's (flash_forward): the dense path's
    dropout draws from a generator, not the hash, and refuses them."""
    seq = _seq_parallel(q, k, v, mask, is_causal, scale, dropout_p)
    if seq is not None:
        return seq
    key_bias = _mask_as_key_bias(mask, q.shape[0], k.shape[1])
    if (mask is not None and key_bias is None) or (
            q.is_cuda and not _flash_takes((q.dtype, k.dtype, v.dtype),
                                           q.shape[-1])):
        if dropout_p > 0.0 and (heads_total or head_offset):
            raise NotImplementedError(
                "dense attention's dropout draws from a generator: a "
                "tensor-parallel rank's heads need the flash kernels' hash "
                "(a key-padding mask or none, bf16, a kernel head_dim)")
        profiler.stat_add("attention_dispatch_dense")
        return dense_attention(q, k, v, mask=mask, is_causal=is_causal,
                               scale=scale, dropout_p=dropout_p,
                               dropout_seed=dropout_seed)
    return flash_attention(q, k, v, key_bias=key_bias, is_causal=is_causal,
                           scale=scale, dropout_p=dropout_p,
                           dropout_seed=dropout_seed,
                           heads_total=heads_total, head_offset=head_offset)


def dense_attention(q, k, v, mask=None, is_causal=False, scale=None,
                    dropout_p=0.0, dropout_seed=None):
    """(B, S, H, D) attention materializing the full score matrix with
    plain torch ops (counterpart of `_xla_attention`), differentiable
    through autograd.  The dispatcher sends it the masks the flash kernel
    cannot express; the tests also use it as the oracle.  Scores and
    softmax in f32, probabilities cast to v's dtype, then dropout: a keep
    mask drawn from a `torch.Generator` seeded with `dropout_seed` (0 when
    None; JAX draws from its PRNG key, so the two keep other bits), kept
    probabilities scaled by 1 / (1 - p)."""
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
    if dropout_p > 0.0:
        gen = torch.Generator(device=q.device)
        gen.manual_seed(0 if dropout_seed is None else int(dropout_seed))
        keep = torch.rand(probs.shape, generator=gen,
                          device=q.device) >= dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros_like(probs))
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# -- ragged paged attention (serving decode path) -------------------------------

def ragged_paged_reference(page_rows, lengths, q, k_pages, v_pages, qpos,
                           scale):
    """Plain PyTorch version of the ragged paged-attention kernel.

    page_rows (B, W) int; lengths (B,) int; q (B, T, H, D); k/v_pages
    (P, S, H, D); qpos (B, T) int -> (B, T, H, D) in q's dtype.  Page i of
    sequence b takes part only if i == 0 or i*S < lengths[b] (the
    kernel's skip rule, which keeps page 0 so a length-0 lane yields the
    uniform softmax over it); a key at kpos > qpos scores
    DEFAULT_MASK_VALUE.  Scores and softmax in f32; p is cast to v's
    dtype before the second product, as in the kernel."""
    b, t, h, d = q.shape
    s = k_pages.shape[1]
    w = page_rows.shape[1]
    rows = page_rows.long()
    k = k_pages[rows].reshape(b, w * s, h, d)          # (B, W*S, H, D)
    v = v_pages[rows].reshape(b, w * s, h, d)
    kpos = torch.arange(w * s, device=q.device)
    page = kpos // s
    included = (page[None, :] == 0) | (page[None, :] * s
                                       < lengths.long()[:, None])
    causal = kpos[None, None, :] <= qpos.long()[:, :, None]  # (B, T, W*S)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    sc = torch.where(causal[:, None], sc, DEFAULT_MASK_VALUE)
    sc = torch.where(included[:, None, None, :], sc, float("-inf"))
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return (acc / l.permute(0, 2, 1, 3)).to(q.dtype)


def dense_paged_attention(q, k_pages, v_pages, page_rows, lengths, qpos,
                          scale):
    """The dense arm of `paged_attention` (paddle_tpu's
    `_dense_paged_attention`, attention.py:1037-1058): gather every page
    of each row into a contiguous (B, W*S, H, D) view, and attend through
    `scaled_dot_product_attention` with an additive bias that masks keys
    at positions past each query's `qpos`.  That call takes the flash
    kernels where they take the inputs (a decode step's bias is a key
    bias), else `dense_attention`.  It agrees with the ragged kernel on
    every lane whose qpos < length."""
    b, t, h, d = q.shape
    p_, s = k_pages.shape[0], k_pages.shape[1]
    lmax = page_rows.shape[1] * s
    pos = torch.arange(lmax, device=q.device)
    gidx = page_rows.long()[:, pos // s] * s + pos % s      # (B, Lmax)
    k = k_pages.reshape(p_ * s, h, d)[gidx]
    v = v_pages.reshape(p_ * s, h, d)[gidx]
    bias = torch.where(pos[None, None, :] <= qpos.long()[:, :, None], 0.0,
                       DEFAULT_MASK_VALUE).to(torch.float32)
    return scaled_dot_product_attention(q, k, v, mask=bias[:, None, :, :],
                                        scale=scale)


_SMEM_LIMIT = 232_448       # shared-memory bytes an H100 block may use
_RAGGED_SPLIT_ROWS = 4      # query rows up to which the split path runs
_RAGGED_MAX_HEADS = 16      # heads (one warp each) of a split-path CTA
_RAGGED_MIN_RUN = 4         # row pages a split-path CTA takes at least
_RAGGED_SPLIT_STAGES = 2    # the split path's ring
_RAGGED_TILE = 64           # queries and keys of a tiled-path tile
_RAGGED_TILED_STAGES = 4    # the tiled path's ring: two a warpgroup


def _ragged_split_keys(s: int) -> int:
    """Keys a split-path stage holds (a compile-time count of the kernel):
    16 where the page size is a multiple of 16 (a page of 16 is one
    stage), else 8."""
    return 16 if s % 16 == 0 else 8


def _ragged_split_smem(d: int, hg: int, ks: int, pps: int) -> int:
    """Dynamic shared memory of a split-path CTA (csrc/ragged_paged.cu):
    two stages of K and V rows (ks keys of hg heads), their mbarriers and
    the run's page ids."""
    return _RAGGED_SPLIT_STAGES * (2 * ks * hg * d * 2 + 8) + 4 * pps


def _ragged_tiled_smem(d: int, w: int) -> int:
    """Dynamic shared memory of a tiled-path CTA (csrc/ragged_paged.cu's
    tiled::Tile): Q in flash_common.cuh's resident atoms (128 rows a
    64-column atom, 64 used), four stages of a 64-key K and V tile, the
    barriers, stage counts and the eight warps' qpos bounds, W page ids
    and 8 past them, and 1024 bytes to align the base."""
    natom, rowb = (2, 128) if d == 128 else (1, 2 * d)
    q = natom * 2 * _RAGGED_TILE * rowb
    ns = _RAGGED_TILED_STAGES
    ring = ns * 2 * _RAGGED_TILE * d * 2
    return q + ring + (ns + 1) * 8 + ns * 4 + 16 * 4 + (w + 8) * 4 + 1024


def _ragged_plan(b: int, t: int, h: int, d: int, s: int, w: int, sms: int):
    """The ragged kernel's launch plan, from shapes and the SM count alone
    (never `lengths` or `qpos`, which live on the card: reading them
    would cost a host sync every decode step).

    - "tiled" for more than _RAGGED_SPLIT_ROWS query rows when the page
      size divides 64 (a key tile is whole pages) and the row's page ids
      fit shared memory: one CTA per (64 queries, head, sequence), two
      warpgroups taking alternate 64-key tiles, wgmma.
    - "split" otherwise (the decode step, T = 1; other page sizes): one
      CTA per (run of `pages_per_split` row pages, query row, head group,
      sequence), `splits` runs cover the row.  Runs are four pages unless
      the row is longer than four pages per SM; they depend on W and the
      SM count only.  Heads go in groups of at most 16 (a warp each),
      fewer when two stages of a group's K and V would not fit.  With
      more than one run, the CTAs' (m, l, acc) go to an f32 workspace of
      `workspace` values that the merge kernel reads."""
    if (t > _RAGGED_SPLIT_ROWS and _RAGGED_TILE % s == 0
            and _ragged_tiled_smem(d, w) <= _SMEM_LIMIT):
        grid = (-(-t // _RAGGED_TILE), h, b)
        plan = dict(path="tiled", pages_per_split=w, splits=1,
                    keys_per_stage=_RAGGED_TILE, head_groups=h,
                    heads_per_group=1, threads=256,
                    smem=_ragged_tiled_smem(d, w), workspace=0)
    else:
        pps = max(_RAGGED_MIN_RUN, -(-w // sms))
        splits = -(-w // pps)
        ks = _ragged_split_keys(s)
        groups = -(-h // _RAGGED_MAX_HEADS)
        while _ragged_split_smem(d, -(-h // groups), ks, pps) > _SMEM_LIMIT \
                and groups < h:
            groups += 1
        hg = -(-h // groups)
        groups = -(-h // hg)
        grid = (splits * t, groups, b)
        plan = dict(path="split", pages_per_split=pps,
                    splits=splits, keys_per_stage=ks, head_groups=groups,
                    heads_per_group=hg, threads=32 * hg,
                    smem=_ragged_split_smem(d, hg, ks, pps),
                    workspace=b * splits * t * h * (d + 2) if splits > 1
                    else 0)
    plan.update(grid=grid, ctas=grid[0] * grid[1] * grid[2])
    return plan


def ragged_paged_split_reference(page_rows, lengths, q, k_pages, v_pages,
                                 qpos, scale, pages_per_split):
    """Plain emulation of the kernel's split path (the main path never
    calls it): each run of `pages_per_split` consecutive included pages of
    a lane gives its own (m, l, acc) in f32, p cast to v's dtype against
    the run's own max; the runs are merged in order, o = sum_r
    exp(m_r - M) acc_r / sum_r exp(m_r - M) l_r.  The same function as
    `ragged_paged_reference`, in another summation order."""
    b, t, h, d = q.shape
    s = k_pages.shape[1]
    w = page_rows.shape[1]
    out = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
    for bi in range(b):
        ln = int(lengths[bi])
        n_pages = max(1, min(-(-ln // s) if ln > 0 else 1, w))
        parts = []
        for p0 in range(0, n_pages, pages_per_split):
            pages = page_rows[bi, p0:min(p0 + pages_per_split, n_pages)].long()
            k = k_pages[pages].reshape(-1, h, d)
            v = v_pages[pages].reshape(-1, h, d)
            kpos = p0 * s + torch.arange(k.shape[0], device=q.device)
            sc = torch.einsum("qhd,khd->hqk", q[bi].float(), k.float()) * scale
            causal = kpos[None, :] <= qpos[bi].long()[:, None]  # (T, keys)
            sc = torch.where(causal[None], sc, DEFAULT_MASK_VALUE)
            m = sc.amax(dim=-1, keepdim=True)                   # (H, T, 1)
            p = torch.exp(sc - m)
            acc = torch.einsum("hqk,khd->qhd", p.to(v.dtype).float(),
                               v.float())
            parts.append((m[..., 0].T, p.sum(-1).T, acc))     # (T, H) ...
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        lsum = sum(torch.exp(m - mx) * l for m, l, _ in parts)
        acc = sum(torch.exp(m - mx)[..., None] * a for m, _, a in parts)
        out[bi] = acc / lsum[..., None]
    return out.to(q.dtype)


def _ragged_lib():
    lib = library("ragged_paged")
    fn = lib.ragged_paged_bf16
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 8 + [ci] * 7 + [ctypes.c_float] + [ci] * 5 + [vp]
        fn.restype = ci
    return lib


def _ragged_takes(dtypes, head_dim: int, page_size: int) -> bool:
    """Whether `csrc/ragged_paged.cu` takes q/k/v of these dtypes, this
    head_dim and page size: bf16, a head_dim in _KERNEL_HEAD_DIMS, and
    pages of a multiple of 8 rows (the rules `_ragged_paged_cuda` raises
    on; the port's form of paddle_tpu's per-shape `_probe_ragged`)."""
    return (all(dt == torch.bfloat16 for dt in dtypes)
            and head_dim in _KERNEL_HEAD_DIMS and page_size % 8 == 0)


def _ragged_paged_cuda(page_rows, lengths, q, k_pages, v_pages, qpos,
                       scale):
    b, t, h, d = q.shape
    p, s = k_pages.shape[0], k_pages.shape[1]
    w = page_rows.shape[1]
    if not (q.dtype == k_pages.dtype == v_pages.dtype == torch.bfloat16):
        raise NotImplementedError(
            f"ragged_paged kernel takes bf16 q/k/v, got {q.dtype}/"
            f"{k_pages.dtype}/{v_pages.dtype}")
    if d not in _KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"ragged_paged kernel takes head_dim in {_KERNEL_HEAD_DIMS}, "
            f"got {d}")
    if s % 8:
        raise NotImplementedError(
            f"ragged_paged kernel takes a page_size that is a multiple of "
            f"8, got {s}")
    if (k_pages.shape != (p, s, h, d) or v_pages.shape != k_pages.shape
            or page_rows.shape != (b, w) or lengths.shape != (b,)
            or qpos.shape != (b, t)):
        raise ValueError(
            f"paged attention shapes do not match: q {tuple(q.shape)}, "
            f"pools {tuple(k_pages.shape)}/{tuple(v_pages.shape)}, "
            f"page_rows {tuple(page_rows.shape)}, lengths "
            f"{tuple(lengths.shape)}, qpos {tuple(qpos.shape)}")
    plan = _ragged_plan(b, t, h, d, s, w, _sm_count(q.device.index or 0))
    gx, gy, gz = plan["grid"]
    if t < 1 or w < 1 or gy > 65535 or gz > 65535 or gx >= 2 ** 31 \
            or plan["smem"] > _SMEM_LIMIT:
        raise ValueError(f"ragged_paged kernel cannot take T={t}, W={w}, "
                         f"H={h}, B={b}: plan {plan}")
    # the kernels read q, the pools and the int operands densely; a
    # layer's plane kc[li] of a contiguous multi-layer pool is contiguous
    q = q.contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    if q.data_ptr() % 16 or k_pages.data_ptr() % 16 \
            or v_pages.data_ptr() % 16:
        raise ValueError("ragged_paged kernel needs 16-byte aligned q and "
                         "pools")
    rows, lens, qp = (x.to(torch.int32).contiguous()
                      for x in (page_rows, lengths, qpos))
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    ws = torch.empty(plan["workspace"], dtype=torch.float32,
                     device=q.device) if plan["workspace"] else None
    lib = _ragged_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.ragged_paged_bf16(
        rows.data_ptr(), lens.data_ptr(), q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), qp.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), b, t, h, d, p, s, w,
        float(scale), int(plan["path"] == "tiled"), plan["pages_per_split"],
        plan["splits"], plan["heads_per_group"], plan["keys_per_stage"],
        stream)
    check(lib, err, "ragged_paged")
    RAGGED_PAGED.add()
    return out


def ragged_paged_forward(page_rows, lengths, q, k_pages, v_pages, qpos,
                         scale):
    """The ragged kernel's function: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors (and nothing else for either)."""
    if q.is_cuda:
        return _ragged_paged_cuda(page_rows, lengths, q, k_pages, v_pages,
                                  qpos, scale)
    return ragged_paged_reference(page_rows, lengths, q, k_pages, v_pages,
                                  qpos, scale)


def paged_attention(q, k_pages, v_pages, page_rows, lengths, scale=None,
                    q_positions=None):
    """Attention over PAGED keys/values (serving decode path).

    q: (B, T, H, D), the T newest query positions per sequence (decode:
    T == 1; chunked prefill: T == chunk bucket); k_pages/v_pages:
    (P, S, H, D) page pools (serving/kv_cache.py); page_rows: (B,
    max_pages) int page ids per sequence (unused entries -> scratch page
    0); lengths: (B,) int, the valid key count per sequence.

    Masking: query j of sequence b attends keys at positions <=
    q_positions[b, j].  The default q_positions places the T queries at
    the newest T positions (lengths - T .. lengths - 1); chunked prefill
    passes its chunk's absolute positions.  Query lanes whose position is
    >= lengths (chunk padding) produce finite but unspecified output;
    callers slice them away.

    Dispatch, as the reference's (attention.py:1094-1106):
    `csrc/ragged_paged.cu` for CUDA tensors it takes (`_ragged_takes`; its
    split path at decode steps, its tiled path at chunks, as `_ragged_plan`
    chooses by shape), which reads `page_rows` inside the kernel (no
    (B, W*S) gather is ever built); CUDA tensors it does not take go to the
    dense arm, `dense_paged_attention`, each call counted as
    `serving_ragged_fallback_total`; CPU tensors take the kernel's plain
    version."""
    t, d = q.shape[1], q.shape[3]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if q_positions is None:
        q_positions = lengths.long()[:, None] - t \
            + torch.arange(t, device=q.device)[None, :]
    if q.is_cuda and not _ragged_takes((q.dtype, k_pages.dtype,
                                        v_pages.dtype), d,
                                       k_pages.shape[1]):
        profiler.stat_add("serving_ragged_fallback_total")
        return dense_paged_attention(q, k_pages, v_pages, page_rows,
                                     lengths, q_positions, float(scale))
    return ragged_paged_forward(page_rows, lengths, q, k_pages, v_pages,
                                q_positions, float(scale))
