"""The layout-probe kernels (counterparts of tools/kernel4d_probe.py).

Three wrappers of the hand-written CUDA kernels of `csrc/probe4d.cu`, one
per layout of the same function, per-head one-shot softmax attention
with no mask (kernel4d_probe.py:43-56):

- `probe_4d(q, k, v)` on (B, S, H, D), read in place by strides (q/k/v
  may be views of a packed (B, S, 3, H, D) projection); replaces `build`;
- `probe_fold3d(q, k, v, num_heads)` on (B, S, H*D), head h at lanes
  h*D .. h*D + D - 1; replaces `build_fold3d`;
- `probe_merged(q, k, v)` on pre-merged (B*H, S, D); replaces `main`'s
  `kernel3`.

On a CUDA tensor each launches its kernel or raises; on a CPU tensor it
runs its plain PyTorch version (`probe_*_reference`), which computes the
same function.  Unlike `flash_forward`, the probe normalises before the
bf16 cast: P = bf16(exp(s - m) / l), then O = bf16(P V).  The wrappers
copy and transpose nothing: reading each layout as it lies is what the
probe measures.
"""

from __future__ import annotations

import ctypes

import torch

from .build import LaunchCounter, check, library

PROBE_4D = LaunchCounter("probe_4d")
PROBE_FOLD3D = LaunchCounter("probe_fold3d")
PROBE_MERGED = LaunchCounter("probe_merged")

# the kernel holds the whole 64 x S f32 score block in shared memory
MAX_SEQ = 768
_HEAD_DIMS = (16, 32, 64, 128)


# -- plain PyTorch versions -----------------------------------------------------

def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B*H, S, D), a copy."""
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d)


def unmerge_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B*H, S, D) -> (B, S, H, D), a view."""
    bh, s, d = x.shape
    return x.view(bh // num_heads, num_heads, s, d).permute(0, 2, 1, 3)


def probe_merged_reference(q, k, v):
    """Plain version of the probe on (B*H, S, D): scores and softmax in
    f32, P normalised and cast to v's dtype, P V accumulated in f32 and
    cast to q's dtype once."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.bmm(q.float(), k.float().transpose(1, 2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return torch.bmm((p / l).to(v.dtype).float(), v.float()).to(q.dtype)


def probe_4d_reference(q, k, v):
    """Plain version of the probe on (B, S, H, D).  It runs the merged
    version's arithmetic on the merged operands, so the three plain
    versions agree bit for bit."""
    out = probe_merged_reference(merge_heads(q), merge_heads(k),
                                 merge_heads(v))
    return unmerge_heads(out, q.shape[2]).contiguous()


def probe_fold3d_reference(q, k, v, num_heads):
    """Plain version of the probe on (B, S, H*D)."""
    b, s, hd = q.shape
    split = lambda x: x.reshape(x.shape[0], x.shape[1], num_heads, -1)
    return probe_4d_reference(split(q), split(k), split(v)).reshape(b, s, hd)


# -- the CUDA kernels' wrappers -------------------------------------------------

def _lib():
    lib = library("probe4d")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    strides = ctypes.POINTER(ctypes.c_longlong)
    for fn in (lib.probe_4d_bf16, lib.probe_fold3d_bf16):
        if fn.argtypes is None:
            fn.argtypes = [vp] * 4 + [ci] * 4 + [strides, ctypes.c_float, vp]
            fn.restype = ci
    fn = lib.probe_merged_bf16
    if fn.argtypes is None:
        fn.argtypes = [vp] * 4 + [ci] * 3 + [strides, ctypes.c_float, vp]
        fn.restype = ci
    return lib


def _check(name, q, k, v, s, d, heads):
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise NotImplementedError(
            f"{name} kernel takes bf16 q/k/v, got {q.dtype}/{k.dtype}/"
            f"{v.dtype}")
    if d not in _HEAD_DIMS:
        raise NotImplementedError(
            f"{name} kernel takes head_dim in {_HEAD_DIMS}, got {d}")
    if not 1 <= s <= MAX_SEQ:
        raise NotImplementedError(
            f"{name} kernel takes 1 <= S <= {MAX_SEQ} (the whole score row "
            f"block sits in shared memory), got S={s}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / "
                         f"v {tuple(v.shape)} do not match")
    if heads > 65535:
        raise ValueError(f"{name} kernel needs B*H <= 65535, got {heads}")
    for t in (q, k, v):
        # rows of 16 bytes: last dim contiguous, other strides multiples
        # of 8 elements, base 16-byte aligned
        if (t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1])
                or t.data_ptr() % 16):
            raise ValueError(
                f"{name} kernel reads rows of 16 bytes in place: needs a "
                f"contiguous last dim, strides {tuple(t.stride())} in "
                "multiples of 8 and a 16-byte aligned base")


def _launch(name, counter, fn, q, k, v, out, dims, strides, d):
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, fn)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *dims,
        (ctypes.c_longlong * len(strides))(*strides), float(1.0 / d ** 0.5),
        stream)
    check(lib, err, name)
    counter.add()
    return out


def _probe_4d_cuda(q, k, v):
    b, s, h, d = q.shape
    _check("probe_4d", q, k, v, s, d, b * h)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    strides = [st for t in (q, k, v) for st in t.stride()[:3]]
    return _launch("probe_4d", PROBE_4D, "probe_4d_bf16", q, k, v, out,
                   (b, s, h, d), strides, d)


def _probe_fold3d_cuda(q, k, v, num_heads):
    b, s, hd = q.shape
    if num_heads < 1 or hd % num_heads:
        raise ValueError(f"H*D={hd} is not a multiple of num_heads="
                         f"{num_heads}")
    d = hd // num_heads
    _check("probe_fold3d", q, k, v, s, d, b * num_heads)
    out = torch.empty((b, s, hd), dtype=q.dtype, device=q.device)
    strides = [st for t in (q, k, v) for st in t.stride()[:2]]
    return _launch("probe_fold3d", PROBE_FOLD3D, "probe_fold3d_bf16", q, k,
                   v, out, (b, s, num_heads, d), strides, d)


def _probe_merged_cuda(q, k, v):
    bh, s, d = q.shape
    _check("probe_merged", q, k, v, s, d, bh)
    out = torch.empty((bh, s, d), dtype=q.dtype, device=q.device)
    strides = [st for t in (q, k, v) for st in t.stride()[:2]]
    return _launch("probe_merged", PROBE_MERGED, "probe_merged_bf16", q, k,
                   v, out, (bh, s, d), strides, d)


def probe_4d(q, k, v):
    """The probe on (B, S, H, D): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors (and nothing else for either)."""
    if q.is_cuda:
        return _probe_4d_cuda(q, k, v)
    return probe_4d_reference(q, k, v)


def probe_fold3d(q, k, v, num_heads):
    """The probe on (B, S, H*D): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors (and nothing else for either)."""
    if q.is_cuda:
        return _probe_fold3d_cuda(q, k, v, num_heads)
    return probe_fold3d_reference(q, k, v, num_heads)


def probe_merged(q, k, v):
    """The probe on (B*H, S, D): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors (and nothing else for either)."""
    if q.is_cuda:
        return _probe_merged_cuda(q, k, v)
    return probe_merged_reference(q, k, v)
