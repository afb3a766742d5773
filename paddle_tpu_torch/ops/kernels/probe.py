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

On a CUDA tensor each launches the kernel or raises; on a CPU tensor it
runs its plain PyTorch version (`probe_*_reference`), which computes the
same function.  Unlike `flash_forward`, the probe normalises before the
bf16 cast: P = bf16(exp(s - m) / l), then O = bf16(P V).  The wrappers
copy and transpose nothing: reading each layout as it lies is what the
probe measures.  The three share one kernel body; each wrapper hands it
its operands' strides, and `_probe_plan` sizes the launch.
"""

from __future__ import annotations

import ctypes

import torch

from .build import LaunchCounter, check, library, sm_count as _sm_count

PROBE_4D = LaunchCounter("probe_4d")
PROBE_FOLD3D = LaunchCounter("probe_fold3d")
PROBE_MERGED = LaunchCounter("probe_merged")

_HEAD_DIMS = (16, 32, 64, 128)
_BLOCK_M = 64  # query rows of a warpgroup; keys of a streamed tile
_STAGES = 4    # the kernel's ring of K and V tiles (PST in probe4d.cu)
# an H100 SM's shared memory, and what the card keeps of it for each CTA
_SMEM_PER_SM, _SMEM_PER_CTA = 233472, 1024


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


# -- the launch plan --------------------------------------------------------------

def _probe_smem(d: int) -> int:
    """Dynamic shared memory of a CTA at head dim d (`Tile<D>::BYTES` in
    probe4d.cu): 128 resident Q rows (256 d bytes), _STAGES stages of a
    64-key K tile and a V tile (256 d bytes in all), their mbarriers and
    release counts, and 1024 bytes to align the swizzled tiles."""
    return 256 * d + _STAGES * 256 * d + (_STAGES + 1) * 8 + _STAGES * 4 \
        + 1024


def _probe_plan(b: int, h: int, s: int, d: int, sms: int):
    """(block_q, grid, smem bytes) of the probe kernel: a CTA holds one
    or two warpgroups of 64 queries each (block_q 64 or 128) that share
    each K/V tile; its grid is (query tiles, batch*head), and it reads
    the keys twice (statistics, then P V), whatever S is.  128 is taken
    unless S fits one warpgroup, or 128-query CTAs leave the card with
    less than one wave of `sms` CTAs while the 64-query CTAs fit one wave
    of what an SM holds, where 64 spreads the same rows over twice the
    CTAs.  An SM holds as many CTAs as its shared memory allows, at most
    4 (the kernel's registers); at head dim 128 that is one, so there 64
    would not spread the work but run it one warpgroup an SM."""
    bh = b * h
    smem = _probe_smem(d)
    per_sm = min(4, _SMEM_PER_SM // (smem + _SMEM_PER_CTA))
    few = -(-s // (2 * _BLOCK_M)) * bh < sms
    fits = -(-s // _BLOCK_M) * bh <= sms * per_sm
    block_q = _BLOCK_M if s <= _BLOCK_M or (few and fits) else 2 * _BLOCK_M
    return block_q, (-(-s // block_q), bh), smem


# -- the CUDA kernels' wrappers -------------------------------------------------

def _lib():
    lib = library("probe4d")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    tail = [ctypes.POINTER(ctypes.c_longlong), ci, ctypes.c_longlong,
            ctypes.c_float, vp]
    for fn, dims in ((lib.probe_4d_bf16, 4), (lib.probe_fold3d_bf16, 4),
                     (lib.probe_merged_bf16, 3)):
        if fn.argtypes is None:
            fn.argtypes = [vp] * 4 + [ci] * dims + tail
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
    if s < 1:
        raise ValueError(f"{name} kernel needs S >= 1, got S={s}")
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


def _launch(name, counter, fn, q, k, v, out, dims, strides, b, h, s, d):
    block_q, _, smem = _probe_plan(b, h, s, d, _sm_count(q.device.index or 0))
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, fn)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *dims,
        (ctypes.c_longlong * len(strides))(*strides), block_q, smem,
        float(1.0 / d ** 0.5), stream)
    check(lib, err, name)
    counter.add()
    return out


def _probe_4d_cuda(q, k, v):
    b, s, h, d = q.shape
    _check("probe_4d", q, k, v, s, d, b * h)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    strides = [st for t in (q, k, v) for st in t.stride()[:3]]
    return _launch("probe_4d", PROBE_4D, "probe_4d_bf16", q, k, v, out,
                   (b, s, h, d), strides, b, h, s, d)


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
                   v, out, (b, s, num_heads, d), strides, b, num_heads, s, d)


def _probe_merged_cuda(q, k, v):
    bh, s, d = q.shape
    _check("probe_merged", q, k, v, s, d, bh)
    out = torch.empty((bh, s, d), dtype=q.dtype, device=q.device)
    strides = [st for t in (q, k, v) for st in t.stride()[:2]]
    return _launch("probe_merged", PROBE_MERGED, "probe_merged_bf16", q, k,
                   v, out, (bh, s, d), strides, bh, 1, s, d)


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
