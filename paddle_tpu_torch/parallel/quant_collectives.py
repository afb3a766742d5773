"""Int8 blockwise quantized collectives over a `torch.distributed` group
(counterpart of paddle_tpu/parallel/quant_collectives.py).

Opt-in wire compression for the gradient all-reduces: int8 codes plus a
small fp32 scale sidecar cross the group instead of full-width fp32 /
bf16 payloads (EQuARX, arXiv 2506.17615).

Scheme, the reference's
-----------------------
The flat payload is zero-padded and reshaped into blocks of ``BLOCK``
elements (fewer for a payload smaller than a block).  Each block carries
one fp32 absmax scale; codes are ``round(x / scale)`` clipped to
[-127, 127] with round-half-even (`torch.round`, as `jnp.round`), so a
block's codes are the reference's bit for bit.  The sum runs in fp32,
and a value is quantized once a phase:

  all-reduce     = all_to_all(quantized chunks) -> fp32 sum of dequant
                   -> requantize the partial -> all_gather -> dequant
  reduce-scatter = all_to_all(quantized chunks) -> fp32 sum of dequant
  all-gather     = quantize the local shard -> all_gather codes + scales
                   -> dequant

Gating
------
``mode()`` reads ``PADDLE_QUANT_COLLECTIVES`` at each call, then
``FLAGS_quant_collectives``; payloads below ``min_bytes()`` stay full
width.  The callers: the `c_allreduce_sum` / `mp_allreduce_sum` /
`c_reducescatter` / `c_allgather` rules (ops/collective_ops.py) and the
compiler's SPMD arm (parameter gradients over the batch axes).
"""

from __future__ import annotations

import os

import torch

__all__ = [
    "BLOCK",
    "parse_mode",
    "mode",
    "min_bytes",
    "signature_token",
    "pack",
    "quantize_blockwise",
    "dequantize_blockwise",
    "wire_bytes",
    "quant_allreduce_sum",
    "quant_reducescatter",
    "quant_allgather",
]

# elements a quantization block; one fp32 scale a block is a sidecar of
# 4 / BLOCK bytes an element (~1.6 % at 256)
BLOCK = 256

_QMAX = 127.0

_ENV = "PADDLE_QUANT_COLLECTIVES"
_ENV_MIN_BYTES = "PADDLE_QUANT_COLLECTIVES_MIN_BYTES"


def parse_mode(value) -> str:
    """A flag or environment string as 'off' | 'int8'."""
    v = str(value or "").strip().lower()
    if v in ("int8", "1", "on", "true"):
        return "int8"
    return "off"


def mode() -> str:
    """The quantized-collective mode ('off' | 'int8'): the environment,
    read at each call, else the flag."""
    env = os.environ.get(_ENV)
    if env is not None:
        return parse_mode(env)
    from ..fluid import flags

    return parse_mode(flags.flag("quant_collectives", "off"))


def min_bytes() -> int:
    """A payload's floor: smaller ones stay full width."""
    env = os.environ.get(_ENV_MIN_BYTES)
    if env is not None:
        try:
            return max(0, int(env))
        except ValueError:
            pass
    from ..fluid import flags

    return max(0, int(flags.flag("quant_collectives_min_bytes", 1024)))


def signature_token():
    """The reference's compile-cache token of the mode (None when off).
    The port keeps no compile cache, so nothing is keyed by it; it is
    kept so that the two packages name the same functions."""
    m = mode()
    if m == "off":
        return None
    return "quant_collectives=%s,min=%d" % (m, min_bytes())


# -- the blockwise codec --------------------------------------------------------

def _chunk_layout(chunk, block):
    """(block size, blocks) of a payload of `chunk` elements: the block
    shrinks to the payload when it is smaller, so a tiny tensor is never
    padded out to a whole block (which would cost more wire than full
    width)."""
    chunk = max(1, int(chunk))
    be = min(int(block), chunk)
    return be, -(-chunk // be)


def pack(x, block=BLOCK) -> torch.Tensor:
    """x flattened to fp32 and zero-padded to (blocks, block size)."""
    flat = x.reshape(-1).to(torch.float32)
    be, nblocks = _chunk_layout(flat.numel(), block)
    pad = nblocks * be - flat.numel()
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(nblocks, be)


def quantize_blockwise(blocks: torch.Tensor):
    """(..., B) fp32 -> ((..., B) int8 codes, (...) fp32 absmax scales).
    A zero block gets scale 0 and codes 0 (the divide uses 1 there, so
    no inf or nan reaches the wire).  The scale and the codes are true
    divisions, as the reference's (a CUDA tensor divided by a Python
    number is multiplied by its reciprocal, so the divisor is a 0-d
    tensor)."""
    qmax = torch.tensor(_QMAX, dtype=torch.float32, device=blocks.device)
    absmax = blocks.abs().amax(dim=-1)
    scales = absmax / qmax
    safe = torch.where(scales > 0.0, scales, torch.ones_like(scales))
    q = torch.clamp(torch.round(blocks / safe[..., None]), -_QMAX, _QMAX)
    return q.to(torch.int8), scales.to(torch.float32)


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor):
    """The inverse of quantize_blockwise, in fp32."""
    return q.to(torch.float32) * scales[..., None]


def wire_bytes(x, block=BLOCK, axis_size=None) -> int:
    """The wire payload of a quantized transfer of x: int8 codes plus the
    fp32 scales, counted once a logical collective (as the full-width
    count is).  With `axis_size` the payload is cut into a chunk a peer
    first (the all-reduce / reduce-scatter layout), with its padding."""
    size = 1
    for d in x.shape:
        size *= int(d)
    if axis_size:
        n = int(axis_size)
        be, cb = _chunk_layout(-(-size // n) if size else 1, block)
        return n * cb * be * 1 + n * cb * 4
    be, nblocks = _chunk_layout(size, block)
    return nblocks * be * 1 + nblocks * 4


# -- the collectives ---------------------------------------------------------------

def _exchange(blocks, group):
    """Phase 1 of the all-reduce and the reduce-scatter: the (n, cb, B)
    blocks quantized, chunk r to rank r (codes and scales by all_to_all),
    the chunks received dequantized and summed in fp32: (cb, B)."""
    from ..distributed import comm

    q, s = quantize_blockwise(blocks)
    q2 = comm.all_to_all(q, group)
    s2 = comm.all_to_all(s, group)
    return dequantize_blockwise(q2, s2).sum(dim=0)


def quant_allreduce_sum(x: torch.Tensor, group=None,
                        block=BLOCK) -> torch.Tensor:
    """The two-phase quantized all-reduce-sum over `group`: each rank
    quantizes its payload and exchanges chunk r with rank r (a
    reduce-scatter of quantized blocks), sums the dequantized chunks in
    fp32, requantizes its partial once, and an all-gather of codes and
    scales rebuilds the whole.  The error enters twice, never a hop."""
    from ..distributed import comm

    n = comm.world(group)
    size = x.numel()
    flat = x.reshape(-1).to(torch.float32)
    be, cb = _chunk_layout(-(-size // n) if size else 1, block)
    padded = n * cb * be
    if padded != size:
        flat = torch.nn.functional.pad(flat, (0, padded - size))
    partial = _exchange(flat.reshape(n, cb, be), group)
    qr, sr = quantize_blockwise(partial)
    qg = comm.all_gather(qr, group)  # (n * cb, B)
    sg = comm.all_gather(sr, group)  # (n * cb,)
    out = dequantize_blockwise(qg, sg).reshape(-1)[:size]
    return out.reshape(x.shape).to(x.dtype)


def quant_reducescatter(x: torch.Tensor, group=None,
                        block=BLOCK) -> torch.Tensor:
    """The quantized reduce-scatter over dim 0 (its rows must split over
    the group): the codes cross once, the sum stays in fp32."""
    from ..distributed import comm

    n = comm.world(group)
    rows = x.shape[0]
    if rows % n:
        raise ValueError(f"quant_reducescatter: leading dim {rows} not "
                         f"divisible by the group's {n} ranks")
    out_shape = (rows // n,) + tuple(x.shape[1:])
    # the chunks align with the scatter: (n, per chunk), then each padded
    per = x.to(torch.float32).reshape(n, -1)
    chunk = per.shape[1]
    be, cb = _chunk_layout(chunk, block)
    if cb * be != chunk:
        per = torch.nn.functional.pad(per, (0, cb * be - chunk))
    partial = _exchange(per.reshape(n, cb, be), group)
    return partial.reshape(-1)[:chunk].reshape(out_shape).to(x.dtype)


def quant_allgather(x: torch.Tensor, group=None,
                    block=BLOCK) -> torch.Tensor:
    """The quantized all-gather: every rank's x along dim 0, in rank
    order."""
    from ..distributed import comm

    n = comm.world(group)
    q, s = quantize_blockwise(pack(x, block))
    qg = comm.all_gather(q, group)  # (n * nb, B)
    sg = comm.all_gather(s, group)
    vals = dequantize_blockwise(qg, sg).reshape(n, -1)[:, :x.numel()]
    return vals.reshape((n * x.shape[0],) + tuple(x.shape[1:])).to(x.dtype)
