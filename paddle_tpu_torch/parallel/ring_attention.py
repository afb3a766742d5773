"""Ring attention: sequence parallelism over a mesh axis (counterpart of
paddle_tpu/parallel/ring_attention.py).

The sequence dim is split over the ranks of the axis; K/V blocks go round
the ring (`comm.ring_shift`: to rank + 1, from rank - 1, one
`batch_isend_irecv` a step) and each rank attends its queries against
every visiting block, so that a rank holds S/n of the activations and
computes whole-sequence attention.

The reference computes each block pair in plain `jnp` (`_block_attn`)
and merges them by an online softmax (`_combine`).  Here each visiting
block goes through the flash kernels' wrapper `flash_forward` (the CUDA
kernel of csrc/flash_fwd.cu on the card, its plain version on the CPU),
which returns the block's normalised output and its log-sum-exp; blocks
merge by their LSE, the same online softmax.  Under a causal mask a
block from an earlier rank is attended whole, the rank's own block
through the kernel's causal mode (offset 0) and a later rank's block is
skipped, not launched.

The backward (`RingAttentionFunction`) runs `flash_backward` on each
block against the FINAL output and LSE (the block's share of the global
softmax): dQ accumulates on the rank, dK / dV travel round the ring with
their block and reach its owner after the last step.
"""

from __future__ import annotations

import torch

from .. import profiler

__all__ = ["ring_attention", "ring_attention_local",
           "RingAttentionFunction", "merge_blocks"]


def _blocks(n: int, rank: int, is_causal: bool):
    """(step, source rank, causal) of each visiting block the rank
    attends: every block, or under a causal mask the earlier ranks'
    whole and its own causal."""
    for i in range(n):
        src = (rank - i) % n
        if not is_causal or src < rank:
            yield i, src, False
        elif src == rank:
            yield i, src, True


def merge_blocks(acc, lse, o, l):
    """The online softmax of two blocks' attention (the reference's
    `_combine`) from their normalised outputs and log-sum-exps: acc
    (B, Sq, H, D) f32 and lse (B, H, Sq) so far (None for none), o and l
    the next block's.  Returns the merged (acc, lse)."""
    if acc is None:
        return o.float(), l
    new = torch.logaddexp(lse, l)
    a1 = torch.exp(lse - new).permute(0, 2, 1)[..., None]
    a2 = torch.exp(l - new).permute(0, 2, 1)[..., None]
    return acc * a1 + o.float() * a2, new


def _count(nbytes: int) -> None:
    profiler.stat_add("seq_parallel_ring_bytes", int(nbytes))


class RingAttentionFunction(torch.autograd.Function):
    """q, k, v: this rank's (B, S/n, H, D) shards of the sequence over
    `group`; returns this rank's (B, S/n, H, D) output."""

    @staticmethod
    def forward(ctx, q, k, v, group, is_causal, scale):
        from ..distributed import comm
        from ..ops.kernels.attention import flash_forward

        n, rank = comm.world(group), comm.rank(group)
        d = q.shape[-1]
        scale = float(scale) if scale is not None else 1.0 / (d ** 0.5)
        kv = torch.stack([k, v])
        todo = {i: causal for i, _, causal in _blocks(n, rank, is_causal)}
        acc, lse = None, None
        for i in range(n):
            if i in todo:
                o, l = flash_forward(q, kv[0], kv[1], None, 0, todo[i], 0,
                                     scale, 0.0)
                acc, lse = merge_blocks(acc, lse, o, l)
            if i < n - 1:
                _count(kv.numel() * kv.element_size())
                kv = comm.ring_shift(kv, group)
        out = acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, bool(is_causal), scale)
        return out

    @staticmethod
    def backward(ctx, g):
        from ..distributed import comm
        from ..ops.kernels.attention import flash_backward

        q, k, v, out, lse = ctx.saved_tensors
        group, is_causal, scale = ctx.args
        n, rank = comm.world(group), comm.rank(group)
        g = g.contiguous()
        todo = {i: causal for i, _, causal in _blocks(n, rank, is_causal)}
        kv = torch.stack([k, v])
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        # this block's dK and dV, summed over the ranks it has visited
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        for i in range(n):
            if i in todo:
                dqi, dki, dvi = flash_backward(q, kv[0], kv[1], None, 0, out,
                                               lse, g, todo[i], 0, scale,
                                               0.0)
                dq += dqi.float()
                dkv[0] += dki.float()
                dkv[1] += dvi.float()
            if i < n - 1:
                _count(kv.numel() * kv.element_size())
                kv = comm.ring_shift(kv, group)
            # with its block; after the last step, to the block's owner
            _count(dkv.numel() * dkv.element_size())
            dkv = comm.ring_shift(dkv, group)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None)


def ring_attention_local(q, k, v, group=None, is_causal=False, scale=None):
    """The per-rank body: q/k/v are this rank's (B, S/n, H, D) sequence
    shards over `group` (None: the world); returns its (B, S/n, H, D)
    output, differentiable in q, k and v.  Whole-sequence attention
    semantics, causal by global position when `is_causal`."""
    return RingAttentionFunction.apply(q, k, v, group, bool(is_causal),
                                       scale)


def ring_attention(mesh, axis="sp"):
    """-> attn(q, k, v, is_causal=False, scale=None) over the ranks of
    `mesh`'s `axis`: q/k/v are this rank's shards of the sequence (the
    reference's callable takes the global arrays and shards them itself;
    a rank here holds only its own)."""
    from . import mesh as mesh_lib

    group = mesh_lib.axis_group(mesh, axis)

    def call(q, k, v, is_causal=False, scale=None):
        return ring_attention_local(q, k, v, group, is_causal, scale)

    return call
