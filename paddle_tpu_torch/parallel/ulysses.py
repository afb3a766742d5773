"""Ulysses sequence parallelism: all-to-all context sharding (counterpart
of paddle_tpu/parallel/ulysses.py; DeepSpeed-Ulysses, Jacobs et al.
2023).

Activations live sequence-split (B, S/n, H, D) over the axis; for
attention one tiled all-to-all re-splits the heads instead,
(B, S/n, H, D) -> (B, S, H/n, D), so each rank computes whole-sequence
attention for its head group, and a second all-to-all turns the output
back to sequence shards.  It needs the heads to divide by the axis's
size (ring attention does not).

The reference's head-group attention is plain `jnp` (`_full_attention`);
here it is the port's `flash_attention` (the kernels of
csrc/flash_fwd.cu and csrc/flash_bwd.cu on the card, their plain
versions on the CPU), with the key bias of the whole (replicated) mask.
A row whose keys are all masked (a False of a bool mask, or -inf of an
additive one, on every key the row may see) gives zeros, as the
reference's does.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import profiler

__all__ = ["ulysses_attention", "ulysses_attention_local"]


def _key_bias(mask, is_causal, b, s):
    """((B, S) f32 key bias for the kernels, (B, S) bool of the rows that
    see at least one key) from a (B, S) keep-mask (bool) or additive key
    bias (float), or (None, None): the dispatcher's `_mask_as_key_bias`,
    with -inf raised to the kernels' finite mask value."""
    from ..ops.kernels.attention import DEFAULT_MASK_VALUE, _mask_as_key_bias

    if mask is None:
        return None, None
    if mask.shape != (b, s):
        raise ValueError(f"ulysses_attention takes a (B, S) = ({b}, {s}) "
                         f"key mask, got {tuple(mask.shape)}")
    keep = mask if mask.dtype == torch.bool else ~torch.isneginf(mask)
    seen = torch.cumsum(keep.int(), dim=1) > 0 if is_causal \
        else keep.any(dim=1, keepdim=True).expand(b, s)
    return _mask_as_key_bias(mask, b, s).clamp_min(DEFAULT_MASK_VALUE), seen


def _all_to_all(x, split_dim, concat_dim, group):
    from ..distributed import comm

    profiler.stat_add("seq_parallel_all_to_all_bytes",
                      x.numel() * x.element_size())
    return comm.all_to_all_tiled_diff(x, split_dim, concat_dim, group)


def ulysses_attention_local(q, k, v, group=None, mask=None,
                            is_causal=False, scale=None):
    """The per-rank body: q/k/v are this rank's (B, S/n, H, D) sequence
    shards over `group` (None: the world); `mask` the whole (B, S) key
    mask, the same on every rank.  Returns this rank's (B, S/n, H, D)
    output, differentiable in q, k and v."""
    from ..distributed import comm
    from ..ops.kernels.attention import flash_attention

    n = comm.world(group)
    if q.shape[2] % n:
        raise ValueError(
            f"ulysses needs num_heads {q.shape[2]} divisible by the axis "
            f"size {n}; use ring attention otherwise")
    qh, kh, vh = (_all_to_all(x, 2, 1, group) for x in (q, k, v))
    b, s = qh.shape[0], qh.shape[1]
    bias, seen = _key_bias(mask, is_causal, b, s)
    out = flash_attention(qh, kh, vh, key_bias=bias, is_causal=is_causal,
                          scale=scale)
    if seen is not None:
        out = torch.where(seen[:, :, None, None], out, torch.zeros_like(out))
    return _all_to_all(out, 1, 2, group)


def ulysses_attention(mesh, axis="sp"):
    """-> attn(q, k, v, mask=None, is_causal=False, scale=None) over the
    ranks of `mesh`'s `axis`: q/k/v this rank's sequence shards, `mask`
    the whole (B, S) key mask (the reference's callable takes the global
    arrays; a rank here holds only its own)."""
    from . import mesh as mesh_lib

    group = mesh_lib.axis_group(mesh, axis)

    def attn(q, k, v, mask: Optional[torch.Tensor] = None, is_causal=False,
             scale=None):
        return ulysses_attention_local(q, k, v, group, mask=mask,
                                       is_causal=is_causal, scale=scale)

    return attn
