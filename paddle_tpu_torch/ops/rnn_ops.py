"""Dense beam search (counterpart of the beam part of
paddle_tpu/ops/rnn_ops.py: `dense_beam_step` and `dense_beam_backtrack`,
which its `beam_search` / `beam_search_decode` op rules and its model
decoders share).

Beams live in a dense (batch * beam, ...) layout: a step is one
selection over the flattened (beam * K) candidates of each source, and
decoding follows the stored parent pointers back from the last step.
The `beam_search` and `beam_search_decode` op rules and the LSTM/GRU
rules of the reference module are not ported yet.
"""

from __future__ import annotations

import torch


def dense_beam_step(pre_ids, pre_scores, cand_ids, scores, w, end_id,
                    is_accumulated=False):
    """One beam-search step.  pre_ids / pre_scores (B*W, 1), scores
    (B*W, K) and cand_ids (B*W, K) or None (the candidates are 0..K-1).
    With `is_accumulated`, `scores` already hold the prefix's total;
    else each row's pre_score is added.  A finished beam (pre_id ==
    end_id) is frozen: its only candidate is end_id at its unchanged
    score, every other one of its candidates at -1e9.  Returns (sel_ids
    (B*W, 1), sel_scores (B*W, 1), parent (B*W,) int64 row indices).

    The W best of a source's W*K candidates come in descending order,
    the lower flat index first among equal totals, as `lax.top_k` orders
    them (a stable descending sort; `torch.topk` promises no order among
    ties, and the -1e9 of frozen rows ties exactly)."""
    bw, k = scores.shape
    b = bw // w
    if cand_ids is None:
        cand_ids = torch.arange(k, dtype=torch.int64,
                                device=scores.device).expand(bw, k)
    finished = (pre_ids.reshape(bw) == end_id)[:, None]
    frozen = torch.full_like(scores, -1e9)
    frozen[:, 0] = pre_scores.reshape(bw)
    live = scores if is_accumulated else pre_scores.reshape(bw, 1) + scores
    total = torch.where(finished, frozen, live)
    cand_ids = torch.where(finished, torch.full_like(cand_ids, end_id),
                           cand_ids)
    top_scores, top_pos = torch.sort(total.reshape(b, w * k), dim=1,
                                     descending=True, stable=True)
    top_scores, top_pos = top_scores[:, :w], top_pos[:, :w]
    parent = (torch.arange(b, device=scores.device)[:, None] * w
              + torch.div(top_pos, k, rounding_mode="floor"))
    sel_ids = torch.gather(cand_ids.reshape(b, w * k), 1, top_pos)
    return (sel_ids.reshape(bw, 1), top_scores.reshape(bw, 1),
            parent.reshape(bw))


def dense_beam_backtrack(ids, parents):
    """(T, B*W) selected ids and parent pointers -> (B*W, T) sequences:
    from the last step back, each row takes its id and moves to its
    parent (the reference's reverse `lax.scan`, as a loop of gathers)."""
    steps, bw = ids.shape
    ptr = torch.arange(bw, device=ids.device)
    toks = [None] * steps
    for t in reversed(range(steps)):
        toks[t] = ids[t].index_select(0, ptr)
        ptr = parents[t].long().index_select(0, ptr)
    return torch.stack(toks, dim=1)
