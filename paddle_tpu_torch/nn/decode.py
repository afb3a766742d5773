"""The 2.x decoding API (counterpart of paddle_tpu/nn/decode.py):
`Decoder`, `BeamSearchDecoder` and `dynamic_decode`.

Beams live in a dense (batch * beam_size) leading dim; handing a beam
to its parent is a gather over it.  The reference's behaviour, kept:
- log-probabilities are log(max(softmax(logits), 1e-20)), not
  log_softmax, so an unlikely token's score is clamped at log(1e-20);
- beams 1..k-1 start at -1e9, so the first step fans out from beam 0;
- a finished beam extends only with `end_token`, at no cost;
- the k best of a source's k * V candidates come in `lax.top_k`'s
  order: descending, the lower flat index first among equal totals (a
  stable descending sort, as `ops.rnn_ops.dense_beam_step`'s);
- every cell state is reordered by the flattened parent index;
- `finalize` does not backtrack: the outputs are the per-step
  `predicted_ids`, `parent_ids` and `scores`, each (batch, steps, beam)
  (upstream Paddle backtracks with gather_tree; ROADMAP queue 3);
- `dynamic_decode` reads `finished` on the host each step (one sync a
  step) and stops when every beam has finished or after `max_step_num`
  (64 when not given) steps.
"""

from __future__ import annotations

import numpy as np
import torch


def _tree_map(f, t):
    if isinstance(t, (list, tuple)):
        return type(t)(_tree_map(f, x) for x in t)
    return f(t)


def _tree_leaves(t):
    if isinstance(t, (list, tuple)):
        return [leaf for x in t for leaf in _tree_leaves(x)]
    return [t]


class Decoder:
    """The decode contract: initialize(inits) -> (inputs, states,
    finished); step(time, inputs, states, **kwargs) -> (outputs,
    next_states, next_inputs, finished); finalize(outputs, states,
    sequence_lengths) -> (outputs, states)."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        return outputs, final_states

    @property
    def tracks_own_finished(self):
        return False


class BeamSearchDecoder(Decoder):
    """Beam search over an RNN cell: `cell(inputs, states, **kwargs)`
    gives (output, next_states); `output_fn` maps the output to logits
    and `embedding_fn` the chosen ids to the next inputs."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def tile_beam_merge_with_batch(self, x):
        """(B, ...) -> (B * beam_size, ...), each row repeated beam_size
        times in place."""
        return torch.repeat_interleave(x, self.beam_size, dim=0)

    def initialize(self, initial_cell_states):
        states = _tree_map(self.tile_beam_merge_with_batch,
                           initial_cell_states)
        leaf = _tree_leaves(states)[0]
        bk, dev = int(leaf.shape[0]), leaf.device
        b, k = bk // self.beam_size, self.beam_size
        tokens = torch.full((bk,), self.start_token, dtype=torch.int64,
                            device=dev)
        inputs = self.embedding_fn(tokens) if self.embedding_fn else tokens
        lp = torch.full((b, k), -1e9, dtype=torch.float32, device=dev)
        lp[:, 0] = 0.0
        self._log_probs = lp
        finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
        # the mask lives on the decoder too, so step() works without
        # dynamic_decode driving it
        self._finished_in = finished
        return inputs, states, finished

    def _beam_step(self, logits, lp, fin):
        """(top scores, parent beams, tokens, finished, flat gather
        index) of one step, as the reference's beam_step (:113-132)."""
        k = self.beam_size
        bk, v = logits.shape
        b = bk // k
        z = logits - torch.amax(logits, -1, keepdim=True)
        e = torch.exp(z)
        logp = torch.log(torch.clamp(e / torch.sum(e, -1, keepdim=True),
                                     min=1e-20)).reshape(b, k, v)
        # made on the device: a host write into it would sync each step
        only_end = torch.where(
            torch.arange(v, device=logp.device) == self.end_token,
            0.0, -1e9).to(logp.dtype)
        logp = torch.where(fin[:, :, None], only_end, logp)
        total = (lp[:, :, None] + logp).reshape(b, k * v)
        top, idx = torch.sort(total, dim=1, descending=True, stable=True)
        top, idx = top[:, :k], idx[:, :k]
        parent = torch.div(idx, v, rounding_mode="floor")
        token = idx - parent * v
        fin2 = torch.gather(fin, 1, parent) | (token == self.end_token)
        gather = (torch.arange(b, device=logits.device)[:, None] * k
                  + parent).reshape(-1)
        return top, parent, token, fin2, gather

    def step(self, time, inputs, states, **kwargs):
        cell_out, next_states = self.cell(inputs, states, **kwargs)
        if self.output_fn is not None:
            cell_out = self.output_fn(cell_out)
        top, parent, token, fin2, gather = self._beam_step(
            cell_out, self._log_probs, self._finished_in)
        self._log_probs = top.detach()
        next_states = _tree_map(lambda s: s.index_select(0, gather),
                                next_states)
        flat = token.reshape(-1)
        inputs = self.embedding_fn(flat) if self.embedding_fn else flat
        self._finished_in = fin2
        outputs = {"predicted_ids": token, "parent_ids": parent,
                   "scores": top}
        return outputs, next_states, inputs, fin2

    @property
    def tracks_own_finished(self):
        return True


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Step `decoder` until every sequence has finished or after
    `max_step_num` steps (64 when not given), passing `kwargs` to each
    step.  Returns (outputs, final_states[, lengths]): the steps'
    outputs stacked along axis 1 (0 with `output_time_major`), then
    `finalize`d; with `return_length`, each beam's length (int64): the
    step at which it finished, else the number of steps."""
    max_step_num = max_step_num or 64
    inputs, states, finished = decoder.initialize(inits)
    collected = []
    seq_len = None
    for t in range(int(max_step_num)):
        outputs, states, inputs, finished = decoder.step(
            t, inputs, states, **kwargs)
        collected.append(outputs)
        fin = finished.cpu().numpy().astype(bool)  # one sync a step
        if seq_len is None:
            seq_len = np.zeros(fin.shape, "int64")
        seq_len = np.where((seq_len == 0) & fin, t + 1, seq_len)
        if fin.all():
            break
    seq_len = np.where(seq_len == 0, len(collected), seq_len)
    axis = 0 if output_time_major else 1

    def stack(vals):
        return torch.stack(vals, axis)

    first = collected[0]
    if isinstance(first, dict):
        stacked = {k: stack([c[k] for c in collected]) for k in first}
    elif isinstance(first, (list, tuple)):
        stacked = type(first)(stack([c[i] for c in collected])
                              for i in range(len(first)))
    else:
        stacked = stack(collected)
    outputs, states = decoder.finalize(stacked, states, seq_len)
    if return_length:
        return outputs, states, torch.as_tensor(seq_len,
                                                device=finished.device)
    return outputs, states
