"""The inference half of Paddle's seq2seq with attention (the model of
tests/torch_seq2seq_program.py, PaddleNLP's `seq2seq_attn` at IWSLT'15
widths) as a 1.x static program: a `While` block over tensor arrays
decodes it, greedy or with `beam_search`.  Written once against the
`fluid` of the package passed in (`paddle_tpu.fluid` or
`paddle_tpu_torch.fluid`), importing neither: the parity tests build it
with both, `chip_smoke.py` with the port.

The program, in the 1.x idiom:
- encoder: `embedding`, then per layer an `fc` input projection (no
  bias) and `dynamic_lstm` (the `lstm` op, its Bias the sum of the 2.x
  cell's two biases); the decoder starts from each layer's last hidden
  and cell state (`sequence_last_step`: every source is full length);
- decoder cell, written out as nn.LSTMCell computes it: per layer
  `matmul(x, W_ih, transpose_y)` + b_ih + `matmul(h, W_hh, transpose_y)`
  + b_hh, a `split` into i, f, g, o, c' = sigmoid(f) c + sigmoid(i)
  tanh(g), h' = sigmoid(o) tanh(c'); layer 0 takes the token's
  embedding concatenated with the previous attention output;
- Luong attention: `fc` (no bias) of h, `matmul` against the encoder
  outputs, the source mask (0 at a token, -1e9 at </s>) added,
  `softmax`, `matmul`, `concat` with h, `fc(act="tanh")`; then the
  output `fc` and the clamped log-probabilities the 2.x decoders use
  (exp(l - max) / sum, clip at 1e-20, log);
- the decode loop: a `While` over capacity-`max_out_len` arrays, its
  condition `less_than(i, max_out_len) AND NOT reduce_all(finished)`;
  greedy takes `argmax` (a finished row keeps </s>); beam search takes
  `topk` of the accumulated scores and `beam_search`, then reorders the
  states by `gather` on `parent_idx`; after the loop
  `tensor_array_to_tensor` and, for beams, `beam_search_decode`.

The reference's fluid.layers.split raises (ROADMAP queue 3) and its
fluid.layers.tensor_array_to_tensor is a guard, so both ops are appended
through LayerHelper, as the layers would append them.

`program_weights` maps the 2.x model's state dict to the program's
parameters: the `lstm` op's gates are i, f, c~, o, which is nn.LSTM's
i, f, g, o (`LSTM_GATE_ORDER`), its Weight is W_hh transposed and the
input projection W_ih transposed.
"""

from __future__ import annotations

import numpy as np

from torch_seq2seq_program import BOS, EOS, INF

# nn.LSTM's gate blocks, in the order the `lstm` op reads its 4H columns
LSTM_GATE_ORDER = (0, 1, 2, 3)


def _p(fluid, name):
    return fluid.ParamAttr(name=name)


def _append(fluid, op_type, inputs, out_slots, attrs, dtype="float32"):
    """One op through LayerHelper; returns its outputs in slot order."""
    helper = fluid.layer_helper.LayerHelper(op_type)
    outs = {s: [helper.create_variable_for_type_inference(dtype=dt)]
            for s, dt in out_slots}
    helper.append_op(op_type, inputs=inputs, outputs=outs, attrs=attrs)
    return [outs[s][0] for s, _ in out_slots]


def _split_op(fluid, x, n):
    helper = fluid.layer_helper.LayerHelper("split")
    outs = [helper.create_variable_for_type_inference(dtype=x.dtype)
            for _ in range(n)]
    helper.append_op("split", inputs={"X": [x]}, outputs={"Out": outs},
                     attrs={"num": n, "axis": len(x.shape) - 1,
                            "sections": []})
    return outs


def _array_to_tensor(fluid, arr, dtype):
    """(steps, *element) of the elements written."""
    return _append(fluid, "tensor_array_to_tensor", {"X": [arr]},
                   [("Out", dtype), ("OutIndex", "int64")],
                   {"axis": 0, "use_stack": True})[0]


def _cell(fluid, x, states, enc, mask, H, nl):
    """One step of the decoder cell: (attention output, new states
    [h_0, c_0, h_1, c_1, ...])."""
    L = fluid.layers
    new = []
    for k in range(nl):
        h, c = states[2 * k], states[2 * k + 1]
        wih = L.create_parameter([4 * H, 2 * H if k == 0 else H], "float32",
                                 name=f"dec_l{k}_wih")
        whh = L.create_parameter([4 * H, H], "float32", name=f"dec_l{k}_whh")
        bih = L.create_parameter([4 * H], "float32", name=f"dec_l{k}_bih")
        bhh = L.create_parameter([4 * H], "float32", name=f"dec_l{k}_bhh")
        g = L.elementwise_add(L.matmul(x, wih, transpose_y=True), bih)
        g = L.elementwise_add(g, L.matmul(h, whh, transpose_y=True))
        g = L.elementwise_add(g, bhh)
        i, f, gg, o = _split_op(fluid, g, 4)
        c2 = L.elementwise_add(L.elementwise_mul(L.sigmoid(f), c),
                               L.elementwise_mul(L.sigmoid(i), L.tanh(gg)))
        h2 = L.elementwise_mul(L.sigmoid(o), L.tanh(c2))
        new += [h2, c2]
        x = h2
    query = L.fc(x, H, param_attr=_p(fluid, "att_in_w"), bias_attr=False)
    scores = L.matmul(L.unsqueeze(query, [1]), enc, transpose_y=True)
    prob = L.softmax(L.elementwise_add(scores, mask))
    ctxv = L.squeeze(L.matmul(prob, enc), [1])
    out = L.fc(L.concat([ctxv, x], 1), H, param_attr=_p(fluid, "att_out_w"),
               bias_attr=False, act="tanh")
    return out, new


def _log_probs(fluid, out, V):
    L = fluid.layers
    logits = L.fc(out, V, param_attr=_p(fluid, "out_w"), bias_attr=False)
    e = L.exp(L.elementwise_sub(logits, L.reduce_max(logits, dim=-1,
                                                     keep_dim=True)))
    p = L.elementwise_div(e, L.reduce_sum(e, dim=-1, keep_dim=True))
    return L.log(L.clip(p, 1e-20, 3.4e38))


def _tile(fluid, x, beam):
    """(B, ...) -> (B * beam, ...), each row repeated beam times in
    place."""
    L = fluid.layers
    rest = list(x.shape[1:])
    t = L.expand(L.unsqueeze(x, [1]), [1, beam] + [1] * len(rest))
    return L.reshape(t, [-1] + rest)


def _encoder(fluid, cfg, src):
    """(encoder outputs (B, S, H), the decoder's initial states [h_0, c_0,
    h_1, c_1, ...], the attention mask (B, 1, S))."""
    L = fluid.layers
    H = cfg["hidden"]
    x = L.embedding(src, [cfg["src_vocab"], H],
                    param_attr=_p(fluid, "src_emb"))
    states = []
    for k in range(cfg["num_layers"]):
        proj = L.fc(x, 4 * H, num_flatten_dims=2,
                    param_attr=_p(fluid, f"enc_l{k}_wx"), bias_attr=False)
        x, cell = L.dynamic_lstm(proj, 4 * H,
                                 param_attr=_p(fluid, f"enc_l{k}_wh"),
                                 bias_attr=_p(fluid, f"enc_l{k}_b"))
        states += [L.sequence_last_step(x), L.sequence_last_step(cell)]
    eos = L.fill_constant([1], "int64", EOS)
    keep = L.cast(L.not_equal(src, eos), "float32")
    mask = L.unsqueeze(L.scale(keep, scale=INF, bias=-1.0,
                               bias_after_scale=False), [1])
    return x, states, mask


def build_encoder(fluid, cfg, batch, src_len):
    """(main, startup, [encoder outputs, h_0, c_0, h_1, c_1, ..., mask])
    of the encoder alone."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.data("src", [batch, src_len], "int64")
        enc, states, mask = _encoder(fluid, cfg, src)
    return main, startup, [enc] + states + [mask]


def build(fluid, cfg, batch, src_len, beam_size=0, max_out_len=None):
    """(main, startup, fetch vars) of the decode program for `batch`
    sources of `src_len` ids (feed "src", int64).  beam_size 0: greedy,
    fetching the ids (batch, steps); else beam search, fetching the
    sentences (batch * beam, steps) and their scores (batch * beam,)."""
    L = fluid.layers
    H, nl = cfg["hidden"], cfg["num_layers"]
    V = cfg["trg_vocab"]
    T = max_out_len or cfg["max_out_len"]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.data("src", [batch, src_len], "int64")
        enc, states, mask = _encoder(fluid, cfg, src)
        feed = L.fill_constant_batch_size_like(enc, [batch, H], "float32",
                                               0.0)
        eos = L.fill_constant([1], "int64", EOS)
        rows = batch * (beam_size or 1)
        if beam_size:
            enc, mask = _tile(fluid, enc, beam_size), _tile(fluid, mask,
                                                            beam_size)
            states = [_tile(fluid, s, beam_size) for s in states]
            feed = _tile(fluid, feed, beam_size)
            first = np.zeros((1, beam_size), "float32")
            first[0, 1:] = -INF
            pre_scores = L.reshape(L.elementwise_add(
                L.fill_constant([batch, beam_size], "float32", 0.0),
                L.assign(first)), [rows, 1])
            pre_ids = L.fill_constant([rows, 1], "int64", BOS)
        tok = L.fill_constant([rows], "int64", BOS)
        done = L.fill_constant([rows], "bool", False)
        i = L.fill_constant([1], "int64", 0)
        limit = L.fill_constant([1], "int64", T)
        cond = L.less_than(i, limit)
        ids_arr = L.create_array("int64", capacity=T,
                                 element_shape=[rows] + ([1] if beam_size
                                                         else []))
        if beam_size:
            score_arr = L.create_array("float32", capacity=T,
                                       element_shape=[rows, 1])
            parent_arr = L.create_array("int64", capacity=T,
                                        element_shape=[rows])
        w = L.While(cond)
        with w.block():
            emb = L.embedding(tok, [V, H], param_attr=_p(fluid, "trg_emb"))
            out, new = _cell(fluid, L.concat([emb, feed], 1), states, enc,
                             mask, H, nl)
            logp = _log_probs(fluid, out, V)
            if beam_size:
                acc = L.elementwise_add(logp, pre_scores)
                top_scores, top_ids = L.topk(acc, beam_size)
                sel_ids, sel_scores, parent = L.beam_search(
                    pre_ids, pre_scores, top_ids, top_scores, beam_size,
                    EOS, is_accumulated=True)
                new = [L.gather(s, parent) for s in new]
                out = L.gather(out, parent)
                L.array_write(sel_ids, i, array=ids_arr)
                L.array_write(sel_scores, i, array=score_arr)
                L.array_write(L.cast(parent, "int64"), i, array=parent_arr)
                L.assign(sel_ids, pre_ids)
                L.assign(sel_scores, pre_scores)
                L.assign(L.reshape(sel_ids, [rows]), tok)
                finished = L.reduce_all(L.equal(sel_ids, eos))
            else:
                step = L.where(done, L.fill_constant([rows], "int64", EOS),
                               L.argmax(logp, axis=-1))
                L.assign(L.logical_or(done, L.equal(step, eos)), done)
                L.array_write(step, i, array=ids_arr)
                L.assign(step, tok)
                finished = L.reduce_all(done)
            for old, nv in zip(states, new):
                L.assign(nv, old)
            L.assign(out, feed)
            L.increment(i, 1, in_place=True)
            L.assign(L.logical_and(L.less_than(i, limit),
                                   L.logical_not(finished)), cond)
        if not beam_size:
            ids = L.transpose(_array_to_tensor(fluid, ids_arr, "int64"),
                              [1, 0])
            return main, startup, [ids]
        step_ids = L.squeeze(_array_to_tensor(fluid, ids_arr, "int64"), [2])
        step_scores = L.squeeze(_array_to_tensor(fluid, score_arr,
                                                 "float32"), [2])
        parents = _array_to_tensor(fluid, parent_arr, "int64")
        sent_ids, sent_scores = L.beam_search_decode(
            step_ids, parents, step_scores, beam_size, EOS)
    return main, startup, [sent_ids, sent_scores]


def program_weights(state, cfg):
    """{program parameter name: value} from the 2.x model's state dict
    (`Seq2SeqAttnModel.state_dict()`, numpy arrays or torch tensors);
    the values are transposes, sums and views of the model's."""
    def gates(w):  # rows (nn.LSTM's 4H blocks) in LSTM_GATE_ORDER
        h = w.shape[0] // 4
        blocks = [w[g * h:(g + 1) * h] for g in LSTM_GATE_ORDER]
        return blocks[0] if len(blocks) == 1 else _cat(blocks)

    out = {"src_emb": state["encoder.embedder.weight"],
           "trg_emb": state["decoder.embedder.weight"],
           "out_w": state["decoder.output_layer.weight"]}
    cell = "decoder.lstm_attention.cell."
    out["att_in_w"] = state[cell + "attention.input_proj.weight"]
    out["att_out_w"] = state[cell + "attention.output_proj.weight"]
    for k in range(cfg["num_layers"]):
        lstm = f"encoder.lstm.{{}}_l{k}"
        out[f"enc_l{k}_wx"] = gates(state[lstm.format("weight_ih")]).T
        out[f"enc_l{k}_wh"] = gates(state[lstm.format("weight_hh")]).T
        out[f"enc_l{k}_b"] = gates(state[lstm.format("bias_ih")]
                                   + state[lstm.format("bias_hh")])[None]
        c = f"{cell}lstm_cell_{k}."
        for ours, theirs in (("wih", "weight_ih"), ("whh", "weight_hh"),
                             ("bih", "bias_ih"), ("bhh", "bias_hh")):
            out[f"dec_l{k}_{ours}"] = state[c + theirs]
    return out


def _cat(blocks):
    if isinstance(blocks[0], np.ndarray):
        return np.concatenate(blocks)
    import torch

    return torch.cat(blocks)


def load_from_2x(scope, model, cfg):
    """Put the 2.x model's parameters into the port's `scope` (as the
    program names them), on the model's device."""
    state = {k: v.detach() for k, v in model.state_dict().items()}
    for name, v in program_weights(state, cfg).items():
        scope.set(name, v.contiguous())


def sentence_scores(ids, scores, beam_size):
    """(B, beam, steps) ids and (B, beam) scores of the beam program's
    fetches."""
    ids, scores = np.asarray(ids), np.asarray(scores)
    b = ids.shape[0] // beam_size
    return (ids.reshape(b, beam_size, -1),
            scores.reshape(b, beam_size))
