"""Static recurrent and beam-search layers (counterpart of
paddle_tpu/fluid/layers/rnn.py): dynamic_lstm, dynamic_gru, beam_search
and beam_search_decode.  Inputs are dense and batch-major, (B, T, ...);
the rules are paddle_tpu_torch/ops/rnn_ops.py.  `fluid.layers.
dynamic_gru` is compat's, which raises as the reference's does; this
module's stays reachable as `fluid.layers.rnn.dynamic_gru`.
"""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["dynamic_lstm", "dynamic_gru", "beam_search",
           "beam_search_decode"]


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=False, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """LSTM over pre-projected input (B, T, 4H); `size` = 4H (the
    reference's contract: feed an fc(…, 4H) output).  Returns
    (hidden (B,T,H), cell (B,T,H))."""
    if use_peepholes:
        raise NotImplementedError(
            "dynamic_lstm: peephole connections not implemented "
            "(use_peepholes=False matches the common path)")
    helper = LayerHelper("lstm", name=name)
    hidden_size = size // 4
    weight = helper.create_parameter(param_attr, [hidden_size, size],
                                     dtype=dtype)
    bias = helper.create_parameter(bias_attr, [1, size], dtype=dtype,
                                   is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    batch_gate = helper.create_variable_for_type_inference(dtype)
    batch_cell_pre = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    helper.append_op(
        "lstm", inputs=inputs,
        outputs={"Hidden": [hidden], "Cell": [cell],
                 "BatchGate": [batch_gate],
                 "BatchCellPreAct": [batch_cell_pre]},
        attrs={"is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation,
               "use_peepholes": use_peepholes})
    return hidden, cell


def dynamic_gru(input, size, h_0=None, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", origin_mode=False,
                dtype="float32", name=None):
    """GRU over pre-projected input (B, T, 3H); `size` = H.  Returns
    hidden (B, T, H)."""
    helper = LayerHelper("gru", name=name)
    weight = helper.create_parameter(param_attr, [size, 3 * size],
                                     dtype=dtype)
    bias = helper.create_parameter(bias_attr, [1, 3 * size], dtype=dtype,
                                   is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    bg = helper.create_variable_for_type_inference(dtype)
    brhp = helper.create_variable_for_type_inference(dtype)
    bh = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    helper.append_op(
        "gru", inputs=inputs,
        outputs={"Hidden": [hidden], "BatchGate": [bg],
                 "BatchResetHiddenPrev": [brhp], "BatchHidden": [bh]},
        attrs={"is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "activation": candidate_activation,
               "origin_mode": origin_mode})
    return hidden


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=True):
    """One dense beam step (reference beam_search_op.cc re-designed
    LoD-free): rows are (batch*beam); `scores` (rows, K) candidate
    log-probs (accumulated if is_accumulated else added to pre_scores
    here — we always add, matching is_accumulated=False semantics when
    pre_scores carry the cumulative total).  Returns (selected_ids,
    selected_scores, parent_idx)."""
    helper = LayerHelper("beam_search", name=name)
    sel_ids = helper.create_variable_for_type_inference("int64")
    sel_scores = helper.create_variable_for_type_inference(
        scores.dtype)
    parent = helper.create_variable_for_type_inference("int32")
    inputs = {"pre_ids": [pre_ids], "pre_scores": [pre_scores],
              "scores": [scores]}
    if ids is not None:
        inputs["ids"] = [ids]
    helper.append_op(
        "beam_search", inputs=inputs,
        outputs={"selected_ids": [sel_ids],
                 "selected_scores": [sel_scores],
                 "parent_idx": [parent]},
        attrs={"beam_size": beam_size, "end_id": end_id,
               "level": level, "is_accumulated": is_accumulated})
    if return_parent_idx:
        return sel_ids, sel_scores, parent
    return sel_ids, sel_scores


def beam_search_decode(ids, parent_idx, scores, beam_size=None,
                       end_id=None, name=None):
    """Backtrack per-step beam selections (T, batch*beam) into
    sequences (batch*beam, T) + final scores (reference
    beam_search_decode_op.cc, dense form)."""
    helper = LayerHelper("beam_search_decode", name=name)
    sent_ids = helper.create_variable_for_type_inference("int64")
    sent_scores = helper.create_variable_for_type_inference(
        scores.dtype)
    helper.append_op(
        "beam_search_decode",
        inputs={"Ids": [ids], "ParentIdx": [parent_idx],
                "Scores": [scores]},
        outputs={"SentenceIds": [sent_ids],
                 "SentenceScores": [sent_scores]},
        attrs={"beam_size": beam_size or 0, "end_id": end_id or 0})
    return sent_ids, sent_scores
