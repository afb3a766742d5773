"""Static recurrent, beam, CTC and CRF rules (counterpart of
paddle_tpu/ops/rnn_ops.py): lstm, gru, gru_unit, lstm_unit, lstmp, rnn,
beam_search, beam_search_decode, gather_tree, warpctc, ctc_align,
edit_distance, row_conv and linear_chain_crf, crf_decoding (the
reference keeps it in misc_ops.py; here it sits beside the CRF it
decodes), and `dense_beam_step` /
`dense_beam_backtrack`, which the beam rules and the model decoders
share.

Sequences are dense and batch-major, (B, T, ...), with lengths beside
them where the reference takes them.  Each recurrence is the
reference's `lax.scan` as a Python loop over time: one small group of
torch ops a step, issued from the host, differentiated by autograd.
The `lstm` rule has a second arm: with the default activations (sigmoid
gates, tanh cell and candidate), no initial state and a device that can
run it, the whole sequence is one `torch.lstm` call (cuDNN on the card);
the gate order i, f, c~, o is torch's i, f, g, o.  `LSTM_ARMS` counts
the arm each call takes.

Beams live in a dense (batch * beam, ...) layout: a step is one
selection over the flattened (beam * K) candidates of each source, and
decoding follows the stored parent pointers back from the last step.
"""

from __future__ import annotations

import torch

from .registry import first, register_op


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


# -- the recurrences --------------------------------------------------------------

_ACT = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
        "identity": lambda x: x}

# the arm each `lstm` rule call took ("loop" or "cudnn"), and the switch
# that lets a caller force the loop (the oracle the cuDNN arm is held
# against)
LSTM_ARMS = {"loop": 0, "cudnn": 0}
LSTM_CUDNN = [True]


def _steps(x, reverse):
    """The time steps of a (B, T, ...) input in the order the recurrence
    visits them: the whole padded T axis reversed under `reverse`, as the
    reference reverses it (rnn_ops.py:61-63), so the padding comes
    first."""
    xs = list(x.unbind(1))
    return xs[::-1] if reverse else xs


def _gather_steps(outs, reverse):
    return torch.stack(outs[::-1] if reverse else outs, dim=1)


def _lstm_cudnn_ok(ctx, op, ins, acts):
    return (LSTM_CUDNN[0] and not ctx.abstract
            and acts == ("sigmoid", "tanh", "tanh")
            and first(ins, "H0") is None and first(ins, "C0") is None)


@register_op("lstm")
def _lstm(ctx, op, ins):
    """rnn_ops.py:37-82.  Input (B, T, 4H) is x @ W_x, Weight (H, 4H) the
    recurrent weight, Bias (1, 4H); gates i, f, c~, o; optional H0 / C0
    (B, H).  Hidden and Cell (B, T, H); BatchGate and BatchCellPreAct
    are zeros, as the reference gives them."""
    x, w, bias = first(ins, "Input"), first(ins, "Weight"), first(ins, "Bias")
    b, t, h = x.shape[0], x.shape[1], x.shape[-1] // 4
    names = (op.attr("gate_activation") or "sigmoid",
             op.attr("cell_activation") or "tanh",
             op.attr("candidate_activation") or "tanh")
    reverse = bool(op.attr("is_reverse"))
    extra = {"BatchGate": [torch.zeros_like(x)],
             "BatchCellPreAct": [x.new_zeros((b, t, h))]}
    if _lstm_cudnn_ok(ctx, op, ins, names):
        LSTM_ARMS["cudnn"] += 1
        hs, cs = _lstm_fused(x, w, bias, reverse)
        return {"Hidden": [hs], "Cell": [cs], **extra}
    if not ctx.abstract:
        LSTM_ARMS["loop"] += 1
    gate_act, cell_act, cand_act = (_ACT[n] for n in names)
    hp, cp = first(ins, "H0"), first(ins, "C0")
    hp = x.new_zeros((b, h)) if hp is None else hp
    cp = x.new_zeros((b, h)) if cp is None else cp
    bias = bias.reshape(1, -1)
    hs, cs = [], []
    for xt in _steps(x, reverse):
        g = xt + hp @ w + bias
        i = gate_act(g[:, :h])
        f = gate_act(g[:, h:2 * h])
        cand = cand_act(g[:, 2 * h:3 * h])
        o = gate_act(g[:, 3 * h:])
        cp = f * cp + i * cand
        hp = o * cell_act(cp)
        hs.append(hp)
        cs.append(cp)
    return {"Hidden": [_gather_steps(hs, reverse)],
            "Cell": [_gather_steps(cs, reverse)], **extra}


def _lstm_fused(x, w, bias, reverse):
    """Hidden as one `torch.lstm` over the sequence (cuDNN on the card):
    the input-to-hidden weight is the identity, since the input already
    holds x @ W_x, and the bias goes in b_ih.  torch.lstm gives only the
    last cell state, so Cell is rebuilt from the gates, whose products
    h_{t-1} @ W are one batched matmul over every step: a loop of two
    elementwise ops a step, c_t = f_t c_{t-1} + i_t c~_t."""
    b, t, g4 = x.shape
    h = g4 // 4
    xs = torch.flip(x, (1,)) if reverse else x
    eye = torch.eye(g4, dtype=x.dtype, device=x.device)
    zero_h = x.new_zeros((1, b, h))
    params = [eye, w.t().contiguous(), bias.reshape(-1), x.new_zeros(g4)]
    hs = torch.lstm(xs.contiguous(), (zero_h, zero_h), params, True, 1,
                    0.0, torch.is_grad_enabled(), False, True)[0]
    prev = torch.cat([x.new_zeros((b, 1, h)), hs[:, :-1]], dim=1)
    gates = xs + prev @ w + bias.reshape(1, 1, -1)
    i = torch.sigmoid(gates[..., :h])
    f = torch.sigmoid(gates[..., h:2 * h])
    cand = torch.tanh(gates[..., 2 * h:3 * h])
    cs, c = [], x.new_zeros((b, h))
    for k in range(t):
        c = f[:, k] * c + i[:, k] * cand[:, k]
        cs.append(c)
    cs = torch.stack(cs, dim=1)
    if reverse:
        hs, cs = torch.flip(hs, (1,)), torch.flip(cs, (1,))
    return hs, cs


@register_op("gru")
def _gru(ctx, op, ins):
    """rnn_ops.py:85-131.  Input (B, T, 3H) is x @ W_x, Weight (H, 3H) is
    [W_update | W_reset | W_candidate], Bias (1, 3H); h = u h_prev + (1 -
    u) c~ under `origin_mode`, else (1 - u) h_prev + u c~."""
    x, w, bias = first(ins, "Input"), first(ins, "Weight"), first(ins, "Bias")
    b, t, h = x.shape[0], x.shape[1], x.shape[-1] // 3
    gate_act = _ACT[op.attr("gate_activation") or "sigmoid"]
    cand_act = _ACT[op.attr("activation") or "tanh"]
    origin = bool(op.attr("origin_mode"))
    reverse = bool(op.attr("is_reverse"))
    hp = first(ins, "H0")
    hp = x.new_zeros((b, h)) if hp is None else hp
    w_gates, w_cand = w[:, :2 * h], w[:, 2 * h:]
    bg = bias.reshape(1, -1)
    hs = []
    for xt in _steps(x, reverse):
        g = xt[:, :2 * h] + hp @ w_gates + bg[:, :2 * h]
        u = gate_act(g[:, :h])
        r = gate_act(g[:, h:])
        cand = cand_act(xt[:, 2 * h:] + (r * hp) @ w_cand + bg[:, 2 * h:])
        hp = u * hp + (1 - u) * cand if origin else (1 - u) * hp + u * cand
        hs.append(hp)
    out = _gather_steps(hs, reverse)
    return {"Hidden": [out], "BatchGate": [torch.zeros_like(x)],
            "BatchResetHiddenPrev": [x.new_zeros((b, t, h))],
            "BatchHidden": [out]}


# gru_unit_op.h's GRUActivationType
_UNIT_ACT = {0: lambda x: x, 1: torch.sigmoid, 2: torch.tanh, 3: torch.relu}


@register_op("gru_unit")
def _gru_unit(ctx, op, ins):
    """One GRU step (rnn_ops.py:387-413): Input (B, 3H) = x @ W_x,
    HiddenPrev (B, H), Weight (H, 3H) = [W_u | W_r | W_c]; the candidate
    from (r h_prev) @ W_c; h = u h_prev + (1 - u) c under
    `origin_mode`, else u c + (1 - u) h_prev."""
    x, hp = first(ins, "Input"), first(ins, "HiddenPrev")
    w, bias = first(ins, "Weight"), first(ins, "Bias")
    h = hp.shape[1]
    gact = _UNIT_ACT[int(op.attr("gate_activation", 1))]
    cact = _UNIT_ACT[int(op.attr("activation", 2))]
    g = x + bias.reshape(1, -1) if bias is not None else x
    g = torch.cat([g[:, :2 * h] + hp @ w[:, :2 * h], g[:, 2 * h:]], dim=1)
    u, r = gact(g[:, :h]), gact(g[:, h:2 * h])
    rhp = r * hp
    c = cact(g[:, 2 * h:] + rhp @ w[:, 2 * h:])
    out = u * hp + (1.0 - u) * c if op.attr("origin_mode", False) \
        else u * c + (1.0 - u) * hp
    return {"Gate": [torch.cat([u, r, c], dim=1)],
            "ResetHiddenPrev": [rhp], "Hidden": [out]}


@register_op("lstm_unit")
def _lstm_unit(ctx, op, ins):
    """One LSTM step (rnn_ops.py:416-430): X (B, 4D) holds the gates'
    inputs in order i, f, o, g, forget_bias added to f."""
    x, c_prev = first(ins, "X"), first(ins, "C_prev")
    d = c_prev.shape[1]
    i = torch.sigmoid(x[:, :d])
    f = torch.sigmoid(x[:, d:2 * d] + op.attr("forget_bias", 0.0))
    o = torch.sigmoid(x[:, 2 * d:3 * d])
    c = f * c_prev + i * torch.tanh(x[:, 3 * d:])
    return {"C": [c], "H": [o * torch.tanh(c)]}


@register_op("lstmp")
def _lstmp(ctx, op, ins):
    """The LSTM with a projection (rnn_ops.py:433-498): the recurrence
    runs on r = proj_act(h @ ProjWeight), clipped by `proj_clip`, and the
    cell by `cell_clip`; Input (B, T, 4H), Weight (P, 4H), ProjWeight
    (H, P).  With peepholes (Bias of 7H) the i and f gates see c_prev
    and the o gate the new cell."""
    x, w = first(ins, "Input"), first(ins, "Weight")
    wp, bias = first(ins, "ProjWeight"), first(ins, "Bias")
    b, t, h = x.shape[0], x.shape[1], x.shape[-1] // 4
    p = wp.shape[1]
    gate_act = _ACT[op.attr("gate_activation") or "sigmoid"]
    cell_act = _ACT[op.attr("cell_activation") or "tanh"]
    cand_act = _ACT[op.attr("candidate_activation") or "tanh"]
    proj_act = _ACT[op.attr("proj_activation") or "tanh"]
    cell_clip = op.attr("cell_clip", 0.0)
    proj_clip = op.attr("proj_clip", 0.0)
    reverse = bool(op.attr("is_reverse"))
    rp, cp = first(ins, "H0"), first(ins, "C0")
    if rp is None:
        rp = x.new_zeros((b, p))
    elif rp.shape[1] == h:
        rp = proj_act(rp @ wp)
    r0 = rp
    cp = x.new_zeros((b, h)) if cp is None else cp
    bflat = bias.reshape(-1)
    peep = bool(op.attr("use_peepholes", True)) and bflat.shape[0] >= 7 * h
    w_ic = bflat[4 * h:5 * h] if peep else 0.0
    w_if = bflat[5 * h:6 * h] if peep else 0.0
    w_oc = bflat[6 * h:7 * h] if peep else 0.0
    rs, cs = [], []
    for xt in _steps(x, reverse):
        g = xt + rp @ w + bflat[None, :4 * h]
        i = gate_act(g[:, :h] + cp * w_ic)
        f = gate_act(g[:, h:2 * h] + cp * w_if)
        c = f * cp + i * cand_act(g[:, 2 * h:3 * h])
        if cell_clip > 0:
            c = torch.clamp(c, -cell_clip, cell_clip)
        o = gate_act(g[:, 3 * h:] + c * w_oc)
        rp = proj_act((o * cell_act(c)) @ wp)
        if proj_clip > 0:
            rp = torch.clamp(rp, -proj_clip, proj_clip)
        cp = c
        rs.append(rp)
        cs.append(cp)
    zeros = x.new_zeros((b, t, h))
    return {"Projection": [_gather_steps(rs, reverse)],
            "Cell": [_gather_steps(cs, reverse)],
            "BatchGate": [torch.zeros_like(x)], "BatchCellPreAct": [zeros],
            "BatchHidden": [zeros], "OrderedP0": [r0]}


def _rnn_cell(mode, hidden, xt, hp, cp, w_hh, b_hh):
    """One step of the `rnn` rule's cell: LSTM gates i, f, g, o; GRU r,
    u, c (rnn_ops.py:537-559)."""
    if mode == "LSTM":
        g = xt + hp @ w_hh.t() + b_hh.reshape(1, -1)
        i = torch.sigmoid(g[:, :hidden])
        f = torch.sigmoid(g[:, hidden:2 * hidden])
        gg = torch.tanh(g[:, 2 * hidden:3 * hidden])
        o = torch.sigmoid(g[:, 3 * hidden:])
        c = f * cp + i * gg
        return o * torch.tanh(c), c
    if mode == "GRU":
        gh = hp @ w_hh.t() + b_hh.reshape(1, -1)
        r = torch.sigmoid(xt[:, :hidden] + gh[:, :hidden])
        u = torch.sigmoid(xt[:, hidden:2 * hidden]
                          + gh[:, hidden:2 * hidden])
        c = torch.tanh(xt[:, 2 * hidden:] + r * gh[:, 2 * hidden:])
        return u * hp + (1.0 - u) * c, None
    g = xt + hp @ w_hh.t() + b_hh.reshape(1, -1)
    return (torch.tanh(g) if mode == "RNN_TANH" else torch.relu(g)), None


@register_op("rnn")
def _rnn(ctx, op, ins):
    """The multi-layer recurrence behind paddle.nn.LSTM / GRU / SimpleRNN
    (rnn_ops.py:501-602): Input (T, B, I) time-major, WeightList
    [W_ih, W_hh] per layer and direction then the biases in that order,
    PreState (L*D, B, H).  SequenceLength freezes the carry past each
    row's length and zeroes those outputs; dropout between layers (train
    only) draws from the op's generator."""
    x = first(ins, "Input")
    pre = ins.get("PreState") or []
    weights = ins.get("WeightList") or []
    seq_len = first(ins, "SequenceLength", None)
    mode = op.attr("mode", "LSTM")
    layers = int(op.attr("num_layers", 1))
    ndir = 2 if op.attr("is_bidirec", False) else 1
    hidden = int(op.attr("hidden_size", pre[0].shape[-1]))
    dropout = op.attr("dropout_prob", 0.0)
    t, b = x.shape[0], x.shape[1]
    ws, bs = weights[:len(weights) // 2], weights[len(weights) // 2:]
    h0 = pre[0]
    c0 = pre[1] if mode == "LSTM" and len(pre) > 1 else None
    live_at = [None] * t if seq_len is None else [
        (k < seq_len.reshape(b)).to(x.dtype)[:, None] for k in range(t)]

    def run(inp, w_ih, w_hh, b_ih, b_hh, hp, cp, reverse):
        xt_all = inp @ w_ih.t() + b_ih.reshape(1, 1, -1)
        outs = [None] * t
        for k in (range(t - 1, -1, -1) if reverse else range(t)):
            hn, cn = _rnn_cell(mode, hidden, xt_all[k], hp, cp, w_hh, b_hh)
            live = live_at[k]
            if live is None:
                hp, cp = hn, (cn if cn is not None else cp)
                outs[k] = hn
            else:
                hp = live * hn + (1 - live) * hp
                cp = live * cn + (1 - live) * cp if cn is not None else cp
                outs[k] = hp * live
        return torch.stack(outs), hp, cp

    layer_in, h_last, c_last = x, [], []
    for li in range(layers):
        outs = []
        for d in range(ndir):
            idx = li * 2 * ndir + d * 2
            s = li * ndir + d
            hi = h0[s]
            ci = c0[s] if c0 is not None else torch.zeros_like(hi)
            o, hT, cT = run(layer_in, ws[idx], ws[idx + 1], bs[idx],
                            bs[idx + 1], hi, ci, d == 1)
            outs.append(o)
            h_last.append(hT)
            c_last.append(cT)
        layer_in = torch.cat(outs, dim=-1) if ndir == 2 else outs[0]
        if dropout > 0 and not op.attr("is_test", False) \
                and li < layers - 1 and not ctx.abstract:
            keep = torch.rand(layer_in.shape, generator=ctx.generator(op),
                              device=layer_in.device) < 1.0 - dropout
            layer_in = torch.where(keep, layer_in / (1.0 - dropout),
                                   torch.zeros_like(layer_in))
    state = [torch.stack(h_last)]
    if mode == "LSTM":
        state.append(torch.stack(c_last))
    outs = {"Out": [layer_in], "State": state}
    for slot in ("Reserve", "DropoutState"):
        if slot in op.outputs:
            outs[slot] = [x.new_zeros((1,))]
    return outs


# -- beams ------------------------------------------------------------------------

@register_op("beam_search")
def _beam_search(ctx, op, ins):
    """One dense beam step (rnn_ops.py:182-203): pre_ids / pre_scores
    (B*W, 1), scores (B*W, K), ids (B*W, K) or none; `is_accumulated`
    (True when unset) says the scores hold the prefix's total."""
    acc = op.attr("is_accumulated")
    sel_ids, sel_scores, parent = dense_beam_step(
        first(ins, "pre_ids"), first(ins, "pre_scores"), first(ins, "ids"),
        first(ins, "scores"), int(op.attr("beam_size")),
        int(op.attr("end_id")), is_accumulated=True if acc is None
        else bool(acc))
    return {"selected_ids": [sel_ids], "selected_scores": [sel_scores],
            "parent_idx": [parent]}


@register_op("beam_search_decode")
def _beam_search_decode(ctx, op, ins):
    """Ids and ParentIdx (T, B*W) -> SentenceIds (B*W, T), with the last
    step's Scores as SentenceScores (rnn_ops.py:206-219)."""
    scores = first(ins, "Scores")
    return {"SentenceIds": [dense_beam_backtrack(first(ins, "Ids"),
                                                 first(ins, "ParentIdx"))],
            "SentenceScores": [scores[-1]]}


@register_op("gather_tree")
def _gather_tree(ctx, op, ins):
    """Backtrack (T, B, W) parent pointers (rnn_ops.py:605-627): out[T-1]
    = ids[T-1][parents[T-1]]'s columns read at the identity; walking
    back, out[t] = ids[t][ptr], ptr = parents[t][ptr]."""
    ids, parents = first(ins, "Ids"), first(ins, "Parents").long()
    t, b, w = ids.shape
    if t == 1:
        return {"Out": [ids]}
    cols = torch.arange(w, device=ids.device).expand(b, w)
    ptr = torch.gather(parents[t - 1], 1, cols)
    outs = [None] * (t - 1) + [ids[t - 1]]
    for k in range(t - 2, -1, -1):
        outs[k] = torch.gather(ids[k], 1, ptr)
        ptr = torch.gather(parents[k], 1, ptr)
    return {"Out": [torch.stack(outs)]}


# -- CTC -------------------------------------------------------------------------

_NEG_INF = -1e30


def _shift(a, k):
    """a moved k columns right, the first k filled with -1e30."""
    return torch.cat([a.new_full((a.shape[0], k), _NEG_INF), a[:, :-k]],
                     dim=1)


@register_op("warpctc")
def _warpctc(ctx, op, ins):
    """CTC loss (rnn_ops.py:222-304): Logits (T, B, C) raw, Label (B, L)
    padded, LogitsLength and LabelLength (B,).  The forward recursion in
    log space over the extended label (blank, l1, blank, ..., blank),
    frozen past each row's length; Loss (B, 1).  `norm_by_times` scales
    only the gradient by 1 / T, as warp-ctc does."""
    logits, label = first(ins, "Logits"), first(ins, "Label")
    blank = int(op.attr("blank", 0))
    t_max, b, _ = logits.shape
    l_max = label.shape[1]
    dev = logits.device
    logits_len = first(ins, "LogitsLength", None)
    label_len = first(ins, "LabelLength", None)
    logits_len = torch.full((b,), t_max, device=dev) if logits_len is None \
        else logits_len.reshape(b).long()
    label_len = torch.full((b,), l_max, device=dev) if label_len is None \
        else label_len.reshape(b).long()
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    s_max = 2 * l_max + 1
    ext = torch.full((b, s_max), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = label.long()
    same_as_2back = torch.cat([torch.ones((b, 2), dtype=torch.bool,
                                          device=dev),
                               ext[:, 2:] == ext[:, :-2]], dim=1)
    can_skip = (ext != blank) & ~same_as_2back
    rows = torch.arange(b, device=dev)
    p0 = log_probs[0]
    first_two = torch.stack([
        p0[rows, blank],
        torch.where(label_len > 0, p0[rows, ext[:, 1]],
                    p0.new_full((b,), _NEG_INF))], dim=1)
    alpha = torch.cat([first_two, p0.new_full((b, s_max - 2), _NEG_INF)],
                      dim=1)
    neg = torch.full_like(alpha, _NEG_INF)
    for k in range(1, t_max):
        merged = torch.logaddexp(torch.logaddexp(alpha, _shift(alpha, 1)),
                                 torch.where(can_skip, _shift(alpha, 2),
                                             neg))
        new = merged + torch.gather(log_probs[k], 1, ext)
        alpha = torch.where((k < logits_len)[:, None], new, alpha)
    s_last = 2 * label_len
    a_last = alpha[rows, s_last]
    a_prev = torch.where(label_len > 0,
                         alpha[rows, torch.clamp(s_last - 1, min=0)],
                         alpha.new_full((b,), _NEG_INF))
    loss = -torch.logaddexp(a_last, a_prev)
    if op.attr("norm_by_times", False):
        t_inv = 1.0 / torch.clamp(logits_len.to(loss.dtype), min=1.0)
        loss = loss.detach() + loss * t_inv - (loss * t_inv).detach()
    return {"Loss": [loss.reshape(b, 1)]}


@register_op("ctc_align")
def _ctc_align(ctx, op, ins):
    """Greedy CTC decode of (B, T) ids (rnn_ops.py:307-331): repeats
    collapsed, blanks dropped, the survivors front-packed and the rest
    `padding_value`; steps past InputLength read as blank.  OutputLength
    (B, 1)."""
    x = first(ins, "Input")
    blank = int(op.attr("blank", 0))
    steps = torch.arange(x.shape[1], device=x.device)[None, :]
    in_len = first(ins, "InputLength", None)
    if in_len is not None:
        x = torch.where(steps < in_len.reshape(-1, 1), x,
                        torch.full_like(x, blank))
    prev = torch.cat([torch.full_like(x[:, :1], -1), x[:, :-1]], dim=1)
    keep = (x != blank) & (x != prev)
    order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices
    packed = torch.gather(x, 1, order)
    n = keep.sum(1)
    out = torch.where(steps < n[:, None], packed,
                      torch.full_like(x, int(op.attr("padding_value", 0))))
    return {"Output": [out], "OutputLength": [n.reshape(-1, 1)]}


@register_op("edit_distance")
def _edit_distance(ctx, op, ins):
    """Levenshtein distance of Hyps (B, L1) to Refs (B, L2)
    (rnn_ops.py:334-379): the dynamic program over hypothesis positions,
    rows past HypsLength left as they are, read at RefsLength; divided
    by the reference's length under `normalized`.  SequenceNum is B."""
    hyp, ref = first(ins, "Hyps").long(), first(ins, "Refs").long()
    b, l1 = hyp.shape
    l2 = ref.shape[1]
    dev = hyp.device
    hyp_len = first(ins, "HypsLength", None)
    ref_len = first(ins, "RefsLength", None)
    hyp_len = torch.full((b,), l1, device=dev) if hyp_len is None \
        else hyp_len.reshape(b).long()
    ref_len = torch.full((b,), l2, device=dev) if ref_len is None \
        else ref_len.reshape(b).long()
    row = list(torch.arange(l2 + 1, device=dev).expand(b, l2 + 1).unbind(1))
    for i in range(l1):
        live = i < hyp_len
        sub = (hyp[:, i][:, None] != ref).long()
        new = [torch.where(live, row[0] + 1, row[0])]
        for j in range(l2):
            cand = torch.minimum(torch.minimum(row[j + 1] + 1, new[j] + 1),
                                 row[j] + sub[:, j])
            new.append(torch.where(live, cand, row[j + 1]))
        row = new
    dist = torch.stack(row, dim=1)[torch.arange(b, device=dev),
                                   ref_len].float()
    if op.attr("normalized", True):
        dist = dist / torch.clamp(ref_len.float(), min=1.0)
    return {"Out": [dist.reshape(b, 1)],
            "SequenceNum": [torch.full((), b, dtype=torch.int64,
                                       device=dev)]}


@register_op("row_conv")
def _row_conv(ctx, op, ins):
    """The lookahead convolution (rnn_ops.py:630-641): out[t] = sum_w
    x[t + w] * Filter[w] over X (B, T, D), zeros past the end."""
    x, f = first(ins, "X"), first(ins, "Filter")
    fc, t = f.shape[0], x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, 0, fc - 1))
    out = pad[:, 0:t] * f[0][None, None]
    for w in range(1, fc):
        out = out + pad[:, w:w + t] * f[w][None, None]
    return {"Out": [out]}


# -- CRF -------------------------------------------------------------------------

def _crf_lengths(ins, b, t, device):
    length = first(ins, "Length", None)
    if length is None:
        return torch.full((b,), t, dtype=torch.long, device=device)
    return length.reshape(b).long()


@register_op("linear_chain_crf")
def _linear_chain_crf(ctx, op, ins):
    """The linear-chain CRF's negative log-likelihood (rnn_ops.py:644-
    701), batched: Transition (D+2, D) holds the start weights (row 0),
    the end weights (row 1) and the tag-to-tag matrix; Emission (B, T,
    D) with Length (B,).  The forward table is L1-normalised row by row
    and frozen past each row's length; LogLikelihood (B, 1) is logZ -
    score; Alpha and EmissionExps (exp(x - rowmax)) are zeroed past the
    length, TransitionExps is exp(Transition).  The gradient is
    autograd's over this forward."""
    emission, trans = first(ins, "Emission"), first(ins, "Transition")
    label = first(ins, "Label")
    if emission.ndim == 2:
        emission = emission[None]
    b, t, d = emission.shape
    label = label.reshape(b, t).long()
    dev = emission.device
    lens = _crf_lengths(ins, b, t, dev)
    w_exps = torch.exp(trans)
    w_tags = w_exps[2:]
    row_max = torch.amax(emission, dim=2)
    x_exps = torch.exp(emission - row_max[..., None])
    a0 = w_exps[0] * x_exps[:, 0]
    s0 = a0.sum(1)
    a = a0 / s0[:, None]
    ll = -row_max[:, 0] - torch.log(s0)
    alphas = [a]
    for k in range(1, t):
        nxt = x_exps[:, k] * (a @ w_tags)
        s = nxt.sum(1)
        live = k < lens
        a = torch.where(live[:, None], nxt / s[:, None], a)
        ll = torch.where(live, ll - row_max[:, k] - torch.log(s), ll)
        alphas.append(a)
    alpha = torch.stack(alphas, dim=1)
    rows = torch.arange(b, device=dev)
    last = (lens - 1) % t
    ll = ll - torch.log(torch.sum(alpha[rows, last] * w_exps[1], dim=1))
    steps = torch.arange(t, device=dev)
    live = steps[None, :] < lens[:, None]
    lab_last = label[rows, last]
    x_lab = torch.gather(emission, 2, label[..., None])[..., 0]
    score = trans[0, label[:, 0]] + x_lab[:, 0] + trans[1, lab_last]
    pair = trans[label[:, :-1] + 2, label[:, 1:]] + x_lab[:, 1:]
    score = score + torch.sum(torch.where(live[:, 1:], pair,
                                          torch.zeros_like(pair)), dim=1)
    mask = live[..., None].to(emission.dtype)
    return {"LogLikelihood": [(-(ll + score)).reshape(b, 1)],
            "Alpha": [alpha * mask], "EmissionExps": [x_exps * mask],
            "TransitionExps": [w_exps]}


@register_op("crf_decoding")
def _crf_decoding(ctx, op, ins):
    """Viterbi decoding with the linear_chain_crf Transition layout
    (misc_ops.py:210-260), batched: the best previous tag by argmax, the
    first index among equal scores (as jnp.argmax; torch.argmax keeps
    the first too); steps past Length emit 0.  With a Label input the
    output is the 0/1 mask of the positions the path gets right."""
    emission, trans = first(ins, "Emission"), first(ins, "Transition")
    label = first(ins, "Label", None)
    if emission.ndim == 2:
        emission = emission[None]
    b, t, d = emission.shape
    dev = emission.device
    lens = _crf_lengths(ins, b, t, dev)
    a = trans[0][None] + emission[:, 0]
    alphas, tracks = [a], []
    for k in range(1, t):
        scores = a[:, :, None] + trans[2:][None]
        tracks.append(torch.argmax(scores, dim=1))
        nxt = torch.amax(scores, dim=1) + emission[:, k]
        a = torch.where((k < lens)[:, None], nxt, a)
        alphas.append(a)
    rows = torch.arange(b, device=dev)
    alpha_last = torch.stack(alphas, dim=1)[rows, (lens - 1) % t]
    last_tag = torch.argmax(alpha_last + trans[1][None], dim=1)
    tag, path = last_tag, [None] * (t - 1) + [last_tag]
    for i in range(t - 2, -1, -1):
        prev = torch.gather(tracks[i], 1, tag[:, None])[:, 0]
        tag = torch.where(i <= lens - 2, prev, tag)
        path[i] = tag
    path = torch.stack(path, dim=1)
    steps = torch.arange(t, device=dev)[None, :]
    path = torch.where(steps == (lens - 1)[:, None], last_tag[:, None], path)
    path = torch.where(steps < lens[:, None], path, torch.zeros_like(path))
    if label is not None:
        ok = (label.reshape(b, t).long() == path) & (steps < lens[:, None])
        path = ok.long()
    return {"ViterbiPath": [path]}
