"""Paddle 2.x's seq2seq with attention for IWSLT'15 English-Vietnamese,
written once against the 2.x API of the package passed in
(`paddle_tpu` or `paddle_tpu_torch`).  It imports neither: the parity
test builds it with both, and `chip_smoke.py` with the port.

Source: PaddleNLP examples/machine_translation/seq2seq (seq2seq_attn.py,
and the defaults of args.py), which is also hapi's seq2seq example.  The
sizes of `IWSLT15` are this program's reading of those defaults:
- encoder: Embedding(17191, 512), then a 2-layer LSTM(512, 512) with
  dropout 0.2 between the layers;
- decoder: Embedding(7709, 512) and `nn.RNN` over a cell of two
  LSTMCells with input feeding (layer 0 takes the token's embedding
  concatenated with the previous attention output) and Luong attention:
  score = input_proj(h) . enc^T with padded source positions at -1e9,
  softmax, context, tanh(output_proj([context, h])); dropout 0.2 after
  each cell; then Linear(512, 7709).  The projections have no bias;
- loss: softmax cross-entropy masked by `sequence_mask` of the target
  lengths, averaged over the batch and summed over time;
- training: every parameter uniform in +-0.1, Adam at 1e-3,
  ClipGradByGlobalNorm(5.0), batch 128, float32;
- decoding: `BeamSearchDecoder(beam_size=10)` and `dynamic_decode`, the
  encoder outputs and mask tiled by `tile_beam_merge_with_batch` and
  passed as keyword arguments to the cell.

The reference's `nn.RNN` passes no keyword arguments to its cell (Paddle
2.x's does), so for training the decoder hands the cell its memory
(encoder outputs and mask) as an attribute for the time of the call.

Data are synthetic, from a seed: sources of `T` tokens (50: a long
sentence of that corpus) drawn from the non-special ids, full length
(the encoder reads every position; see `nn.LSTM`'s `sequence_length`);
each target is a fixed function of its source, so the loss can fall,
and its length varies inside the batch through the target mask only.
"""

from __future__ import annotations

import numpy as np

IWSLT15 = dict(src_vocab=17191, trg_vocab=7709, hidden=512, num_layers=2,
               dropout=0.2, init_scale=0.1, lr=1e-3, max_grad_norm=5.0,
               batch=128, beam_size=10, max_out_len=50, steps=50)
# the test's cut
TINY = dict(IWSLT15, src_vocab=50, trg_vocab=50, hidden=16, batch=4,
            steps=7, dropout=0.0, max_out_len=7, beam_size=3)
BOS, EOS = 1, 2  # the vocabularies' <s> and </s> (0 is <unk>)
INF = 1e9

_CLASSES = {}


def classes(P):
    """The program's layers, subclassing P.nn.Layer (made once a
    package)."""
    if P.__name__ in _CLASSES:
        return _CLASSES[P.__name__]
    nn, F = P.nn, P.nn.functional

    class Encoder(nn.Layer):
        def __init__(self, vocab, hidden, num_layers, dropout):
            super().__init__()
            self.embedder = nn.Embedding(vocab, hidden)
            self.lstm = nn.LSTM(hidden, hidden, num_layers=num_layers,
                                dropout=dropout if num_layers > 1 else 0.0)

        def forward(self, src, src_length):
            return self.lstm(self.embedder(src), sequence_length=src_length)

    class Attention(nn.Layer):
        def __init__(self, hidden):
            super().__init__()
            self.input_proj = nn.Linear(hidden, hidden, bias_attr=False)
            self.output_proj = nn.Linear(2 * hidden, hidden,
                                         bias_attr=False)

        def forward(self, hidden, encoder_output, encoder_padding_mask):
            query = self.input_proj(hidden)
            scores = P.matmul(P.unsqueeze(query, [1]), encoder_output,
                              transpose_y=True)
            scores = P.add(scores, encoder_padding_mask)
            context = P.matmul(F.softmax(scores), encoder_output)
            out = P.concat([P.squeeze(context, [1]), hidden], 1)
            return P.tanh(self.output_proj(out))

    class DecoderCell(nn.RNNCellBase):
        def __init__(self, num_layers, hidden, dropout):
            super().__init__()
            self.num_layers = num_layers
            self.dropout = nn.Dropout(dropout)
            for i in range(num_layers):
                self.add_sublayer(f"lstm_cell_{i}", nn.LSTMCell(
                    2 * hidden if i == 0 else hidden, hidden))
            self.attention = Attention(hidden)
            self.memory = None

        def forward(self, step_input, states, encoder_output=None,
                    encoder_padding_mask=None):
            if encoder_output is None:
                encoder_output, encoder_padding_mask = self.memory
            lstm_states, input_feed = states
            x = P.concat([step_input, input_feed], 1)
            new_states = []
            for i in range(self.num_layers):
                cell = getattr(self, f"lstm_cell_{i}")
                out, state = cell(x, lstm_states[i])
                x = self.dropout(out)
                new_states.append(state)
            out = self.attention(x, encoder_output, encoder_padding_mask)
            return out, [new_states, out]

    class Decoder(nn.Layer):
        def __init__(self, vocab, hidden, num_layers, dropout):
            super().__init__()
            self.embedder = nn.Embedding(vocab, hidden)
            self.lstm_attention = nn.RNN(DecoderCell(num_layers, hidden,
                                                     dropout))
            self.output_layer = nn.Linear(hidden, vocab, bias_attr=False)

        def forward(self, trg, states, encoder_output, encoder_padding_mask):
            cell = self.lstm_attention.cell
            cell.memory = (encoder_output, encoder_padding_mask)
            out, _ = self.lstm_attention(self.embedder(trg),
                                         initial_states=states)
            cell.memory = None
            return self.output_layer(out)

    class Seq2SeqAttnModel(nn.Layer):
        def __init__(self, cfg):
            super().__init__()
            self.hidden = cfg["hidden"]
            self.num_layers = cfg["num_layers"]
            self.encoder = Encoder(cfg["src_vocab"], cfg["hidden"],
                                   cfg["num_layers"], cfg["dropout"])
            self.decoder = Decoder(cfg["trg_vocab"], cfg["hidden"],
                                   cfg["num_layers"], cfg["dropout"])

        def encode(self, src, src_length):
            """Encoder outputs, the decoder's initial states
            [[(h, c)] * layers, input feed] and the attention mask
            (B, 1, S): 0 at a token, -1e9 at a padding (</s>) id."""
            enc, (h, c) = self.encoder(src, src_length)
            cell = self.decoder.lstm_attention.cell
            states = [[(h[i], c[i]) for i in range(self.num_layers)],
                      cell.get_initial_states(batch_ref=enc,
                                              shape=[self.hidden])]
            keep = P.cast(P.not_equal(src, EOS), "float32")
            mask = P.unsqueeze(P.scale(keep, scale=INF, bias=-1.0,
                                       bias_after_scale=False), [1])
            return enc, states, mask

        def forward(self, src, src_length, trg, trg_length):
            """(logits (B, T, V), target mask (B, T))."""
            enc, states, mask = self.encode(src, src_length)
            logits = self.decoder(trg, states, enc, mask)
            trg_mask = F.sequence_mask(trg_length, maxlen=trg.shape[1],
                                       dtype="float32")
            return logits, trg_mask

    class CrossEntropyCriterion(nn.Layer):
        def forward(self, logits, trg_mask, label):
            cost = P.squeeze(F.softmax_with_cross_entropy(logits, label),
                             [2])
            return P.sum(P.mean(P.multiply(cost, trg_mask), axis=[0]))

    ns = dict(Encoder=Encoder, Attention=Attention, DecoderCell=DecoderCell,
              Decoder=Decoder, Seq2SeqAttnModel=Seq2SeqAttnModel,
              CrossEntropyCriterion=CrossEntropyCriterion)
    _CLASSES[P.__name__] = ns
    return ns


def build(P, cfg, seed=0):
    """The model, every parameter set uniform in +-init_scale from a
    numpy stream of `seed` (in state_dict order, the same in both
    packages), so both packages start from the same weights."""
    model = classes(P)["Seq2SeqAttnModel"](cfg)
    rng = np.random.RandomState(seed)
    s = cfg["init_scale"]
    state = {k: rng.uniform(-s, s, tuple(v.shape)).astype("float32")
             for k, v in model.state_dict().items()}
    model.set_state_dict(state)
    return model


def batch(cfg, seed=0, n=None):
    """(src, src_length, trg, trg_length, label) as numpy: sources of
    `steps` ids in [3, src_vocab); each target is (3 * source + 7) mod
    the target vocabulary's non-special ids, fed after <s> and labelled
    before </s>; target lengths in [steps // 2, steps]."""
    rng = np.random.RandomState(seed)
    n, t = n or cfg["batch"], cfg["steps"]
    src = rng.randint(3, cfg["src_vocab"], (n, t)).astype("int64")
    out = (3 + (3 * src + 7) % (cfg["trg_vocab"] - 3)).astype("int64")
    trg = np.concatenate([np.full((n, 1), BOS, "int64"), out[:, :-1]], 1)
    label = out[:, :, None]
    src_len = np.full((n,), t, "int64")
    trg_len = rng.randint(t // 2, t + 1, (n,)).astype("int64")
    return src, src_len, trg, trg_len, label


def prepare(P, model, cfg):
    """hapi.Model over the network with the program's optimizer (Adam,
    global-norm clip) and loss."""
    m = P.Model(model)
    opt = P.optimizer.Adam(learning_rate=cfg["lr"],
                           parameters=model.parameters(),
                           grad_clip=P.optimizer.ClipGradByGlobalNorm(
                               cfg["max_grad_norm"]))
    m.prepare(opt, classes(P)["CrossEntropyCriterion"]())
    return m


def beam_decoder(P, model, beam_size):
    dec = model.decoder
    return P.nn.BeamSearchDecoder(
        dec.lstm_attention.cell, start_token=BOS, end_token=EOS,
        beam_size=beam_size, embedding_fn=dec.embedder,
        output_fn=dec.output_layer)


def beam_search(P, model, src, src_length, beam_size, max_out_len):
    """dynamic_decode's per-step outputs ({predicted_ids, parent_ids,
    scores}, each (B, steps, beam)) of a beam search over the model's
    decoder cell, in eval mode."""
    model.eval()
    with P.no_grad():
        enc, states, mask = model.encode(src, src_length)
        bsd = beam_decoder(P, model, beam_size)
        out, _ = P.nn.dynamic_decode(
            bsd, inits=states, max_step_num=max_out_len,
            encoder_output=bsd.tile_beam_merge_with_batch(enc),
            encoder_padding_mask=bsd.tile_beam_merge_with_batch(mask))
    return out


def backtrack(ids, parents):
    """(B, T, K) per-step ids and parent beams (numpy) -> (B, K, T) the
    sequences of the last step's beams, followed back through the
    parents."""
    b, t, k = ids.shape
    seqs = np.zeros((b, k, t), ids.dtype)
    beam = np.tile(np.arange(k), (b, 1))
    rows = np.arange(b)[:, None]
    for s in reversed(range(t)):
        seqs[:, :, s] = ids[rows, s, beam]
        beam = parents[rows, s, beam]
    return seqs


def host(t):
    """A tensor's values as numpy (a CUDA tensor is copied first)."""
    t = t.detach()
    return np.asarray((t.cpu() if hasattr(t, "cpu") else t).numpy())


def _clamped_log_probs(P, logits):
    """log(max(softmax(logits), 1e-20)) by the beam step's own sequence
    of operations."""
    e = P.exp(P.subtract(logits, P.max(logits, axis=-1, keepdim=True)))
    p = P.divide(e, P.sum(e, axis=-1, keepdim=True))
    return P.log(P.clip(p, min=1e-20))


def greedy(P, model, src, src_length, max_out_len):
    """(B, steps) ids of a greedy loop over the decoder cell: the most
    likely token of the clamped log-probabilities, the lower id among
    equal ones; a row that chose </s> keeps choosing it; the loop stops
    when every row has (one host read a step) or after max_out_len
    steps, as dynamic_decode does.  New tensors go on the current
    device, where the model must lie."""
    model.eval()
    dec = model.decoder
    cell = dec.lstm_attention.cell
    out = []
    with P.no_grad():
        enc, states, mask = model.encode(src, src_length)
        tok = P.full([src.shape[0]], BOS, "int64")
        done = None
        for _ in range(max_out_len):
            h, states = cell(dec.embedder(tok), states,
                             encoder_output=enc, encoder_padding_mask=mask)
            ids = P.argmax(_clamped_log_probs(P, dec.output_layer(h)),
                           axis=-1)
            step = host(ids)
            if done is not None:
                step = np.where(done, EOS, step)
            done = step == EOS if done is None else done | (step == EOS)
            out.append(step)
            tok = P.to_tensor(step.astype("int64"))
            if done.all():
                break
    return np.stack(out, 1)


def sequence_scores(P, model, src, src_length, seqs):
    """The sum of the clamped log-probabilities a teacher-forced pass of
    the decoder cell gives each sequence, up to and including its first
    </s> (later steps add nothing, as a finished beam extends at no
    cost).  seqs: (B, K, T) numpy ids; returns (B, K) numpy."""
    b, k, t = seqs.shape
    model.eval()
    dec = model.decoder
    cell = dec.lstm_attention.cell
    flat = seqs.reshape(b * k, t).astype("int64")
    ended = np.cumsum(flat == EOS, axis=1)
    live = np.concatenate([np.ones((b * k, 1), bool), ended[:, :-1] == 0],
                          1).astype("float32")
    put = P.to_tensor  # on the current device, where the model lies
    with P.no_grad():
        enc, states, mask = model.encode(src, src_length)
        bsd = beam_decoder(P, model, k)
        states = [[tuple(bsd.tile_beam_merge_with_batch(s) for s in pair)
                   for pair in states[0]],
                  bsd.tile_beam_merge_with_batch(states[1])]
        enc = bsd.tile_beam_merge_with_batch(enc)
        mask = bsd.tile_beam_merge_with_batch(mask)
        prev = np.concatenate([np.full((b * k, 1), BOS, "int64"),
                               flat[:, :-1]], 1)
        total = None
        for s in range(t):
            h, states = cell(dec.embedder(put(prev[:, s].copy())), states,
                             encoder_output=enc, encoder_padding_mask=mask)
            logp = _clamped_log_probs(P, dec.output_layer(h))
            picked = P.index_sample(logp, put(flat[:, s:s + 1].copy()))
            term = P.multiply(P.squeeze(picked, [1]),
                              put(live[:, s].copy()))
            total = term if total is None else P.add(total, term)
    return host(total).reshape(b, k)
