"""The semantic-role-labelling program of Paddle's book (chapter
07.label_semantic_roles, `db_lstm` of python/paddle/fluid/tests/book/
test_label_semantic_roles.py upstream), written once against the Fluid
API of the package passed in (`paddle_tpu.fluid` or
`paddle_tpu_torch.fluid`).  It imports neither: the parity test builds
it with both, and `chip_smoke.py` with the port.

The graph and widths are the book's:
- eight int64 inputs: `word`, `ctx_n2`, `ctx_n1`, `ctx_0`, `ctx_p1`,
  `ctx_p2`, `verb`, `mark`; the six word slots share one table `emb`
  (word_dim 32, frozen in the book, which loads it pretrained), `verb`
  has `vemb` (32), `mark` a table of mark_dim 5 over 2 marks;
- hidden_0 = sums of fc(e, 512, tanh) over the eight embeddings, then
  dynamic_lstm(hidden_0, 512): H = 128, candidate relu, gate sigmoid,
  cell sigmoid;
- depth 8: each further layer sums fc(prev_fc, 512, tanh) and
  fc(prev_lstm, 512, tanh) into the same dynamic_lstm, reversed at odd
  layers;
- feature_out sums fc(., labels, tanh) of the last pair;
- linear_chain_crf(feature_out, target, ParamAttr("crfw",
  learning_rate=1e-3)), then mean; SGD over exponential_decay(0.01,
  decay_steps=100000, decay_rate=0.5, staircase=True); crf_decoding
  sharing `crfw`.

Sequences are dense, (B, T) padded with a `length` (B,) feed, where the
book feeds LoD tensors; so each fc keeps the time axis
(num_flatten_dims=2), the CRF and the decoding read `length`, and the
reverse LSTMs run over the whole padded T, as the reference's rule does.

Vocabularies: `paddle.dataset.conll05.get_dict()`, which the book reads
(wordDict.txt, verbDict.txt, targetDict.txt of the CoNLL-05 test set's
dictionaries): 44068 words, 3162 predicates, 106 labels.  The
dictionaries and the pretrained `emb` are not in the repository, so the
weights come from the startup program's seed and the data are
synthetic: a batch of B = 10 (the book's BATCH_SIZE) sentences padded to
T = 64, lengths drawn from 8 to 64; each sentence's context words and
predicate are constant along it, as CoNLL-05's are; the mark is 1
within two words of the predicate; each target label is a function of
its word and mark, so the NLL can fall.
"""

from __future__ import annotations

import numpy as np

BOOK = dict(word_dict=44068, verb_dict=3162, label_dict=106, mark_dict=2,
            word_dim=32, mark_dim=5, hidden=512, depth=8, batch=10, t=64,
            min_len=8, lr=0.01, decay_steps=100000, decay_rate=0.5,
            crf_lr=1e-3, emb_trainable=False)
# the parity tests' cut: depth 2, 32 wide (H = 8), small vocabularies;
# `emb` trainable there, so its gradient is held too
SMALL = dict(BOOK, word_dict=50, verb_dict=12, label_dict=6, hidden=32,
             depth=2, batch=3, t=7, min_len=2, emb_trainable=True)

SLOTS = ("word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2", "verb",
         "mark")


def db_lstm(fluid, cfg, feeds):
    """The book's db_lstm over `feeds` (name -> Variable); returns
    feature_out (B, T, labels)."""
    L = fluid.layers
    hidden = cfg["hidden"]
    verb_emb = L.embedding(feeds["verb"], size=[cfg["verb_dict"],
                                                cfg["word_dim"]],
                           dtype="float32", param_attr="vemb")
    mark_emb = L.embedding(feeds["mark"], size=[cfg["mark_dict"],
                                                cfg["mark_dim"]],
                           dtype="float32")
    embs = [L.embedding(feeds[s], size=[cfg["word_dict"], cfg["word_dim"]],
                        param_attr=fluid.ParamAttr(
                            name="emb", trainable=cfg["emb_trainable"]))
            for s in SLOTS[:6]]
    embs += [verb_emb, mark_emb]
    hidden_0 = L.sums([L.fc(e, hidden, num_flatten_dims=2, act="tanh")
                       for e in embs])
    lstm_0, _ = L.dynamic_lstm(hidden_0, hidden, candidate_activation="relu",
                               gate_activation="sigmoid",
                               cell_activation="sigmoid")
    prev = [hidden_0, lstm_0]
    for i in range(1, cfg["depth"]):
        mix = L.sums([L.fc(prev[0], hidden, num_flatten_dims=2, act="tanh"),
                      L.fc(prev[1], hidden, num_flatten_dims=2,
                           act="tanh")])
        lstm, _ = L.dynamic_lstm(mix, hidden, candidate_activation="relu",
                                 gate_activation="sigmoid",
                                 cell_activation="sigmoid",
                                 is_reverse=(i % 2) == 1)
        prev = [mix, lstm]
    labels = cfg["label_dict"]
    return L.sums([L.fc(prev[0], labels, num_flatten_dims=2, act="tanh"),
                   L.fc(prev[1], labels, num_flatten_dims=2, act="tanh")])


def build(fluid, cfg):
    """(main, startup, fetches) in a fresh pair of programs: fetches has
    `loss` (the mean NLL), `lr` (the decayed learning rate the step
    reads), `feature_out` and `decode` (crf_decoding's path).  Call it
    under `fluid.unique_name.guard()` for the book's parameter names."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        t = cfg["t"]
        feeds = {s: fluid.data(s, [-1, t], "int64") for s in SLOTS}
        target = fluid.data("target", [-1, t], "int64")
        length = fluid.data("length", [-1], "int64")
        feature_out = db_lstm(fluid, cfg, feeds)
        crf_cost = fluid.layers.linear_chain_crf(
            feature_out, target,
            param_attr=fluid.ParamAttr(name="crfw",
                                       learning_rate=cfg["crf_lr"]),
            length=length)
        loss = fluid.layers.mean(crf_cost)
        lr = fluid.layers.exponential_decay(
            learning_rate=cfg["lr"], decay_steps=cfg["decay_steps"],
            decay_rate=cfg["decay_rate"], staircase=True)
        fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
        decode = fluid.layers.crf_decoding(
            feature_out, param_attr=fluid.ParamAttr(name="crfw"),
            length=length)
    return main, startup, dict(loss=loss, lr=lr, feature_out=feature_out,
                               decode=decode)


def batch(cfg, seed=0):
    """One synthetic CoNLL-05-shaped batch: {name: int64 array}."""
    rng = np.random.RandomState(seed)
    b, t = cfg["batch"], cfg["t"]
    lengths = rng.randint(cfg["min_len"], t + 1, b)
    word = rng.randint(0, cfg["word_dict"], (b, t))
    pos = np.arange(t)[None, :]
    live = pos < lengths[:, None]
    pred_at = (rng.rand(b) * lengths).astype(np.int64)
    ctx = {s: np.repeat(word[np.arange(b), np.clip(pred_at + k, 0,
                                                    lengths - 1)][:, None],
                        t, axis=1)
           for s, k in zip(SLOTS[1:6], (-2, -1, 0, 1, 2))}
    verb = np.repeat(rng.randint(0, cfg["verb_dict"], (b, 1)), t, axis=1)
    mark = (np.abs(pos - pred_at[:, None]) <= 2).astype(np.int64)
    target = (word * 7 + mark * 3) % cfg["label_dict"]
    out = {"word": word, **ctx, "verb": verb, "mark": mark,
           "target": target, "length": lengths}
    return {k: np.where(live, v, 0).astype(np.int64) if v.ndim == 2
            else v.astype(np.int64) for k, v in out.items()}


def live_tokens(feed):
    return int(feed["length"].sum())
