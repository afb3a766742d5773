"""The four programs of Paddle's book that tests/test_book_models.py
builds with paddle_tpu (`BOOK_BUILDERS`: word2vec, the recommender,
sentiment conv and SRL with a CRF), written once against the Fluid API
of the package passed in, at that file's sizes.  It imports neither
package: tests/test_torch_book.py holds each against the reference's
builder (the same Program JSON), and `chip_smoke.py` runs them on the
card with the port.  `feeds(name)` gives each program's synthetic
batch, as tests/test_book_models.py draws it.
"""

from __future__ import annotations

import numpy as np

W2V_DICT, W2V_EMB, W2V_HID = 64, 16, 64
REC_N_USR, REC_N_MOV, REC_N_AGE, REC_N_JOB = 32, 48, 7, 10
SENT_DICT, SENT_EMB, SENT_SEQ, SENT_CLASSES = 64, 16, 12, 2
SRL_DICT, SRL_MARK, SRL_EMB, SRL_HID, SRL_LABELS, SRL_T = \
    40, 2, 16, 16, 5, 10


def _cos_sim(fluid, x, y):
    helper = fluid.layer_helper.LayerHelper("cos_sim")
    out = helper.create_variable_for_type_inference()
    xn = helper.create_variable_for_type_inference()
    yn = helper.create_variable_for_type_inference()
    helper.append_op("cos_sim", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out], "XNorm": [xn], "YNorm": [yn]})
    return out


def word2vec(fluid):
    L = fluid.layers
    words = [fluid.data(n, [-1, 1], "int64")
             for n in ("firstw", "secondw", "thirdw", "forthw")]
    nextw = fluid.data("nextw", [-1, 1], "int64")
    embeds = [L.embedding(L.reshape(w, [-1]), size=[W2V_DICT, W2V_EMB],
                          param_attr="shared_w") for w in words]
    hidden = L.fc(L.concat(embeds, axis=1), W2V_HID, act="sigmoid")
    predict = L.fc(hidden, W2V_DICT, act="softmax")
    avg_cost = L.reduce_mean(L.cross_entropy(predict, nextw))
    fluid.optimizer.Adam(0.02).minimize(avg_cost)
    return [avg_cost]


def recommender(fluid):
    L = fluid.layers
    uid = fluid.data("user_id", [-1], "int64")
    age = fluid.data("age_id", [-1], "int64")
    job = fluid.data("job_id", [-1], "int64")
    mov = fluid.data("movie_id", [-1], "int64")
    rating = fluid.data("score", [-1, 1], "float32")
    usr_feats = L.concat(
        [L.fc(L.embedding(uid, [REC_N_USR, 16]), 16),
         L.fc(L.embedding(age, [REC_N_AGE, 8]), 8),
         L.fc(L.embedding(job, [REC_N_JOB, 8]), 8)], axis=1)
    usr = L.fc(usr_feats, 32, act="tanh")
    movf = L.fc(L.fc(L.embedding(mov, [REC_N_MOV, 16]), 32), 32,
                act="tanh")
    scale_infer = L.scale(_cos_sim(fluid, usr, movf), scale=5.0)
    avg_cost = L.reduce_mean(L.loss.square_error_cost(scale_infer, rating))
    fluid.optimizer.SGD(0.2).minimize(avg_cost)
    return [avg_cost]


def sentiment_conv(fluid):
    L = fluid.layers
    data = fluid.data("words", [-1, SENT_SEQ], "int64")
    label = fluid.data("label", [-1, 1], "int64")
    emb = L.embedding(data, size=[SENT_DICT, SENT_EMB])
    conv = L.sequence_conv(emb, num_filters=24, filter_size=3, act="tanh")
    predict = L.fc(L.sequence_pool(conv, "max"), SENT_CLASSES,
                   act="softmax")
    avg_cost = L.reduce_mean(L.cross_entropy(predict, label))
    fluid.optimizer.Adam(0.01).minimize(avg_cost)
    return [avg_cost]


def srl_crf(fluid):
    L = fluid.layers
    word = fluid.data("word", [-1, SRL_T], "int64")
    pred = fluid.data("predicate", [-1, SRL_T], "int64")
    mark = fluid.data("mark", [-1, SRL_T], "int64")
    target = fluid.data("target", [-1, SRL_T], "int64")
    length = fluid.data("length", [-1], "int64")
    feats = [L.embedding(word, size=[SRL_DICT, SRL_EMB]),
             L.embedding(pred, size=[SRL_DICT, SRL_EMB]),
             L.embedding(mark, size=[SRL_MARK, SRL_EMB])]
    proj = [L.fc(f, 4 * SRL_HID, num_flatten_dims=2) for f in feats]
    mix = proj[0]
    for p in proj[1:]:
        mix = L.elementwise_add(mix, p)
    h_fwd, _ = L.dynamic_lstm(mix, 4 * SRL_HID)
    h_rev, _ = L.dynamic_lstm(mix, 4 * SRL_HID, is_reverse=True)
    emission = L.fc(L.concat([h_fwd, h_rev], axis=2), SRL_LABELS,
                    num_flatten_dims=2)
    crf_cost = L.linear_chain_crf(emission, target,
                                  param_attr=fluid.ParamAttr(name="crfw"),
                                  length=length)
    avg_cost = L.reduce_mean(crf_cost)
    fluid.optimizer.Adam(0.05).minimize(avg_cost)
    decode = L.crf_decoding(emission, param_attr=fluid.ParamAttr(
        name="crfw"), length=length)
    return [avg_cost, decode]


BUILDERS = {"word2vec_ngram": word2vec, "recommender_towers": recommender,
            "sentiment_conv": sentiment_conv, "srl_crf": srl_crf}


def build(fluid, name):
    """(main, startup, fetch vars) of one program, in fresh programs
    under a fresh unique_name scope."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        fetches = BUILDERS[name](fluid)
    return main, startup, fetches


def feeds(name):
    """The synthetic batch tests/test_book_models.py trains the program
    on (its seeds and learnable targets)."""
    if name == "word2vec_ngram":
        data = np.random.RandomState(0).randint(0, W2V_DICT, size=(512, 1))
        data = data.astype("int64")
        return {"firstw": data, "secondw": (data + 1) % W2V_DICT,
                "thirdw": (data + 2) % W2V_DICT,
                "forthw": (data + 3) % W2V_DICT, "nextw": data}
    if name == "recommender_towers":
        rng, b = np.random.RandomState(1), 256
        out = {"user_id": rng.randint(0, REC_N_USR, b),
               "age_id": rng.randint(0, REC_N_AGE, b),
               "job_id": rng.randint(0, REC_N_JOB, b),
               "movie_id": rng.randint(0, REC_N_MOV, b)}
        out = {k: v.astype("int64") for k, v in out.items()}
        out["score"] = (1.0 + 4.0 * ((out["user_id"] + out["movie_id"])
                                     % 2)).astype("float32").reshape(-1, 1)
        return out
    if name == "sentiment_conv":
        x = np.random.RandomState(2).randint(0, SENT_DICT,
                                             size=(128, SENT_SEQ))
        x = x.astype("int64")
        return {"words": x,
                "label": (x == 0).any(axis=1).astype("int64").reshape(-1, 1)}
    rng, b = np.random.RandomState(7), 32
    w = rng.randint(0, SRL_DICT, (b, SRL_T)).astype("int64")
    p = np.repeat(rng.randint(0, SRL_DICT, (b, 1)), SRL_T,
                  axis=1).astype("int64")
    m = (w % 2).astype("int64")
    return {"word": w, "predicate": p, "mark": m,
            "target": ((w + m) % SRL_LABELS).astype("int64"),
            "length": rng.randint(SRL_T // 2, SRL_T + 1, b).astype("int64")}
