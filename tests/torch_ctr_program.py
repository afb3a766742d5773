"""PaddleRec's CTR-DNN on Criteo (PaddlePaddle/models, PaddleRec/ctr/dnn of
the Paddle 1.x era: `network_conf.py` `ctr_dnn_model` and `train.py`),
trained through `fluid.DatasetFactory` and `Executor.train_from_dataset`.

The network: 13 dense features (`dense_input`, [-1, 13] float32), 26
categorical slots `C1`..`C26` ([-1, 1] int64, lod_level 1, one id each,
hashed into `hash_dim` = 1000001) and `label` ([-1, 1] int64); one
embedding table `SparseFeatFactors` [hash_dim, 10] (is_sparse, Uniform
in [-1, 1)) shared by the slots, each slot's lookup pooled by
sequence_pool(average); the 26 pooled embeddings and the dense input
concatenated (273 wide); fc 400 / 400 / 400 ReLU and fc 2 softmax, each
weight Normal(0, 1 / sqrt(fan_in)); cross_entropy averaged, accuracy,
and auc over 2**12 thresholds; Adam at 1e-4; B=1000.

`build` takes either package's `fluid`, so the same code gives the same
Program in both.  `FULL` is the published configuration; `SMALL` is it
cut for the CPU tests: 1001 ids, fc width 32, B=32.

Where it departs from the published example (PERF.md section 4):
- the script's auc keeps a window of 20 batches (`slide_steps=20`),
  which both packages' `auc` rule refuses; the program keeps the global
  AUC (`slide_steps=0`);
- `is_sparse` is accepted and the embedding's gradient is dense in both
  packages, as is Adam's update of the whole table (lazy_mode off);
- the data is synthetic (no Criteo in the repository): `write_files`
  writes Criteo-format MultiSlot files from a seed with
  fluid.incubate.data_generator's MultiSlotDataGenerator: dense values
  uniform in [0, 1) (the script's min-max normalisation), each slot's
  ids Zipf-skewed (a = 1.2) over that slot's own vocabulary (the Criteo
  Kaggle set's 26 cardinalities) and hashed into hash_dim, and labels
  drawn from a planted logistic rule over two dense features and the
  two smallest slots (C9, C20) at about 25 % positives, Criteo's click
  rate, so that the loss and the AUC can move within 100 steps at
  Adam's 1e-4.
"""

import os

import numpy as np

DENSE = 13
SLOTS = 26
EMB = 10
# the Criteo Kaggle set's 26 categorical cardinalities, C1..C26
VOCAB = [1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
         8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18,
         15, 286181, 105, 142572]
# the planted rule: logit = W * (d0 - d1 + [C9 rank 0] - [C20 rank 0])
# + BIAS, about 25 % positives
W, BIAS = 2.0, -1.75

FULL = dict(hash_dim=1000001, width=400, depth=3, batch=1000, lr=1e-4,
            thresholds=2 ** 12)
SMALL = dict(FULL, hash_dim=1001, width=32, batch=32)


def feed_names():
    return ["dense_input"] + [f"C{i}" for i in range(1, SLOTS + 1)] + \
        ["label"]


def build(fluid, cfg, seed=0):
    """(main, startup, {name: var}) under a fresh unique-name scope: the
    feeds in `feed_names()` order ("feeds"), "predict" (B, 2), "loss",
    "acc", "auc" and the auc histograms "stat_pos" / "stat_neg"."""
    import math

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        dense = fluid.data("dense_input", [-1, DENSE], "float32")
        slots = [fluid.data(f"C{i}", [-1, 1], "int64", lod_level=1)
                 for i in range(1, SLOTS + 1)]
        label = fluid.data("label", [-1, 1], "int64")

        def embedding_layer(ids):
            emb = fluid.layers.embedding(
                input=ids, is_sparse=True, size=[cfg["hash_dim"], EMB],
                param_attr=fluid.ParamAttr(
                    name="SparseFeatFactors",
                    initializer=fluid.initializer.Uniform()))
            return fluid.layers.sequence_pool(input=emb,
                                              pool_type="average")

        h = fluid.layers.concat([embedding_layer(s) for s in slots]
                                + [dense], axis=1)
        for _ in range(cfg["depth"]):
            h = fluid.layers.fc(
                input=h, size=cfg["width"], act="relu",
                param_attr=fluid.ParamAttr(initializer=fluid.initializer
                                           .Normal(scale=1 / math.sqrt(
                                               h.shape[1]))))
        predict = fluid.layers.fc(
            input=h, size=2, act="softmax",
            param_attr=fluid.ParamAttr(initializer=fluid.initializer.Normal(
                scale=1 / math.sqrt(h.shape[1]))))
        cost = fluid.layers.cross_entropy(input=predict, label=label)
        loss = fluid.layers.mean(cost)
        acc = fluid.layers.accuracy(input=predict, label=label)
        auc, _, (stat_pos, stat_neg) = fluid.layers.auc(
            input=predict, label=label, num_thresholds=cfg["thresholds"],
            slide_steps=0)
        fluid.optimizer.Adam(learning_rate=cfg["lr"]).minimize(loss)
    return main, startup, dict(feeds=[dense] + slots + [label],
                               predict=predict, loss=loss, acc=acc, auc=auc,
                               stat_pos=stat_pos, stat_neg=stat_neg)


def rows(cfg, n, seed):
    """`n` samples from `seed`: (dense (n, 13) cut to 6 places, ids
    (n, 26) int64, labels (n,) int64)."""
    rng = np.random.RandomState(seed)
    dense = np.floor(rng.uniform(0.0, 1.0, (n, DENSE)) * 1e6) / 1e6
    ranks = np.stack([(rng.zipf(1.2, n) - 1) % v for v in VOCAB], 1)
    # a multiplicative hash of (slot, rank) into hash_dim, as Paddle's
    # Criteo reader hashes "slot:value" strings
    slot = np.arange(1, SLOTS + 1, dtype=np.int64)
    ids = (ranks.astype(np.int64) * 2654435761 + slot * 40503) \
        % cfg["hash_dim"]
    z = W * (dense[:, 0] - dense[:, 1] + (ranks[:, 8] == 0)
             - (ranks[:, 19] == 0)) + BIAS
    labels = (rng.uniform(size=n) < 1 / (1 + np.exp(-z))).astype(np.int64)
    return dense, ids, labels


def write_files(dirname, cfg, n_files, lines, seed=0, prefix="part"):
    """`n_files` MultiSlot files of `lines` samples each under `dirname`,
    file i from seed + i, written by MultiSlotDataGenerator in
    `feed_names()` order; returns their paths."""
    from paddle_tpu_torch.fluid.incubate.data_generator import \
        MultiSlotDataGenerator

    class Criteo(MultiSlotDataGenerator):
        def __init__(self, dense, ids, labels):
            super().__init__()
            self.data = dense.tolist(), ids.tolist(), labels.tolist()

        def generate_sample(self, line):
            def records():
                names = feed_names()
                for d, c, y in zip(*self.data):
                    yield list(zip(names, [d] + [[i] for i in c] + [[y]]))
            return records

    os.makedirs(dirname, exist_ok=True)
    paths = []
    for i in range(n_files):
        path = os.path.join(dirname, f"{prefix}-{i:03d}")
        with open(path, "w") as f:
            Criteo(*rows(cfg, lines, seed + i)).run_from_memory(f)
        paths.append(path)
    return paths


def dataset(fluid, kind, feeds, files, cfg, threads=1, seed=None):
    """A fluid dataset of `kind` ("InMemoryDataset" or "QueueDataset")
    over `files`, B = cfg["batch"]; an InMemoryDataset is loaded, and
    shuffled when `seed` is given."""
    ds = fluid.DatasetFactory().create_dataset(kind)
    ds.set_batch_size(cfg["batch"])
    ds.set_use_var(feeds)
    ds.set_filelist(files)
    ds.set_thread(threads)
    if kind == "InMemoryDataset":
        ds.load_into_memory()
        if seed is not None:
            ds.set_shuffle_seed(seed)
            ds.global_shuffle()
    return ds
