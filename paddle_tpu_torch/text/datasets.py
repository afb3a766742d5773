"""paddle.text.datasets (counterpart of paddle_tpu/text/datasets.py;
Paddle's python/paddle/text/datasets/{imdb,uci_housing,...}.py, which
download and parse).

This package fetches nothing: the parsers read the standard formats from
local paths and raise with instructions when they are absent.  Samples
are numpy arrays on the host, the reference's.
"""

from __future__ import annotations

import os
import re
import tarfile

import numpy as np

from ..io import Dataset

__all__ = ["Imdb", "UCIHousing", "FakeTextDataset", "Imikolov",
           "Movielens", "WMT14", "WMT16", "Conll05st"]

_NO_DOWNLOAD = ("this build runs zero-egress: fetch the archive on "
                "a connected machine and pass the local path")


class Imdb(Dataset):
    """IMDB sentiment (reference text/datasets/imdb.py): reads the
    aclImdb tar archive; builds a frequency-ranked vocab; samples are
    (token_ids int64 array, label 0/1)."""

    _PAT = re.compile(r"aclImdb/(train|test)/(pos|neg)/.*\.txt$")

    @classmethod
    def build_dict(cls, data_path, cutoff=150):
        """Vocab only — tokenizes both splits (reference imdb.py
        build_dict) without materializing document samples."""
        freq = {}
        with tarfile.open(data_path) as tf:
            for m in tf.getmembers():
                if cls._PAT.match(m.name):
                    body = tf.extractfile(m).read().decode(
                        "utf-8", "ignore").lower()
                    for t in re.findall(r"[a-z']+", body):
                        freq[t] = freq.get(t, 0) + 1
        vocab = [w for w, c in sorted(freq.items(),
                                      key=lambda kv: (-kv[1], kv[0]))
                 if c >= cutoff]
        word_idx = {w: i for i, w in enumerate(vocab)}
        word_idx["<unk>"] = len(word_idx)
        return word_idx

    def __init__(self, data_path=None, mode="train", cutoff=150,
                 download=False):
        if download or data_path is None:
            raise ValueError(f"Imdb: data_path to aclImdb tar required "
                             f"({_NO_DOWNLOAD})")
        # the vocabulary is built over BOTH splits (reference imdb.py
        # build_dict tokenizes train+test) so train- and test-mode
        # datasets agree on every word id; only `mode`'s documents
        # become samples
        self._docs, self._labels = [], []
        texts, freq = [], {}
        with tarfile.open(data_path) as tf:
            for m in tf.getmembers():
                mm = self._PAT.match(m.name)
                if mm:
                    body = tf.extractfile(m).read().decode(
                        "utf-8", "ignore").lower()
                    toks = re.findall(r"[a-z']+", body)
                    for t in toks:
                        freq[t] = freq.get(t, 0) + 1
                    if mm.group(1) == mode:
                        texts.append((toks,
                                      1 if mm.group(2) == "pos" else 0))
        vocab = [w for w, c in sorted(freq.items(),
                                      key=lambda kv: (-kv[1], kv[0]))
                 if c >= cutoff]
        self.word_idx = {w: i for i, w in enumerate(vocab)}
        self.word_idx["<unk>"] = len(self.word_idx)
        unk = self.word_idx["<unk>"]
        for toks, lab in texts:
            self._docs.append(np.asarray(
                [self.word_idx.get(t, unk) for t in toks], "int64"))
            self._labels.append(np.int64(lab))

    def __len__(self):
        return len(self._docs)

    def __getitem__(self, idx):
        return self._docs[idx], self._labels[idx]


class UCIHousing(Dataset):
    """UCI housing regression (reference text/datasets/uci_housing.py):
    whitespace-separated 14-column file; features normalized, target is
    the last column."""

    def __init__(self, data_path=None, mode="train", download=False):
        if download or data_path is None:
            raise ValueError(f"UCIHousing: data_path required "
                             f"({_NO_DOWNLOAD})")
        raw = np.loadtxt(data_path).astype("float32")
        feats, target = raw[:, :-1], raw[:, -1:]
        mn, mx = feats.min(0), feats.max(0)
        feats = (feats - mn) / np.maximum(mx - mn, 1e-6)
        n = len(raw)
        split = int(n * 0.8)
        sl = slice(0, split) if mode == "train" else slice(split, n)
        self.x, self.y = feats[sl], target[sl]

    def __len__(self):
        return len(self.x)

    def __getitem__(self, idx):
        return self.x[idx], self.y[idx]


class FakeTextDataset(Dataset):
    """Deterministic synthetic token-sequence dataset for tests."""

    def __init__(self, size=100, seq_len=32, vocab_size=1000,
                 num_classes=2, seed=0):
        self.size, self.seq_len = size, seq_len
        self.vocab_size, self.num_classes = vocab_size, num_classes
        self.seed = seed

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed * 7919 + idx)
        return (rng.randint(0, self.vocab_size,
                            self.seq_len).astype("int64"),
                np.int64(rng.randint(0, self.num_classes)))


class Imikolov(Dataset):
    """PTB language-model dataset (reference text/datasets/imikolov.py):
    reads ptb.train/valid.txt out of the simple-examples tar; vocab is
    frequency-ranked over train+valid with `min_word_freq` cutoff and
    '<unk>' last; samples are `window_size`-grams (data_type='NGRAM')
    or (<s>+sent, sent+<e>) id pairs (data_type='SEQ')."""

    _BASE = "./simple-examples/data/ptb.{}.txt"

    @classmethod
    def _read_lines(cls, tf, split):
        f = tf.extractfile(cls._BASE.format(split))
        return [l.decode("utf-8", "ignore") for l in f]

    @classmethod
    def build_dict(cls, data_path, min_word_freq=50):
        """Vocab only — no sample materialization (the classic
        imikolov.build_dict path)."""
        freq = {}
        with tarfile.open(data_path) as tf:
            for split in ("train", "valid"):
                for l in cls._read_lines(tf, split):
                    for w in l.strip().split():
                        freq[w] = freq.get(w, 0) + 1
                    freq["<s>"] = freq.get("<s>", 0) + 1
                    freq["<e>"] = freq.get("<e>", 0) + 1
        freq.pop("<unk>", None)
        vocab = [w for w, c in sorted(freq.items(),
                                      key=lambda kv: (-kv[1], kv[0]))
                 if c > min_word_freq]
        word_idx = {w: i for i, w in enumerate(vocab)}
        word_idx["<unk>"] = len(word_idx)
        return word_idx

    def __init__(self, data_path=None, data_type="NGRAM", window_size=-1,
                 mode="train", min_word_freq=50, word_idx=None,
                 download=False):
        if download or data_path is None:
            raise ValueError(f"Imikolov: data_path to the simple-examples "
                             f"tar required ({_NO_DOWNLOAD})")
        if data_type not in ("NGRAM", "SEQ"):
            raise ValueError(f"Imikolov: unknown data_type {data_type!r}")
        # honor a caller-built dict (classic API passes build_dict's
        # result) — ids must agree with the dict the user embeds with
        self.word_idx = word_idx if word_idx is not None \
            else self.build_dict(data_path, min_word_freq)
        with tarfile.open(data_path) as tf:
            corpora = {mode: self._read_lines(tf, mode)}
        unk = self.word_idx["<unk>"]
        self.data = []
        for l in corpora[mode]:
            if data_type == "NGRAM":
                if window_size < 1:
                    raise ValueError("Imikolov: NGRAM needs window_size>0")
                toks = ["<s>"] + l.strip().split() + ["<e>"]
                if len(toks) < window_size:
                    continue
                ids = [self.word_idx.get(w, unk) for w in toks]
                for i in range(window_size, len(ids) + 1):
                    self.data.append(tuple(ids[i - window_size:i]))
            else:
                ids = [self.word_idx.get(w, unk)
                       for w in l.strip().split()]
                src = [self.word_idx["<s>"]] + ids
                trg = ids + [self.word_idx["<e>"]]
                if 0 < window_size < len(src):
                    continue
                self.data.append((src, trg))

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return tuple(np.asarray(d, "int64") for d in self.data[idx])


_ML_AGES = [1, 18, 25, 35, 45, 50, 56]


class Movielens(Dataset):
    """MovieLens ml-1m (reference text/datasets/movielens.py): parses
    movies/users/ratings .dat ('::'-separated, latin-1) from the zip.
    Sample = ([uid], [gender01], [age_bucket], [job], [movie_id],
    [category ids...], [title word ids...], [rating*2-5]) — the
    reference's UserInfo.value() + MovieInfo.value() + rating layout."""

    def __init__(self, data_file=None, mode="train", test_ratio=0.1,
                 rand_seed=0, download=False):
        import zipfile

        if download or data_file is None:
            raise ValueError(f"Movielens: data_file to the ml-1m zip "
                             f"required ({_NO_DOWNLOAD})")
        title_pat = re.compile(r"^(.*)\((\d+)\)$")
        movies, users = {}, {}
        cat_set, title_words = set(), set()
        with zipfile.ZipFile(data_file) as z:
            with z.open("ml-1m/movies.dat") as f:
                for line in f:
                    mid, title, cats = line.decode("latin-1") \
                        .strip().split("::")
                    cats = cats.split("|")
                    title = title_pat.match(title).group(1)
                    movies[int(mid)] = (int(mid), cats, title)
                    cat_set.update(cats)
                    title_words.update(w.lower() for w in title.split())
            self.categories_dict = {c: i
                                    for i, c in enumerate(sorted(cat_set))}
            self.movie_title_dict = {w: i for i, w
                                     in enumerate(sorted(title_words))}
            with z.open("ml-1m/users.dat") as f:
                for line in f:
                    uid, gender, age, job, _ = line.decode("latin-1") \
                        .strip().split("::")
                    users[int(uid)] = (int(uid),
                                       0 if gender == "M" else 1,
                                       _ML_AGES.index(int(age)),
                                       int(job))
            rng = np.random.RandomState(rand_seed)
            is_test = mode == "test"
            self.data = []
            with z.open("ml-1m/ratings.dat") as f:
                for line in f:
                    if (rng.random_sample() < test_ratio) != is_test:
                        continue
                    uid, mid, rating, _ = line.decode("latin-1") \
                        .strip().split("::")
                    u = users[int(uid)]
                    mid_i, cats, title = movies[int(mid)]
                    self.data.append((
                        [u[0]], [u[1]], [u[2]], [u[3]], [mid_i],
                        [self.categories_dict[c] for c in cats],
                        [self.movie_title_dict[w.lower()]
                         for w in title.split()],
                        [float(rating) * 2 - 5.0]))

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return tuple(np.asarray(d) for d in self.data[idx])


class WMT14(Dataset):
    """WMT14 en->fr (reference text/datasets/wmt14.py): the
    preprocessed tar carries src.dict/trg.dict (first `dict_size`
    lines) and {mode}/{mode} tab-separated parallel text.  Samples are
    (src_ids with <s>/<e>, <s>+trg_ids, trg_ids+<e>); train pairs
    longer than 80 tokens are dropped, like the reference."""

    UNK_IDX = 2

    def __init__(self, data_file=None, mode="train", dict_size=-1,
                 download=False):
        if download or data_file is None:
            raise ValueError(f"WMT14: data_file required ({_NO_DOWNLOAD})")
        if dict_size <= 0:
            raise ValueError("WMT14: dict_size must be positive")
        self.src_ids, self.trg_ids, self.trg_ids_next = [], [], []
        with tarfile.open(data_file) as tf:
            def load_dict(suffix):
                (name,) = [m.name for m in tf.getmembers()
                           if m.name.endswith(suffix)]
                out = {}
                for i, line in enumerate(tf.extractfile(name)):
                    if i >= dict_size:
                        break
                    out[line.decode("utf-8", "ignore").strip()] = i
                return out

            self.src_dict = load_dict("src.dict")
            self.trg_dict = load_dict("trg.dict")
            members = [m.name for m in tf.getmembers()
                       if m.name.endswith(f"{mode}/{mode}")]
            for name in members:
                for line in tf.extractfile(name):
                    parts = line.decode("utf-8", "ignore") \
                        .strip().split("\t")
                    if len(parts) != 2:
                        continue
                    src = [self.src_dict.get(w, self.UNK_IDX)
                           for w in ["<s>"] + parts[0].split() + ["<e>"]]
                    trg = [self.trg_dict.get(w, self.UNK_IDX)
                           for w in parts[1].split()]
                    if len(src) > 80 or len(trg) > 80:
                        continue
                    self.src_ids.append(src)
                    self.trg_ids.append([self.trg_dict["<s>"]] + trg)
                    self.trg_ids_next.append(trg + [self.trg_dict["<e>"]])

    def __len__(self):
        return len(self.src_ids)

    def __getitem__(self, idx):
        return (np.asarray(self.src_ids[idx], "int64"),
                np.asarray(self.trg_ids[idx], "int64"),
                np.asarray(self.trg_ids_next[idx], "int64"))

    def get_dict(self, reverse=False):
        if reverse:
            return ({v: k for k, v in self.src_dict.items()},
                    {v: k for k, v in self.trg_dict.items()})
        return self.src_dict, self.trg_dict


class WMT16(Dataset):
    """WMT16 en<->de (reference text/datasets/wmt16.py): the tar holds
    wmt16/{train,val,test} tab-separated (en, de) pairs.  Vocabs are
    built in-memory from the train split, frequency-ranked, with
    <s>/<e>/<unk> reserved at 0/1/2 (the reference persists them to
    DATA_HOME; zero side effects here).  `lang` picks the source
    column."""

    def __init__(self, data_file=None, mode="train", src_dict_size=-1,
                 trg_dict_size=-1, lang="en", download=False):
        if download or data_file is None:
            raise ValueError(f"WMT16: data_file required ({_NO_DOWNLOAD})")
        if mode not in ("train", "val", "test"):
            raise ValueError(f"WMT16: bad mode {mode!r}")
        self.lang = lang
        src_col = 0 if lang == "en" else 1
        with tarfile.open(data_file) as tf:
            # ONE pass over the train corpus counts both columns
            freqs = ({}, {})
            for line in tf.extractfile("wmt16/train"):
                parts = line.decode("utf-8", "ignore") \
                    .strip().split("\t")
                if len(parts) != 2:
                    continue
                for col in (0, 1):
                    for w in parts[col].split():
                        freqs[col][w] = freqs[col].get(w, 0) + 1

            def build_dict(col, size):
                words = ["<s>", "<e>", "<unk>"]
                words += [w for w, _ in sorted(freqs[col].items(),
                                               key=lambda kv: -kv[1])]
                if size > 0:
                    words = words[:size]
                return {w: i for i, w in enumerate(words)}

            self.src_dict = build_dict(src_col, src_dict_size)
            self.trg_dict = build_dict(1 - src_col, trg_dict_size)
            start, end, unk = (self.src_dict["<s>"], self.src_dict["<e>"],
                               self.src_dict["<unk>"])
            self.src_ids, self.trg_ids, self.trg_ids_next = [], [], []
            for line in tf.extractfile(f"wmt16/{mode}"):
                parts = line.decode("utf-8", "ignore").strip().split("\t")
                if len(parts) != 2:
                    continue
                src = [start] + [self.src_dict.get(w, unk)
                                 for w in parts[src_col].split()] + [end]
                trg = [self.trg_dict.get(w, unk)
                       for w in parts[1 - src_col].split()]
                self.src_ids.append(src)
                self.trg_ids.append([start] + trg)
                self.trg_ids_next.append(trg + [end])

    def __len__(self):
        return len(self.src_ids)

    def __getitem__(self, idx):
        return (np.asarray(self.src_ids[idx], "int64"),
                np.asarray(self.trg_ids[idx], "int64"),
                np.asarray(self.trg_ids_next[idx], "int64"))

    def get_dict(self, lang="en", reverse=False):
        d = self.src_dict if lang == self.lang else self.trg_dict
        return {v: k for k, v in d.items()} if reverse else d


class Conll05st(Dataset):
    """CoNLL-2005 SRL test split (reference text/datasets/conll05.py):
    reads words/props gz streams out of the release tar plus word/verb
    dict files and a B-/I-/O label dict.  One sample per (sentence,
    predicate): 9 arrays — word ids, the five verb-context word ids
    broadcast over the sentence, predicate id broadcast, the 0/1 mark
    window, and per-token label ids."""

    UNK_IDX = 0

    def __init__(self, data_file=None, word_dict_file=None,
                 verb_dict_file=None, target_dict_file=None,
                 download=False):
        import gzip

        need = (data_file, word_dict_file, verb_dict_file,
                target_dict_file)
        if download or any(p is None for p in need):
            raise ValueError(f"Conll05st: data_file + the three dict "
                             f"files are required ({_NO_DOWNLOAD})")

        def load_dict(path):
            with open(path) as f:
                return {l.strip(): i for i, l in enumerate(f)}

        self.word_dict = load_dict(word_dict_file)
        self.predicate_dict = load_dict(verb_dict_file)
        tags = set()
        with open(target_dict_file) as f:
            for line in f:
                line = line.strip()
                if line.startswith(("B-", "I-")):
                    tags.add(line[2:])
        self.label_dict = {}
        for tag in sorted(tags):
            self.label_dict[f"B-{tag}"] = len(self.label_dict)
            self.label_dict[f"I-{tag}"] = len(self.label_dict)
        self.label_dict["O"] = len(self.label_dict)

        self.sentences, self.predicates, self.labels = [], [], []
        with tarfile.open(data_file) as tf:
            wf = tf.extractfile(
                "conll05st-release/test.wsj/words/test.wsj.words.gz")
            pf = tf.extractfile(
                "conll05st-release/test.wsj/props/test.wsj.props.gz")
            with gzip.GzipFile(fileobj=wf) as words, \
                    gzip.GzipFile(fileobj=pf) as props:
                sent, cols = [], []
                for wline, pline in zip(words, props):
                    w = wline.decode("utf-8", "ignore").strip()
                    p = pline.decode("utf-8", "ignore").strip().split()
                    if not p:  # blank line = end of sentence
                        self._emit(sent, cols)
                        sent, cols = [], []
                        continue
                    sent.append(w)
                    cols.append(p)
                self._emit(sent, cols)

    def _emit(self, sent, cols):
        """One emitted sample per predicate column.  Each props column
        k>=1 carries that predicate's bracketed role tags; column 0 is
        the predicate lemma ('-' elsewhere)."""
        if not sent:
            return
        n_pred = len(cols[0]) - 1
        lemmas = [row[0] for row in cols]
        for k in range(n_pred):
            labels, state = [], "O"
            verb_lemma = None
            for i, row in enumerate(cols):
                tok = row[k + 1]
                if tok.startswith("("):
                    role = tok[1:].split("*")[0].rstrip(")")
                    labels.append(f"B-{role}")
                    state = f"I-{role}" if not tok.endswith(")") else "O"
                    if role == "V":
                        verb_lemma = lemmas[i]
                elif state != "O":
                    labels.append(state)
                    if tok.endswith(")"):
                        state = "O"
                else:
                    labels.append("O")
            if verb_lemma is None or "B-V" not in labels:
                continue
            self.sentences.append(list(sent))
            self.predicates.append(verb_lemma)
            self.labels.append(labels)

    def __len__(self):
        return len(self.sentences)

    def __getitem__(self, idx):
        sent = self.sentences[idx]
        labels = self.labels[idx]
        n = len(sent)
        v = labels.index("B-V")
        mark = [0] * n
        ctx = {}
        for off, key in ((-2, "n2"), (-1, "n1"), (0, "0"), (1, "p1"),
                         (2, "p2")):
            j = v + off
            if 0 <= j < n:
                mark[j] = 1
                ctx[key] = sent[j]
            else:
                ctx[key] = "bos" if off < 0 else "eos"
        wd = self.word_dict
        word_idx = [wd.get(w, self.UNK_IDX) for w in sent]
        out = [word_idx]
        for key in ("n2", "n1", "0", "p1", "p2"):
            out.append([wd.get(ctx[key], self.UNK_IDX)] * n)
        out.append([self.predicate_dict.get(self.predicates[idx])] * n)
        out.append(mark)
        out.append([self.label_dict[l] for l in labels])
        return tuple(np.asarray(a, "int64") for a in out)

    def get_dict(self):
        return self.word_dict, self.predicate_dict, self.label_dict
