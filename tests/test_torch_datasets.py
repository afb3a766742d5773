"""The vision and text datasets (`vision.datasets`, `text.datasets`) and
the classic reader creators of `dataset/` against paddle_tpu's on the
CPU, over toy archives in the real formats, written as
tests/test_vision_text.py writes them (IDX, CIFAR pickles, class folders,
the Flowers tgz and .mat files, the VOC devkit tar, aclImdb, PTB, ml-1m,
WMT14 / WMT16 and CoNLL-05 tars, UCI housing).

Every case reads the same files through both packages and compares
sample for sample: the same length, the same structure, each array equal
with the same dtype (exact: the parsers do the same numpy work; no
tolerance).  `download=True` / a missing path raises in both.
"""

import gzip
import io
import os
import pickle
import struct
import tarfile
import types
import zipfile

import numpy as np
import pytest

import paddle_tpu.dataset as JD
import paddle_tpu.text as JT
import paddle_tpu.vision.datasets as JV

import paddle_tpu_torch.dataset as TD
import paddle_tpu_torch.text as TT
import paddle_tpu_torch.vision.datasets as TV

PKGS = {"reference": types.SimpleNamespace(vd=JV, text=JT, ds=JD),
        "port": types.SimpleNamespace(vd=TV, text=TT, ds=TD)}


def _tar(path, members, mode="w"):
    with tarfile.open(path, mode) as tf:
        for name, body in members:
            info = tarfile.TarInfo(name)
            info.size = len(body)
            tf.addfile(info, io.BytesIO(body))
    return str(path)


def _png(arr, **kw):
    from PIL import Image

    b = io.BytesIO()
    Image.fromarray(arr, **kw).save(b, format="PNG")
    return b.getvalue()


def _jpeg(arr):
    from PIL import Image

    b = io.BytesIO()
    Image.fromarray(arr).save(b, format="JPEG")
    return b.getvalue()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Every archive once, at toy sizes: {name: path(s)}."""
    from PIL import Image
    from scipy.io import savemat

    d = tmp_path_factory.mktemp("archives")
    rng = np.random.RandomState(0)
    out = {}
    # MNIST IDX: gzipped images, plain labels
    n = 12
    imgs = rng.randint(0, 256, (n, 28, 28)).astype("uint8")
    with gzip.open(d / "imgs.idx.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with open(d / "labels.idx", "wb") as f:
        f.write(struct.pack(">II", 2049, n)
                + rng.randint(0, 10, n).astype("uint8").tobytes())
    out["mnist"] = (str(d / "imgs.idx.gz"), str(d / "labels.idx"))
    # CIFAR-10 batches (train and test) and CIFAR-100 files
    c10 = []
    for name, k in (("data_batch_1", 6), ("data_batch_2", 5),
                    ("test_batch", 4)):
        with open(d / name, "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (k, 3072)).astype(
                "uint8"), b"labels": list(rng.randint(0, 10, k))}, f)
        c10.append(str(d / name))
    out["cifar10"] = c10
    c100 = []
    for name, k in (("train", 5), ("test", 3)):
        with open(d / name, "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (k, 3072)).astype(
                "uint8"), b"fine_labels": list(rng.randint(0, 100, k))}, f)
        c100.append(str(d / name))
    out["cifar100"] = c100
    # class folders: PNGs and an .npy
    root = d / "folder"
    for cls, px in (("ants", 10), ("bees", 200)):
        os.makedirs(root / cls)
        for i in range(2):
            Image.fromarray(np.full((4, 5, 3), px + i, "uint8")).save(
                root / cls / f"{i}.png")
    np.save(root / "ants" / "extra.npy", rng.randint(0, 9, (4, 5, 3)))
    out["folder"] = str(root)
    # Flowers: jpg tgz + the two .mat files
    out["flowers"] = (
        _tar(d / "102flowers.tgz",
             [(f"jpg/image_{i:05d}.jpg", _jpeg(rng.randint(
                 0, 256, (6, 7, 3)).astype("uint8"))) for i in range(1, 6)],
             mode="w:gz"),
        str(d / "imagelabels.mat"), str(d / "setid.mat"))
    savemat(d / "imagelabels.mat",
            {"labels": np.array([[3, 1, 2, 1, 5]], "float64")})
    savemat(d / "setid.mat", {"trnid": np.array([[1, 2, 5]], "float64"),
                              "valid": np.array([[3]], "float64"),
                              "tstid": np.array([[4]], "float64")})
    # VOC2012 devkit
    voc = []
    for split, names in (("train", b"img1\nimg2\n"), ("val", b"img2\n"),
                         ("trainval", b"img1\nimg2\n")):
        voc.append((f"ImageSets/Segmentation/{split}.txt", names))
    for name in ("img1", "img2"):
        voc.append((f"JPEGImages/{name}.jpg", _jpeg(rng.randint(
            0, 256, (5, 7, 3)).astype("uint8"))))
        mask = Image.fromarray(rng.randint(0, 21, (5, 7)).astype("uint8"),
                               mode="P")
        mask.putpalette([0] * 768)
        b = io.BytesIO()
        mask.save(b, format="PNG")
        voc.append((f"SegmentationClass/{name}.png", b.getvalue()))
    out["voc"] = _tar(d / "voc.tar", [("VOCdevkit/VOC2012/" + k, v)
                                      for k, v in voc])
    # aclImdb
    out["imdb"] = _tar(d / "aclImdb.tar", [
        ("aclImdb/train/pos/0_9.txt", b"good great movie good fun"),
        ("aclImdb/train/neg/1_2.txt", b"bad awful movie bad it's"),
        ("aclImdb/train/pos/2_7.txt", b"great fun great movie"),
        ("aclImdb/test/pos/0_8.txt", b"delta good movie"),
        ("aclImdb/test/neg/3_1.txt", b"awful awful bad")])
    # UCI housing
    np.savetxt(d / "housing.data", rng.rand(20, 14).astype("float32"))
    out["uci"] = str(d / "housing.data")
    # PTB simple-examples
    out["ptb"] = _tar(d / "simple-examples.tgz", [
        (f"./simple-examples/data/ptb.{split}.txt", body) for split, body in
        (("train", b"the cat sat\nthe dog sat down\nthe cat ran\n"),
         ("valid", b"the cat sat\na dog ran\n"), ("test", b"a dog ran\n"))])
    # MovieLens ml-1m
    with zipfile.ZipFile(d / "ml-1m.zip", "w") as z:
        z.writestr("ml-1m/movies.dat",
                   "1::Toy Story (1995)::Animation|Comedy\n"
                   "2::Heat (1995)::Action\n3::Big Fish (2003)::Drama\n")
        z.writestr("ml-1m/users.dat",
                   "1::F::1::10::48067\n2::M::25::16::70072\n"
                   "3::M::56::4::11111\n")
        z.writestr("ml-1m/ratings.dat", "".join(
            f"{u}::{m}::{(u + m) % 5 + 1}::97830{u}{m}\n"
            for u in (1, 2, 3) for m in (1, 2, 3)))
    out["movielens"] = str(d / "ml-1m.zip")
    # WMT14
    pairs = b"hello world\tbonjour monde\nhello\tbonjour\nworld\tmonde x\n"
    out["wmt14"] = _tar(d / "wmt14.tgz", [
        ("wmt14/src.dict", b"<s>\n<e>\n<unk>\nhello\nworld\n"),
        ("wmt14/trg.dict", b"<s>\n<e>\n<unk>\nbonjour\nmonde\n"),
        ("wmt14/train/train", pairs), ("wmt14/test/test", pairs[:20])])
    # WMT16
    body = "hello world\thallo welt\nworld\twelt\nnew world\tneue welt\n"
    out["wmt16"] = _tar(d / "wmt16.tgz", [
        (f"wmt16/{s}", body.encode()) for s in ("train", "val", "test")])
    # CoNLL-05
    words = "The\ncat\nate\nfish\n.\n\nDogs\nbark\n\n"
    props = ("-\t(A0*\n-\t*)\neat\t(V*)\n-\t(A1*)\n-\t*\n\n"
             "-\t(A0*)\nbark\t(V*)\n\n")
    out["conll"] = (
        _tar(d / "conll05st.tar", [
            ("conll05st-release/test.wsj/words/test.wsj.words.gz",
             gzip.compress(words.encode())),
            ("conll05st-release/test.wsj/props/test.wsj.props.gz",
             gzip.compress(props.encode()))]),
        str(d / "word.dict"), str(d / "verb.dict"), str(d / "target.dict"))
    (d / "word.dict").write_text("The\ncat\nate\nfish\n.\nbos\neos\nbark\n")
    (d / "verb.dict").write_text("eat\nbark\n")
    (d / "target.dict").write_text("B-A0\nI-A0\nB-A1\nB-V\nO\n")
    return out


def _eq(a, b):
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _eq(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_eq(a[k], b[k]) for k in a)
    if isinstance(a, (np.ndarray, np.generic)):
        return np.asarray(a).dtype == np.asarray(b).dtype and \
            np.array_equal(a, b)
    return type(a) is type(b) and a == b


def _all(ds):
    return [ds[i] for i in range(len(ds))]


# name -> build(pkg, files): a Dataset, a list of samples or a dict
CLASSES = {
    "MNIST": lambda P, f: _all(P.vd.MNIST(*f["mnist"])),
    "FashionMNIST": lambda P, f: _all(P.vd.FashionMNIST(*f["mnist"])),
    "Cifar10_train": lambda P, f: _all(P.vd.Cifar10(f["cifar10"])),
    "Cifar10_test": lambda P, f: _all(P.vd.Cifar10(f["cifar10"],
                                                   mode="test")),
    "Cifar100_train": lambda P, f: _all(P.vd.Cifar100(f["cifar100"])),
    "Cifar100_test": lambda P, f: _all(P.vd.Cifar100(f["cifar100"],
                                                     mode="test")),
    "FakeData": lambda P, f: _all(P.vd.FakeData(size=6, image_shape=(
        3, 8, 8), num_classes=4, seed=2)),
    "DatasetFolder": lambda P, f: (lambda ds: (ds.classes, ds.class_to_idx,
                                               _all(ds)))(
        P.vd.DatasetFolder(f["folder"])),
    "ImageFolder": lambda P, f: _all(P.vd.ImageFolder(f["folder"])),
    "Flowers_train": lambda P, f: _all(P.vd.Flowers(*f["flowers"])),
    "Flowers_valid": lambda P, f: _all(P.vd.Flowers(*f["flowers"],
                                                    mode="valid")),
    "VOC2012_train": lambda P, f: _all(P.vd.VOC2012(f["voc"])),
    "VOC2012_val": lambda P, f: _all(P.vd.VOC2012(f["voc"], mode="val")),
    "Imdb_train": lambda P, f: (lambda ds: (ds.word_idx, _all(ds)))(
        P.text.Imdb(f["imdb"], mode="train", cutoff=1)),
    "Imdb_test": lambda P, f: _all(P.text.Imdb(f["imdb"], mode="test",
                                               cutoff=2)),
    "Imdb_build_dict": lambda P, f: P.text.Imdb.build_dict(f["imdb"], 1),
    "UCIHousing_train": lambda P, f: _all(P.text.UCIHousing(f["uci"])),
    "UCIHousing_test": lambda P, f: _all(P.text.UCIHousing(f["uci"],
                                                           mode="test")),
    "FakeTextDataset": lambda P, f: _all(P.text.FakeTextDataset(
        size=5, seq_len=7, vocab_size=50, seed=4)),
    "Imikolov_ngram": lambda P, f: (lambda ds: (ds.word_idx, _all(ds)))(
        P.text.Imikolov(f["ptb"], data_type="NGRAM", window_size=3,
                        min_word_freq=0)),
    "Imikolov_seq": lambda P, f: _all(P.text.Imikolov(
        f["ptb"], data_type="SEQ", mode="valid", min_word_freq=0)),
    "Imikolov_build_dict": lambda P, f: P.text.Imikolov.build_dict(
        f["ptb"], 0),
    "Movielens_train": lambda P, f: (lambda ds: (
        ds.categories_dict, ds.movie_title_dict, _all(ds)))(
        P.text.Movielens(f["movielens"], test_ratio=0.3, rand_seed=3)),
    "Movielens_test": lambda P, f: _all(P.text.Movielens(
        f["movielens"], mode="test", test_ratio=0.3, rand_seed=3)),
    "WMT14_train": lambda P, f: (lambda ds: (ds.get_dict(), ds.get_dict(
        reverse=True), _all(ds)))(P.text.WMT14(f["wmt14"], dict_size=5)),
    "WMT14_test": lambda P, f: _all(P.text.WMT14(f["wmt14"], mode="test",
                                                 dict_size=4)),
    "WMT16_en": lambda P, f: (lambda ds: (ds.get_dict("en"), ds.get_dict(
        "de", reverse=True), _all(ds)))(P.text.WMT16(f["wmt16"],
                                                     mode="val")),
    "WMT16_de_cut": lambda P, f: _all(P.text.WMT16(
        f["wmt16"], mode="test", src_dict_size=5, trg_dict_size=4,
        lang="de")),
    "Conll05st": lambda P, f: (lambda ds: (ds.get_dict(), _all(ds)))(
        P.text.Conll05st(*f["conll"])),
}


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_a_dataset_class_gives_the_references_samples(files, name):
    want = CLASSES[name](PKGS["reference"], files)
    got = CLASSES[name](PKGS["port"], files)
    assert _eq(got, want), name


def _read(creator):
    return list(creator())


READERS = {
    "mnist.train": lambda D, f: _read(D.mnist.train(*f["mnist"])),
    "mnist.test": lambda D, f: _read(D.mnist.test(*f["mnist"])),
    "cifar.train10": lambda D, f: _read(D.cifar.train10(f["cifar10"])),
    "cifar.test10": lambda D, f: _read(D.cifar.test10(f["cifar10"])),
    "cifar.train100": lambda D, f: _read(D.cifar.train100(f["cifar100"])),
    "cifar.test100": lambda D, f: _read(D.cifar.test100(f["cifar100"])),
    "flowers.train": lambda D, f: _read(D.flowers.train(*f["flowers"])),
    "flowers.test": lambda D, f: _read(D.flowers.test(*f["flowers"])),
    "flowers.valid": lambda D, f: _read(D.flowers.valid(*f["flowers"])),
    "voc2012.train": lambda D, f: _read(D.voc2012.train(f["voc"])),
    "voc2012.val": lambda D, f: _read(D.voc2012.val(f["voc"])),
    "voc2012.test": lambda D, f: _read(D.voc2012.test(f["voc"])),
    "imdb.train": lambda D, f: _read(D.imdb.train(f["imdb"], cutoff=1)),
    "imdb.test": lambda D, f: _read(D.imdb.test(f["imdb"], cutoff=1)),
    "imdb.word_dict": lambda D, f: D.imdb.word_dict(f["imdb"], cutoff=2),
    "imikolov.train": lambda D, f: _read(D.imikolov.train(
        f["ptb"], D.imikolov.build_dict(f["ptb"], 0), n=3)),
    "imikolov.test_seq": lambda D, f: _read(D.imikolov.test(
        f["ptb"], D.imikolov.build_dict(f["ptb"], 0), n=-1,
        data_type="SEQ")),
    "movielens.train": lambda D, f: _read(D.movielens.train(
        f["movielens"], test_ratio=0.3, rand_seed=1)),
    "movielens.test": lambda D, f: _read(D.movielens.test(
        f["movielens"], test_ratio=0.3, rand_seed=1)),
    "uci_housing.train": lambda D, f: _read(D.uci_housing.train(f["uci"])),
    "uci_housing.test": lambda D, f: _read(D.uci_housing.test(f["uci"])),
    "conll05.test": lambda D, f: _read(D.conll05.test(*f["conll"])),
    "conll05.get_dict": lambda D, f: D.conll05.get_dict(*f["conll"]),
    "wmt14.train": lambda D, f: _read(D.wmt14.train(f["wmt14"], 5)),
    "wmt14.test": lambda D, f: _read(D.wmt14.test(f["wmt14"], 5)),
    "wmt16.train": lambda D, f: _read(D.wmt16.train(f["wmt16"])),
    "wmt16.test": lambda D, f: _read(D.wmt16.test(f["wmt16"], 6, 5, "de")),
    "wmt16.validation": lambda D, f: _read(D.wmt16.validation(f["wmt16"])),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_classic_reader_gives_the_references_samples(files, name):
    want = READERS[name](PKGS["reference"].ds, files)
    got = READERS[name](PKGS["port"].ds, files)
    assert _eq(got, want), name


def test_mnist_reader_scales_to_minus_one_one(files):
    vec, label = next(TD.mnist.train(*files["mnist"])())
    assert vec.shape == (784,) and vec.dtype == np.float32
    assert -1.0 <= vec.min() and vec.max() <= 1.0 and isinstance(label, int)


@pytest.mark.parametrize("side", sorted(PKGS))
def test_a_download_raises_in_both(side):
    P = PKGS[side]
    for make in (lambda: P.vd.MNIST(download=True),
                 lambda: P.vd.Cifar10(download=True),
                 lambda: P.vd.VOC2012(download=True),
                 lambda: P.text.Imdb(download=True),
                 lambda: P.text.WMT16(download=True)):
        with pytest.raises(ValueError, match="zero-egress"):
            make()
    with pytest.raises(RuntimeError, match="zero-egress"):
        P.ds.common.download("http://x", "mnist", "0")


def test_common_split_and_cluster_reader_match(tmp_path):
    def reader():
        for i in range(10):
            yield (i, i * i)

    shards = {}
    for side, P in PKGS.items():
        suffix = str(tmp_path / f"{side}-%05d.pickle")
        P.ds.common.split(reader, 4, suffix=suffix)
        pattern = str(tmp_path / f"{side}-*.pickle")
        shards[side] = [list(P.ds.common.cluster_files_reader(
            pattern, 2, k)()) for k in range(2)]
        assert P.ds.common.md5file(suffix % 0)
    assert shards["port"] == shards["reference"]
    assert sorted(shards["port"][0] + shards["port"][1]) == \
        [(i, i * i) for i in range(10)]


def test_image_helpers_match(tmp_path):
    im = np.arange(12 * 16 * 3, dtype="uint8").reshape(12, 16, 3)
    J, T = JD.image, TD.image
    assert _eq(T.resize_short(im, 6), J.resize_short(im, 6))
    assert _eq(T.center_crop(im, 6), J.center_crop(im, 6))
    assert _eq(T.left_right_flip(im), J.left_right_flip(im))
    assert _eq(T.to_chw(im), J.to_chw(im))
    for train in (False, True):
        out = []
        for mod in (J, T):
            np.random.seed(5)
            out.append(mod.simple_transform(im, 8, 6, is_train=train,
                                            mean=[1.0, 2.0, 3.0]))
        assert _eq(out[1], out[0])
    png = _png(im)
    assert _eq(T.load_image_bytes(png), J.load_image_bytes(png))
    assert _eq(T.load_image_bytes(png, is_color=False),
               J.load_image_bytes(png, is_color=False))
    tar = _tar(tmp_path / "imgs.tar", [("a.png", png), ("b.png", _png(
        im[::-1].copy())), ("c.txt", b"x")])
    metas = {}
    for side, mod in (("reference", J), ("port", T)):
        base = tmp_path / side
        base.mkdir()
        copy = str(base / "imgs.tar")
        with open(tar, "rb") as src, open(copy, "wb") as dst:
            dst.write(src.read())
        out_dir = mod.batch_images_from_tar(copy, "toy", {"a.png": 0,
                                                           "b.png": 1},
                                            num_per_batch=1)
        batches = sorted(p for p in os.listdir(out_dir) if p != "meta")
        metas[side] = [pickle.load(open(os.path.join(out_dir, p), "rb"))
                       for p in batches]
    assert _eq(metas["port"], metas["reference"])
