"""paddle.vision.datasets (counterpart of paddle_tpu/vision/datasets.py;
Paddle's python/paddle/vision/datasets, which download and parse the
standard archives).

This package fetches nothing: `download=True` raises with instructions,
and the parsers read the standard file formats (IDX for MNIST, the
python-pickle batches of CIFAR, the Flowers tgz and .mat files, the VOC
devkit tar, class-per-directory image folders) from local paths.
Samples are numpy arrays on the host, the reference's; PIL and scipy are
imported only by the loaders that need them.  FakeData generates
deterministic synthetic samples for tests and benchmarks.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as np

from ..io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "FakeData",
           "DatasetFolder", "ImageFolder", "Flowers", "VOC2012"]

_NO_DOWNLOAD = ("this build runs zero-egress: download the official "
                "archive on a connected machine and pass the local "
                "path(s)")


class MNIST(Dataset):
    """IDX-format MNIST (reference vision/datasets/mnist.py).

    Pass image_path/label_path to the (optionally gzipped) idx files.
    """

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend=None):
        if download or image_path is None or label_path is None:
            raise ValueError(f"MNIST: image_path and label_path are "
                             f"required ({_NO_DOWNLOAD})")
        self.transform = transform
        self.images = self._read_images(image_path)
        self.labels = self._read_labels(label_path)
        assert len(self.images) == len(self.labels)

    @staticmethod
    def _open(path):
        return gzip.open(path, "rb") if path.endswith(".gz") \
            else open(path, "rb")

    def _read_images(self, path):
        with self._open(path) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            if magic != 2051:
                raise ValueError(f"{path}: bad IDX image magic {magic}")
            data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
            return data.reshape(n, rows, cols)

    def _read_labels(self, path):
        with self._open(path) as f:
            magic, n = struct.unpack(">II", f.read(8))
            if magic != 2049:
                raise ValueError(f"{path}: bad IDX label magic {magic}")
            return np.frombuffer(f.read(n), dtype=np.uint8).astype("int64")

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]


class FashionMNIST(MNIST):
    """Same IDX format, different archive."""


class Cifar10(Dataset):
    """CIFAR-10 python-pickle batches (reference vision/datasets/
    cifar.py): pass the batch file paths (data_batch_1..5 / test_batch).
    """

    _LABEL_KEY = b"labels"

    @staticmethod
    def _split_filter(batch_paths, names, mode):
        # mode selects the split by the archive's standard file names
        # (data_batch_* = train, test_batch = test), so passing the
        # whole extracted directory's files with mode='test' does what
        # the reference does instead of silently loading everything
        if any(n.startswith("data_batch") for n in names) and \
                any(n.startswith("test_batch") for n in names):
            want = "test_batch" if mode == "test" else "data_batch"
            return [p for p, n in zip(batch_paths, names)
                    if n.startswith(want)]
        return batch_paths

    def __init__(self, batch_paths=None, mode="train", transform=None,
                 download=False, backend=None):
        if download or not batch_paths:
            raise ValueError(f"{type(self).__name__}: batch_paths is "
                             f"required ({_NO_DOWNLOAD})")
        self.transform = transform
        names = [os.path.basename(p) for p in batch_paths]
        batch_paths = self._split_filter(batch_paths, names, mode)
        imgs, labels = [], []
        for p in batch_paths:
            with open(p, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            imgs.append(np.asarray(d[b"data"], np.uint8)
                        .reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
            labels.extend(d[self._LABEL_KEY])
        self.images = np.concatenate(imgs)
        self.labels = np.asarray(labels, "int64")

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]


class FakeData(Dataset):
    """Deterministic synthetic image dataset for tests/benchmarks."""

    def __init__(self, size=100, image_shape=(3, 32, 32), num_classes=10,
                 transform=None, seed=0):
        self.size = size
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        self.seed = seed

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed * 100003 + idx)
        img = rng.randint(0, 256, self.image_shape).astype("uint8")
        label = np.int64(rng.randint(0, self.num_classes))
        if self.transform is not None:
            img = self.transform(img)
        return img, label


class Cifar100(Cifar10):
    """CIFAR-100 python-pickle files (reference vision/datasets/
    cifar.py Cifar100): same batch format as CIFAR-10 but one
    train/test file each and 'fine_labels'."""

    _LABEL_KEY = b"fine_labels"

    @staticmethod
    def _split_filter(batch_paths, names, mode):
        if "train" in names and "test" in names:
            return [p for p, n in zip(batch_paths, names) if n == mode]
        return batch_paths


def _pil_loader(path_or_file):
    from PIL import Image

    img = Image.open(path_or_file)
    return np.asarray(img.convert("RGB"))


_IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".ppm",
                   ".tif", ".tiff", ".webp", ".npy")


def _default_loader(path):
    if path.endswith(".npy"):
        return np.load(path)
    return _pil_loader(path)


def _walk_valid_files(root, extensions, is_valid_file):
    exts = tuple(e.lower() for e in (extensions or _IMG_EXTENSIONS))
    valid = is_valid_file or (lambda p: p.lower().endswith(exts))
    out = []
    for dirpath, _, files in sorted(os.walk(root)):
        for fn in sorted(files):
            p = os.path.join(dirpath, fn)
            if valid(p):
                out.append(p)
    return out


class DatasetFolder(Dataset):
    """Class-per-subdirectory image dataset (reference
    vision/datasets/folder.py DatasetFolder): root/<class>/<img> walks
    into (image, class_index) samples; classes are sorted subdir names.
    `.npy` arrays load without PIL, everything else decodes to RGB."""

    def __init__(self, root, loader=None, extensions=None,
                 transform=None, is_valid_file=None):
        self.root = root
        self.loader = loader or _default_loader
        self.transform = transform
        self.classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        if not self.classes:
            raise RuntimeError(f"DatasetFolder: no class subdirs in "
                               f"{root}")
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples = []
        for c in self.classes:
            for p in _walk_valid_files(os.path.join(root, c),
                                       extensions, is_valid_file):
                self.samples.append((p, self.class_to_idx[c]))
        if not self.samples:
            raise RuntimeError(f"DatasetFolder: no valid files under "
                               f"{root}")

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(target)


class ImageFolder(Dataset):
    """Flat/recursive image folder WITHOUT labels (reference
    vision/datasets/folder.py ImageFolder): every valid file under
    root becomes a [image] sample."""

    def __init__(self, root, loader=None, extensions=None,
                 transform=None, is_valid_file=None):
        self.root = root
        self.loader = loader or _default_loader
        self.transform = transform
        self.samples = _walk_valid_files(root, extensions,
                                         is_valid_file)
        if not self.samples:
            raise RuntimeError(f"ImageFolder: no valid files under "
                               f"{root}")

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return [img]


class Flowers(Dataset):
    """Oxford Flowers-102 (reference vision/datasets/flowers.py):
    images tgz (jpg/image_%05d.jpg), scipy-format imagelabels.mat and
    setid.mat; mode selects the trnid/valid/tstid index list.  Labels
    are the .mat's 1-based classes shifted to 0-based int64."""

    _SETID_KEY = {"train": "trnid", "valid": "valid", "test": "tstid"}

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=False,
                 backend=None):
        import tarfile

        from scipy.io import loadmat

        if download or not all((data_file, label_file, setid_file)):
            raise ValueError(f"Flowers: data_file, label_file and "
                             f"setid_file are required ({_NO_DOWNLOAD})")
        if mode not in self._SETID_KEY:
            raise ValueError(f"Flowers: bad mode {mode!r}")
        self.transform = transform
        self.indexes = loadmat(setid_file)[self._SETID_KEY[mode]] \
            .ravel().astype("int64")
        self.labels = loadmat(label_file)["labels"].ravel() \
            .astype("int64") - 1
        # store raw JPEG bytes; decode lazily per __getitem__ (the
        # reference extracts per access too — eager decode of a real
        # 6k-image split would hold GBs resident)
        self._jpeg = {}
        wanted = set(self.indexes.tolist())
        with tarfile.open(data_file) as tf:
            for m in tf.getmembers():
                base = os.path.basename(m.name)
                if base.startswith("image_") and base.endswith(".jpg"):
                    num = int(base[len("image_"):-len(".jpg")])
                    if num in wanted:
                        self._jpeg[num] = tf.extractfile(m).read()

    def __len__(self):
        return len(self.indexes)

    def __getitem__(self, idx):
        import io as _io

        num = int(self.indexes[idx])
        img = _pil_loader(_io.BytesIO(self._jpeg[num]))
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(self.labels[num - 1])


class VOC2012(Dataset):
    """Pascal VOC2012 segmentation (reference vision/datasets/
    voc2012.py): the devkit tar's ImageSets/Segmentation/{mode}.txt
    names the split; samples are (RGB image, label mask) arrays
    decoded from JPEGImages/ and SegmentationClass/."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        import io as _io
        import tarfile

        if download or data_file is None:
            raise ValueError(f"VOC2012: data_file required "
                             f"({_NO_DOWNLOAD})")
        if mode not in ("train", "val", "trainval"):
            raise ValueError(f"VOC2012: bad mode {mode!r}")
        self.transform = transform
        # keep encoded bytes; decode lazily per __getitem__ (a real
        # trainval split is thousands of images — eager int64 masks
        # alone would be GBs)
        with tarfile.open(data_file) as tf:
            byname = {m.name.split("VOCdevkit/VOC2012/", 1)[-1]: m
                      for m in tf.getmembers()
                      if "VOCdevkit/VOC2012/" in m.name}
            split = tf.extractfile(
                byname[f"ImageSets/Segmentation/{mode}.txt"]) \
                .read().decode().split()
            self._jpeg, self._png = [], []
            for name in split:
                self._jpeg.append(tf.extractfile(
                    byname[f"JPEGImages/{name}.jpg"]).read())
                self._png.append(tf.extractfile(
                    byname[f"SegmentationClass/{name}.png"]).read())

    def __len__(self):
        return len(self._jpeg)

    def __getitem__(self, idx):
        import io as _io

        from PIL import Image

        img = _pil_loader(_io.BytesIO(self._jpeg[idx]))
        # the mask PNG is palette-encoded class ids: DON'T convert
        # to RGB
        mask = np.asarray(Image.open(_io.BytesIO(self._png[idx]))) \
            .astype("int64")
        if self.transform is not None:
            img = self.transform(img)
        return img, mask
