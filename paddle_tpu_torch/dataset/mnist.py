"""dataset.mnist (reference python/paddle/dataset/mnist.py): readers
yield (784-vector float32 scaled to [-1, 1], int label) — the classic
normalization (mnist.py:42 reader_creator) over the IDX parser in
vision.datasets.MNIST."""

from ..vision.datasets import MNIST
from ._shim import dataset_reader

__all__ = ["train", "test"]


def _norm(sample):
    img, label = sample
    flat = img.reshape(-1).astype("float32")
    return flat / 127.5 - 1.0, int(label)


def train(image_path=None, label_path=None):
    return dataset_reader(
        MNIST(image_path, label_path, mode="train"), _norm)


def test(image_path=None, label_path=None):
    return dataset_reader(
        MNIST(image_path, label_path, mode="test"), _norm)
