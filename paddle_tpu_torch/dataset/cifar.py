"""dataset.cifar (reference python/paddle/dataset/cifar.py): readers
yield (3072-vector float32 in [0,1], int label)."""

from ..vision.datasets import Cifar10, Cifar100
from ._shim import dataset_reader

__all__ = ["train10", "test10", "train100", "test100"]


def _norm(sample):
    img, label = sample
    return (img.transpose(2, 0, 1).reshape(-1).astype("float32")
            / 255.0, int(label))


def train10(batch_paths=None):
    return dataset_reader(Cifar10(batch_paths, mode="train"), _norm)


def test10(batch_paths=None):
    return dataset_reader(Cifar10(batch_paths, mode="test"), _norm)


def train100(batch_paths=None):
    return dataset_reader(Cifar100(batch_paths, mode="train"), _norm)


def test100(batch_paths=None):
    return dataset_reader(Cifar100(batch_paths, mode="test"), _norm)
