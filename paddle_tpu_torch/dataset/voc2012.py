"""dataset.voc2012 (reference python/paddle/dataset/voc2012.py)."""

from ..vision.datasets import VOC2012
from ._shim import dataset_reader

__all__ = ["train", "test", "val"]


def train(data_file=None):
    return dataset_reader(VOC2012(data_file, mode="train"))


def val(data_file=None):
    return dataset_reader(VOC2012(data_file, mode="val"))


def test(data_file=None):
    # the reference maps 'test' onto trainval (the real test split is
    # held out by the challenge)
    return dataset_reader(VOC2012(data_file, mode="trainval"))
