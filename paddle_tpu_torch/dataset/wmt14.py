"""dataset.wmt14 (reference python/paddle/dataset/wmt14.py)."""

from ..text.datasets import WMT14
from ._shim import dataset_reader

__all__ = ["train", "test"]


def train(data_file=None, dict_size=30000):
    return dataset_reader(WMT14(data_file, mode="train",
                                dict_size=dict_size))


def test(data_file=None, dict_size=30000):
    return dataset_reader(WMT14(data_file, mode="test",
                                dict_size=dict_size))
