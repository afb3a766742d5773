"""dataset.uci_housing (reference python/paddle/dataset/
uci_housing.py)."""

from ..text.datasets import UCIHousing
from ._shim import dataset_reader

__all__ = ["train", "test"]


def train(data_path=None):
    return dataset_reader(UCIHousing(data_path, mode="train"))


def test(data_path=None):
    return dataset_reader(UCIHousing(data_path, mode="test"))
