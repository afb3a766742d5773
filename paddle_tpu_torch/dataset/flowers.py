"""dataset.flowers (reference python/paddle/dataset/flowers.py)."""

from ..vision.datasets import Flowers
from ._shim import dataset_reader

__all__ = ["train", "test", "valid"]


def _make(mode):
    def rd(data_file=None, label_file=None, setid_file=None):
        return dataset_reader(Flowers(data_file, label_file,
                                      setid_file, mode=mode))

    return rd


train = _make("train")
test = _make("test")
valid = _make("valid")
