"""dataset.movielens (reference python/paddle/dataset/movielens.py)."""

from ..text.datasets import Movielens
from ._shim import dataset_reader

__all__ = ["train", "test"]


def train(data_file=None, **kw):
    return dataset_reader(Movielens(data_file, mode="train", **kw))


def test(data_file=None, **kw):
    return dataset_reader(Movielens(data_file, mode="test", **kw))
