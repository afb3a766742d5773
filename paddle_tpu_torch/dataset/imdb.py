"""dataset.imdb (reference python/paddle/dataset/imdb.py): readers
yield (token id list, 0/1 label)."""

from ..text.datasets import Imdb
from ._shim import dataset_reader

__all__ = ["train", "test", "word_dict"]


def _as_list(sample):
    doc, label = sample
    return doc.tolist(), int(label)


def train(data_path=None, cutoff=150):
    return dataset_reader(Imdb(data_path, mode="train", cutoff=cutoff),
                          _as_list)


def test(data_path=None, cutoff=150):
    return dataset_reader(Imdb(data_path, mode="test", cutoff=cutoff),
                          _as_list)


def word_dict(data_path=None, cutoff=150):
    return Imdb.build_dict(data_path, cutoff=cutoff)
