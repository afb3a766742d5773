"""dataset.imikolov (reference python/paddle/dataset/imikolov.py)."""

from ..text.datasets import Imikolov
from ._shim import dataset_reader

__all__ = ["train", "test", "build_dict"]


def train(data_path=None, word_idx=None, n=5, data_type="NGRAM"):
    return dataset_reader(Imikolov(data_path, data_type=data_type,
                                   window_size=n, mode="train",
                                   word_idx=word_idx))


def test(data_path=None, word_idx=None, n=5, data_type="NGRAM"):
    return dataset_reader(Imikolov(data_path, data_type=data_type,
                                   window_size=n, mode="valid",
                                   word_idx=word_idx))


def build_dict(data_path=None, min_word_freq=50):
    return Imikolov.build_dict(data_path, min_word_freq)
