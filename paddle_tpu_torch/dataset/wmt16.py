"""dataset.wmt16 (reference python/paddle/dataset/wmt16.py)."""

from ..text.datasets import WMT16
from ._shim import dataset_reader

__all__ = ["train", "test", "validation"]


def train(data_file=None, src_dict_size=-1, trg_dict_size=-1,
          src_lang="en"):
    return dataset_reader(WMT16(data_file, "train", src_dict_size,
                                trg_dict_size, src_lang))


def test(data_file=None, src_dict_size=-1, trg_dict_size=-1,
         src_lang="en"):
    return dataset_reader(WMT16(data_file, "test", src_dict_size,
                                trg_dict_size, src_lang))


def validation(data_file=None, src_dict_size=-1, trg_dict_size=-1,
               src_lang="en"):
    return dataset_reader(WMT16(data_file, "val", src_dict_size,
                                trg_dict_size, src_lang))
