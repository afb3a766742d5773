"""dataset.conll05 (reference python/paddle/dataset/conll05.py)."""

from ..text.datasets import Conll05st

__all__ = ["test", "get_dict"]


def test(data_file=None, word_dict_file=None, verb_dict_file=None,
         target_dict_file=None):
    from ._shim import dataset_reader

    return dataset_reader(Conll05st(data_file, word_dict_file,
                                    verb_dict_file, target_dict_file))


def get_dict(data_file=None, word_dict_file=None, verb_dict_file=None,
             target_dict_file=None):
    return Conll05st(data_file, word_dict_file, verb_dict_file,
                     target_dict_file).get_dict()
