"""paddle.text (counterpart of paddle_tpu/text): the text datasets
(Paddle's python/paddle/text/datasets: Imdb, UCIHousing, WMT14, ...).
The parsers read the standard local file formats; FakeTextDataset
synthesizes token streams for tests."""

from . import datasets  # noqa: F401
from .datasets import (Conll05st, FakeTextDataset, Imdb,  # noqa: F401
                       Imikolov, Movielens, UCIHousing, WMT14, WMT16)
