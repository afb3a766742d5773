"""paddle.dataset (counterpart of paddle_tpu/dataset): the classic
reader-creator API and the feed pipeline of the dataset loops.

Each reader module (Paddle's python/paddle/dataset/: mnist.py:96 train(),
uci_housing.py:91, common.py:132 split, image.py) is a thin shim over the
vision / text Dataset classes, so legacy `for sample in
paddle.dataset.mnist.train(...)():` loops keep working.  Nothing is
fetched: the readers take the local archive paths the class datasets
take, and `common.download` raises with instructions.
"""

from . import (cifar, common, conll05, flowers, image, imdb,  # noqa: F401
               imikolov, mnist, movielens, uci_housing, voc2012,
               wmt14, wmt16)
from . import feed_pipeline  # noqa: F401

__all__ = []
