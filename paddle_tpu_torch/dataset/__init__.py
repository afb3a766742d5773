"""paddle_tpu_torch.dataset (counterpart of paddle_tpu/dataset): the feed
pipeline of the dataset loops.  The readers of public datasets (cifar,
imdb, wmt16, ...) wait for ROADMAP queue 1 item 11, on synthetic data
only."""

from . import feed_pipeline  # noqa: F401
