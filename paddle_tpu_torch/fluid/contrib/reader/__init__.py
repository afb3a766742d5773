"""fluid.contrib.reader (counterpart of paddle_tpu/fluid/contrib/reader;
Paddle's fluid/contrib/reader/distributed_reader.py): shard a batch
reader across trainers."""

import os

__all__ = ["distributed_batch_reader"]


def distributed_batch_reader(batch_reader):
    """Each trainer keeps every num_trainers-th batch, offset by its
    trainer id (PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM env contract,
    same as the reference)."""
    trainer_id = int(os.environ.get("PADDLE_TRAINER_ID", 0))
    trainers = int(os.environ.get("PADDLE_TRAINERS_NUM", 1))

    def reader():
        for i, batch in enumerate(batch_reader()):
            if i % trainers == trainer_id:
                yield batch

    return reader
