"""paddle.batch (counterpart of paddle_tpu/batch.py; Paddle's
python/paddle/batch.py): wrap a sample reader into a batched reader that
yields lists of `batch_size` samples."""

__all__ = ["batch"]


def batch(reader, batch_size, drop_last=False):
    if batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got "
                         f"{batch_size}")

    def batch_reader():
        b = []
        for sample in reader():
            b.append(sample)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader
