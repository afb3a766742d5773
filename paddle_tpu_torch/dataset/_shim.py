"""Shared shim: wrap a vision / text Dataset instance as the classic
no-arg reader generator (reference dataset modules yield samples from
`train()()` loops)."""


def dataset_reader(ds, mapper=None):
    def reader():
        for i in range(len(ds)):
            s = ds[i]
            yield mapper(s) if mapper is not None else s

    return reader
