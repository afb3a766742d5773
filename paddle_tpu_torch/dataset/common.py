"""dataset.common (counterpart of paddle_tpu/dataset/common.py; Paddle's
python/paddle/dataset/common.py): md5,
reader splitting, cluster file readers.  `download` keeps the name but
raises — this build is zero-egress."""

import glob
import hashlib
import os
import pickle

__all__ = ["DATA_HOME", "md5file", "download", "split",
           "cluster_files_reader"]

DATA_HOME = os.path.expanduser("~/.cache/paddle/dataset")


def must_mkdirs(path):
    os.makedirs(path, exist_ok=True)


def md5file(fname):
    hash_md5 = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            hash_md5.update(chunk)
    return hash_md5.hexdigest()


def download(url, module_name, md5sum, save_name=None):
    """Zero-egress build: the classic API downloaded here; we point the
    user at the local-path arguments instead."""
    raise RuntimeError(
        f"paddle.dataset.{module_name}: this build runs zero-egress — "
        f"fetch {url} on a connected machine and pass its local path "
        "to the reader (every reader takes the archive path(s) the "
        "vision / text Dataset classes take)")


def split(reader, line_count, suffix="%05d.pickle", dumper=pickle.dump):
    """Split a reader's samples into chunked files of `line_count`
    (reference common.py:132)."""
    indx_f = 0
    batch = []
    for sample in reader():
        batch.append(sample)
        if len(batch) == line_count:
            with open(suffix % indx_f, "wb") as f:
                dumper(batch, f)
            batch = []
            indx_f += 1
    if batch:
        with open(suffix % indx_f, "wb") as f:
            dumper(batch, f)


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=pickle.load):
    """Read this trainer's shard of the split files (reference
    common.py:170): file list sorted, strided by trainer_count."""

    def reader():
        flist = sorted(glob.glob(files_pattern))
        my = flist[trainer_id::trainer_count]
        for fn in my:
            with open(fn, "rb") as f:
                for sample in loader(f):
                    yield sample

    return reader
