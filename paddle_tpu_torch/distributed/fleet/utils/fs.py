"""Filesystem abstraction (counterpart of paddle_tpu/distributed/fleet/
utils/fs.py: FS, LocalFS, HDFSClient).  Checkpoint and dataset code
takes an `fs` object; LocalFS covers a local or mounted path.
HDFSClient keeps the reference's API shape but raises: there is no
hadoop CLI here; use LocalFS over a mounted path."""

from __future__ import annotations

import os
import shutil


class FSFileExistsError(Exception):
    pass


class FSFileNotExistsError(Exception):
    pass


class FS:
    """Abstract interface (reference fs.py FS:44)."""

    def ls_dir(self, fs_path):
        raise NotImplementedError

    def is_file(self, fs_path):
        raise NotImplementedError

    def is_dir(self, fs_path):
        raise NotImplementedError

    def is_exist(self, fs_path):
        raise NotImplementedError

    def mkdirs(self, fs_path):
        raise NotImplementedError

    def delete(self, fs_path):
        raise NotImplementedError

    def need_upload_download(self):
        raise NotImplementedError

    def touch(self, fs_path, exist_ok=True):
        raise NotImplementedError

    def mv(self, fs_src_path, fs_dst_path, overwrite=False,
           test_exists=False):
        raise NotImplementedError

    def list_dirs(self, fs_path):
        raise NotImplementedError


class LocalFS(FS):
    """Local/POSIX filesystem (reference fs.py LocalFS:116)."""

    def ls_dir(self, fs_path):
        """Returns (dirs, files) under fs_path."""
        if not self.is_exist(fs_path):
            return [], []
        dirs, files = [], []
        for entry in os.listdir(fs_path):
            if os.path.isdir(os.path.join(fs_path, entry)):
                dirs.append(entry)
            else:
                files.append(entry)
        return dirs, files

    def mkdirs(self, fs_path):
        assert not os.path.isfile(fs_path), f"{fs_path} is already a file"
        os.makedirs(fs_path, exist_ok=True)

    def rename(self, fs_src_path, fs_dst_path):
        os.rename(fs_src_path, fs_dst_path)

    def delete(self, fs_path):
        if os.path.isfile(fs_path):
            os.remove(fs_path)
        elif os.path.isdir(fs_path):
            shutil.rmtree(fs_path)

    def need_upload_download(self):
        return False

    def is_file(self, fs_path):
        return os.path.isfile(fs_path)

    def is_dir(self, fs_path):
        return os.path.isdir(fs_path)

    def is_exist(self, fs_path):
        return os.path.exists(fs_path)

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if not exist_ok:
                raise FSFileExistsError(fs_path)
            return
        with open(fs_path, "a"):
            pass

    def mv(self, src_path, dst_path, overwrite=False, test_exists=False):
        if not self.is_exist(src_path):
            raise FSFileNotExistsError(src_path)
        if overwrite and self.is_exist(dst_path):
            self.delete(dst_path)
        if self.is_exist(dst_path):
            raise FSFileExistsError(dst_path)
        os.rename(src_path, dst_path)

    def list_dirs(self, fs_path):
        if not self.is_exist(fs_path):
            return []
        return [e for e in os.listdir(fs_path)
                if os.path.isdir(os.path.join(fs_path, e))]


class HDFSClient(FS):
    """API-shape stand-in for the reference's HDFSClient: there is no
    hadoop CLI here, so construction fails loudly instead of letting
    checkpoint writes disappear."""

    def __init__(self, hadoop_home=None, configs=None, *args, **kwargs):
        raise NotImplementedError(
            "HDFSClient is unavailable (no hadoop CLI). Mount the store "
            "as a POSIX path and use LocalFS")
