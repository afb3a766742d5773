"""fleet.utils — the filesystem abstraction."""

from .fs import FS, LocalFS, HDFSClient, FSFileExistsError, FSFileNotExistsError  # noqa: F401

__all__ = ["FS", "LocalFS", "HDFSClient", "FSFileExistsError",
           "FSFileNotExistsError"]
