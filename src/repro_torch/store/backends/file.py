"""FileStore: the POSIX-directory backend (current on-disk layout).

Bit-compatible with pre-backend datasets: keys map 1:1 onto the relative
paths CZDataset has always written (``p/t000000.cz``), member bytes are
written streaming through a real file handle, and ``put_atomic`` is the
store's historical manifest commit (tmp + fsync + rename + directory
fsync).  Existing datasets on disk open unchanged.
"""
from __future__ import annotations

import contextlib
import fcntl
import os

from .base import Store, StoreKeyError, check_key, check_range

__all__ = ["FileStore"]


class FileStore(Store):
    """Byte store over a local directory tree."""

    scheme = "file"

    def __init__(self, root: str):
        super().__init__()
        self.root = os.path.abspath(os.fspath(root))

    @classmethod
    def from_url(cls, rest: str) -> "FileStore":
        # file:///abs/path -> "/abs/path"; file://rel/path -> "rel/path"
        return cls(rest or ".")

    def path_for(self, key: str) -> str:
        """Local filesystem path for ``key`` (validated)."""
        return os.path.join(self.root, *check_key(key).split("/"))

    def _ensure_parent(self, path: str) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)

    # -- primitives ----------------------------------------------------------

    def get(self, key, byte_range=None):
        try:
            f = open(self.path_for(key), "rb")
        except (FileNotFoundError, IsADirectoryError, NotADirectoryError):
            raise StoreKeyError(key) from None
        with f:
            if byte_range is None:
                return f.read()
            start, end = byte_range
            start = check_range(key, start, os.fstat(f.fileno()).st_size)
            f.seek(start)
            return f.read(None if end is None else max(0, int(end) - start))

    def put(self, key, data):
        path = self.path_for(key)
        self._ensure_parent(path)
        with open(path, "wb") as f:
            f.write(data)

    def put_atomic(self, key, data):
        """tmp write + fsync + rename over the target, then fsync the parent
        directory so the rename itself is durable — the dataset's manifest
        commit protocol, unchanged from the pre-backend store."""
        path = self.path_for(key)
        self._ensure_parent(path)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dfd = os.open(os.path.dirname(path), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def list(self, prefix=""):
        out = []
        for dirpath, _dirnames, filenames in os.walk(self.root):
            rel = os.path.relpath(dirpath, self.root)
            parts = [] if rel == "." else rel.split(os.sep)
            for fn in filenames:
                key = "/".join(parts + [fn])
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def delete(self, key):
        path = self.path_for(key)
        try:
            os.unlink(path)
        except FileNotFoundError:
            raise StoreKeyError(key) from None
        # prune now-empty parent directories back up to the root, so a
        # delete-driven gc leaves no husk quantity dirs behind
        d = os.path.dirname(path)
        while len(d) > len(self.root):
            try:
                os.rmdir(d)
            except OSError:
                break
            d = os.path.dirname(d)

    def exists(self, key):
        return os.path.isfile(self.path_for(key))

    # -- derived -------------------------------------------------------------

    def open_write(self, key):
        """A real file handle: the CZ2 writer streams chunks (one in memory)
        and seeks back to patch the footer pointer — byte-identical to the
        pre-backend direct-path writer."""
        path = self.path_for(key)
        self._ensure_parent(path)
        return open(path, "wb")

    @contextlib.contextmanager
    def lock(self, name: str):
        """``flock`` on a file inside the root: exclusive across processes
        (the sidecar commit/merge serialization needs more than in-process
        locks on a shared filesystem)."""
        path = self.path_for(name)
        self._ensure_parent(path)
        fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    @property
    def url(self) -> str:
        return f"file://{self.root}"
