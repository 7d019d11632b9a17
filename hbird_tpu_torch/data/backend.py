"""Byte sources for datasets stored as folders or tar archives.

The tar path mirrors the reference's stream-without-extraction capability
(reference hbird/data/voc/voc_tar_data.py:177-289): member names are
scanned once up front, and each loader *worker* lazily opens its own tar
handle. The reference achieves per-worker handles via fork + pickle-safe
__getstate__ (voc_tar_data.py:279-283); our loader uses threads, so the
equivalent isolation is a `threading.local` handle — tarfile objects are
not safe for concurrent use.
"""

from __future__ import annotations

import io
import os
import tarfile
import threading
from typing import Dict, List, Optional, Tuple

from PIL import Image

TAR_SUFFIXES = (".tar", ".tar.gz", ".tgz", ".tar.bz2", ".tbz2", ".tar.xz", ".txz")


def looks_like_tar(path: str) -> bool:
    return path.lower().endswith(TAR_SUFFIXES)


def norm_member(name: str) -> str:
    return name[2:] if name.startswith("./") else name


def is_native_tar(path: str) -> bool:
    """An uncompressed archive, which the native header scan reads."""
    return path.lower().endswith(".tar")


def native_tar_files(tar_path: str) -> List[Tuple[str, int, int]]:
    """(name, payload offset, size) of each regular file of an
    uncompressed tar, by the native header scan (utils/native.py); raises
    when the library cannot be built or loaded."""
    from hbird_tpu_torch.utils import native

    return [(name, off, size) for name, off, size, tf in native.tar_index(tar_path) if tf in ("0", "\x00")]


def stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


class FolderBackend:
    """Reads files from a directory tree."""

    def __init__(self, root: str):
        self.root = root

    def read(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def open_image(self, path: str) -> Image.Image:
        return Image.open(path)


class TarBackend:
    """Reads members from a tar archive.

    Uncompressed tars (`.tar`): the native C++ header scan
    (native/hbird_native.cpp) builds a name -> (offset, size) index once,
    and member payloads are served by pread(2) on a per-thread file
    descriptor, with no Python header parsing on the hot path. A `.tar`
    whose library cannot be built or loaded raises. Compressed tars, which
    the native scan cannot read, use one lazily-opened tarfile handle per
    thread.
    """

    def __init__(self, tar_path: str):
        self.tar_path = tar_path
        self._local = threading.local()
        self._index: Optional[Dict[str, Tuple[int, int]]] = None
        if is_native_tar(tar_path):
            self._index = {norm_member(name): (off, size) for name, off, size in native_tar_files(tar_path)}
            self.members: List[str] = sorted(self._index)
            return
        with tarfile.open(tar_path, "r:*") as t:
            self.members = [norm_member(m.name) for m in t.getmembers() if m.isfile()]

    def _tar(self) -> tarfile.TarFile:
        t = getattr(self._local, "tar", None)
        if t is None:
            t = tarfile.open(self.tar_path, "r:*")
            self._local.tar = t
        return t

    def _fd(self) -> int:
        fd = getattr(self._local, "fd", None)
        if fd is None:
            fd = os.open(self.tar_path, os.O_RDONLY)
            self._local.fd = fd
        return fd

    def read(self, member: str) -> bytes:
        if self._index is not None:
            entry = self._index.get(norm_member(member))
            if entry is None:
                raise FileNotFoundError(f"{member} not in {self.tar_path}")
            offset, size = entry
            return os.pread(self._fd(), size, offset)
        t = self._tar()
        try:
            f = t.extractfile(member)
        except KeyError:
            f = t.extractfile("./" + member)
        if f is None:
            raise FileNotFoundError(f"{member} not in {self.tar_path}")
        with f:
            return f.read()

    def open_image(self, member: str) -> Image.Image:
        return Image.open(io.BytesIO(self.read(member)))

    # Pickle-safety for process workers (the reference's pattern for forked
    # torch workers, voc_tar_data.py:279-283): per-thread handles/fds never
    # cross process boundaries.
    def __getstate__(self):
        state = self.__dict__.copy()
        state["_local"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._local = threading.local()

    # Threads die with the process; handles are closed by GC. Provide an
    # explicit close (this thread's handle and descriptor).
    def close(self):
        t = getattr(self._local, "tar", None)
        if t is not None:
            t.close()
            self._local.tar = None
        fd = getattr(self._local, "fd", None)
        if fd is not None:
            os.close(fd)
            self._local.fd = None


def make_backend(root: str):
    return TarBackend(root) if looks_like_tar(root) else FolderBackend(root)


def pair_by_stem(images: List[str], masks: List[str]):
    """Intersect two file lists by basename stem, sorted (reference
    voc_tar_data.py:312-328)."""
    img_map = {stem(p): p for p in images}
    mask_map = {stem(p): p for p in masks}
    common = sorted(set(img_map) & set(mask_map))
    return [img_map[s] for s in common], [mask_map[s] for s in common]
