"""File enumeration and file-set reading over folders and tar archives.

Behavioral parity with reference hbird/utils/io.py:7-103, including the
`archive.tar!/inner/path` addressing DSL.
"""

from __future__ import annotations

import os
import tarfile
from pathlib import Path
from typing import List, Tuple


def split_tar_path(path: str) -> Tuple[str, str]:
    """Split 'x/archive.tar!/inner/dir' into ('x/archive.tar', 'inner/dir').

    Mirrors the reference's split-on-'.tar' convention (io.py:28-32).
    """
    tar_path, inner = path.split(".tar", 1)
    return tar_path + ".tar", inner.lstrip("!/")


def is_tar_path(path: str) -> bool:
    return ".tar" in path


def _tar_member_files(tar_path: str) -> List[str]:
    """Regular-file member names of a tar archive: by the native header scan
    for an uncompressed one (raising if the library cannot be built), by
    tarfile for a compressed one."""
    from hbird_tpu_torch.data.backend import is_native_tar, native_tar_files

    if is_native_tar(tar_path):
        return [name for name, _off, _size in native_tar_files(tar_path)]
    with tarfile.open(tar_path, "r:*") as tar:
        return [m.name for m in tar.getmembers() if m.isfile()]


def list_files(path: str) -> List[str]:
    """List filenames under a folder, which may live inside a .tar archive.

    Returns paths relative to the given folder.
    """
    if is_tar_path(path):
        tar_path, inner_path = split_tar_path(path)
        if not Path(tar_path).is_file():
            raise FileNotFoundError(f"tar archive does not exist: {tar_path}")
        names = _tar_member_files(tar_path)
        files = []
        for name in names:
            if name.startswith(inner_path):
                rel = os.path.relpath(name, inner_path)
                if not rel.startswith(".."):
                    files.append(rel)
        return files

    if not os.path.isdir(path):
        raise NotADirectoryError(f"expected a directory, got: {path}")
    return [
        os.path.relpath(os.path.join(root, f), start=path)
        for root, _, fs in os.walk(path)
        for f in fs
    ]


def read_file_set(path: str) -> List[str]:
    """Read stripped lines from a text file on disk or inside a tar archive."""
    if is_tar_path(path):
        tar_path, inner_path = split_tar_path(path)
        if not Path(tar_path).is_file():
            raise FileNotFoundError(f"tar archive does not exist: {tar_path}")
        with tarfile.open(tar_path, "r:*") as tar:
            try:
                member = tar.getmember(inner_path)
            except KeyError:
                raise FileNotFoundError(
                    f"tar archive {tar_path} has no member {inner_path!r}"
                )
            f = tar.extractfile(member)
            if f is None:
                raise IOError(f"member {inner_path!r} in {tar_path} is not a readable file")
            return [line.strip() for line in f.read().decode("utf-8").splitlines()]
    with open(path, "r", encoding="utf-8") as f:
        return [x.strip() for x in f.readlines()]
