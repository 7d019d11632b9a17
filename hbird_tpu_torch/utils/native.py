"""ctypes loader for the port's native host library (native/hbird_native.cpp).

Counterpart of hbird_tpu/utils/native.py, from the port's own copy of the
C++ source. The library is compiled with `g++ -O3 -shared -fPIC` at first
use into `build/hbird_tpu_torch/` (beside the package, the repository's
ignored build tree), under a name that carries a hash of the source and the
flags, so an edited source is rebuilt; a lock and an atomic rename keep
concurrent builds safe. It exposes:
- tar_index(path) -> list[(name, offset, size, typeflag)]
- hungarian(cost) -> (row_ind, col_ind)

There is no silent fallback: a failed build or load raises `RuntimeError`
with the compiler's or the loader's message. `available()` reports whether
the library builds and loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "native" / "hbird_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hbird_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_TAR_CB = ctypes.CFUNCTYPE(
    None, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_char, ctypes.c_void_p,
)


def library_path() -> Path:
    """Where the library is built: the name carries a hash of the source
    and the flags."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SRC.read_bytes())
    return BUILD_DIR / f"libhbird_native_{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library (if not built yet) and return its path; raises
    with the compiler's output when g++ fails or is missing."""
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run(
                ["g++", *CXX_FLAGS, "-o", tmp, str(SRC)], capture_output=True, text=True, timeout=300
            )
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"g++ could not build {SRC}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SRC} ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)  # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def load() -> ctypes.CDLL:
    """The library, built and loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"cannot load the native library {path}: {e}") from e
            lib.hbird_tar_index.restype = ctypes.c_int64
            lib.hbird_tar_index.argtypes = [ctypes.c_char_p, _TAR_CB, ctypes.c_void_p]
            lib.hbird_hungarian.restype = ctypes.c_int
            lib.hbird_hungarian.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
            ]
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads on this host."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def tar_index(path: str) -> List[Tuple[str, int, int, str]]:
    """Scan tar headers natively: [(member name, payload offset, size,
    typeflag)]. Uncompressed archives only; raises RuntimeError when the
    library is unavailable or the archive is malformed."""
    lib = load()
    out: List[Tuple[str, int, int, str]] = []

    @_TAR_CB
    def cb(name, offset, size, typeflag, _user):
        out.append((name.decode("utf-8", "surrogateescape"), offset, size, typeflag.decode("latin1")))

    rc = lib.hbird_tar_index(os.fsencode(path), cb, None)
    if rc < 0:
        raise RuntimeError(f"hbird_tar_index failed with {rc} for {path}")
    return out


def hungarian(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Native Jonker-Volgenant assignment (scipy-compatible interface)."""
    lib = load()
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    r, c = cost.shape
    n = min(r, c)
    row_ind = np.zeros(n, np.int64)
    col_ind = np.zeros(n, np.int64)
    n_out = lib.hbird_hungarian(
        cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        r,
        c,
        row_ind.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        col_ind.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if n_out < 0:
        raise RuntimeError("hbird_hungarian failed")
    return row_ind[:n_out], col_ind[:n_out]
