"""Building the port's CUDA kernels: nvcc for sm_90a into ctypes libraries.

Each kernel source in `csrc/` (K1 `knn_topk.cu`, K2 `ivf_topk.cu`, K3
`flash_attn.cu`, each including `topk_common.cuh`) compiles on its own into
a shared library with a plain C interface, at first use. The libraries go to
`build/hbird_tpu_torch/` beside the package directory (the repository's
ignored build tree); a name carries a hash of the source, the headers and
the flags, so an edited kernel is rebuilt. `build_all` starts one nvcc per
source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("knn_topk.cu", "ivf_topk.cu", "flash_attn.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hbird_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this host")


def library_path(source: str) -> Path:
    """Where the library of `source` (a file name in csrc/) is built."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / source, *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}_{digest.hexdigest()[:12]}.so"


def build(source: str, verbose: bool = False) -> Path:
    """Compile csrc/`source` (if not built yet) and return the library path."""
    lib_path = library_path(source)
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, str(CSRC / source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        if verbose:
            print(f"{source}:\n{proc.stdout}{proc.stderr}", flush=True)
        os.replace(tmp, lib_path)  # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def build_all(verbose: bool = False) -> Dict[str, Path]:
    """Build every kernel source, one nvcc each, all started together."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        futures = {s: pool.submit(build, s, verbose) for s in SOURCES}
        return {s: f.result() for s, f in futures.items()}


def load(source: str, symbol: str, argtypes) -> ctypes.CDLL:
    """The library of `source`, built and loaded once, with `symbol`'s
    argument types declared (it returns an int CUDA error code)."""
    with _lock:
        lib: Optional[ctypes.CDLL] = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _libs[source] = lib
        return lib
