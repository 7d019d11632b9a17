"""Memory-bank and built-tree persistence.

Counterpart of hbird_tpu/bank/io.py, with its on-disk formats, so that each
package reads what the other writes. Formats by extension:

    .npy          numpy array (f32)
    .npz          numpy archive, key 'memory' (f32)
    .pt/.pth/.bin torch.save of the f32 tensor (read: torch.load)
    .bankdir      chunked directory: manifest.json + chunk_NNNNN.npy
    .treedir      a BUILT IVF index (slabs, labels, centroids, layout)
    other         treated as .npy

Savers take CPU or CUDA tensors (or numpy arrays) and pull rows to the host
one chunk at a time; loaders place rows straight onto a device, one chunk
at a time, so no whole-bank host array exists on either side of a
.bankdir or .treedir.

bfloat16 on disk: numpy has no bfloat16 without `ml_dtypes`, which this
package does not use. A bf16 .bankdir holds uint16 bit patterns under the
manifest dtype "bfloat16" (the JAX package's writer stores raw 2-byte void
chunks under the same name; both are read by viewing the bytes as uint16).
A .treedir's slabs are uint16 bits under the slab manifest dtype "uint16",
with "bfloat16" in tree_meta.json, as the JAX package writes them. Flat
files widen bf16 to f32: they carry no dtype to view the bits back with.

`load_memory_sharded(..., mesh=)` reads a .bankdir straight into padded
row shards over a mesh's bank axis (parallel/), and `load_tree_state(...,
mesh=)` a .treedir into whole-leaf shards (parallel/sharded_ivf.py's
layout). A meshed tree's slabs and labels are written shard by shard
(`_save_rows_distributed`, the JAX package's multi-process format, chunk
files named by their first global row): on a mesh over several processes
each writes its own shards and process 0 the manifests and the meta, and
the files are those one process holding every shard writes.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from hbird_tpu_torch.device import resolve_device
from hbird_tpu_torch.parallel import distributed

SHARDED_MANIFEST = "manifest.json"
TREE_META = "tree_meta.json"


def _dtype_name(dtype) -> str:
    """numpy's name of a torch or numpy dtype ('float32', 'bfloat16', ...)."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            return "bfloat16"
        return torch.empty((), dtype=dtype).numpy().dtype.name
    return np.dtype(dtype).name


def _torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a manifest dtype name (uint16 bit patterns are
    kept as int16, a dtype torch takes from numpy in every version)."""
    if name == "bfloat16":
        return torch.bfloat16
    if name == "uint16":
        return torch.int16
    return torch.from_numpy(np.empty(0, np.dtype(name))).dtype


def _host_block(block) -> np.ndarray:
    """A block of rows as a host numpy array for np.save: torch tensors
    (any device) come to the host here, bf16 as its uint16 bit patterns."""
    if isinstance(block, torch.Tensor):
        block = block.detach()
        if block.dtype == torch.bfloat16:
            return block.view(torch.int16).cpu().numpy().view(np.uint16)
        return block.cpu().numpy()
    return np.asarray(block)


def _as_tensor(block: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A stored block (read from disk) as a CPU tensor of the manifest's
    dtype: 2-byte void or uint16 bits under 'bfloat16' are viewed back."""
    if dtype_name == "bfloat16":
        bits = np.array(block).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    if block.dtype.name == "uint16":
        return torch.from_numpy(np.array(block).view(np.int16))
    return torch.from_numpy(np.array(block))


def memory_path_on_disk(path: str) -> Optional[str]:
    """The file or directory a bank saved at `path` lives in, or None
    (save_memory appends '.npy' to paths without a known extension)."""
    if os.path.isdir(path) and os.path.isfile(os.path.join(path, SHARDED_MANIFEST)):
        return path
    for p in (path, path + ".npy"):
        if os.path.isfile(p):
            return p
    return None


def save_memory(memory, path: str) -> str:
    """Write the bank; returns the path written ('.npy' is appended when
    `path` has no known extension). '.bankdir' paths are chunked."""
    if path.endswith(".bankdir"):
        return save_memory_sharded(memory, path)
    if isinstance(memory, torch.Tensor):
        memory = memory.detach().float().cpu().numpy()
    memory = np.asarray(memory, np.float32)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    if path.endswith(".npz"):
        np.savez(path, memory=memory)
    elif path.endswith((".pt", ".pth", ".bin")):
        torch.save(torch.from_numpy(np.ascontiguousarray(memory)), path)
    else:
        path = path if path.endswith(".npy") else path + ".npy"
        np.save(path, memory)
    return path


def load_memory(path: str, *, device=None) -> torch.Tensor:
    """A saved bank as an f32 tensor on `device` (default: CUDA; pass
    device='cpu' for a host tensor). A .bankdir is assembled on the device
    chunk by chunk."""
    dev = resolve_device(device)
    if is_sharded_path(path):
        return load_memory_sharded(path, dtype=torch.float32, device=dev)
    if path.endswith(".npz"):
        with np.load(path) as z:
            arr = np.asarray(z["memory"], np.float32)
    elif path.endswith((".pt", ".pth", ".bin")):
        t = torch.load(path, map_location="cpu", weights_only=True)
        return t.detach().float().to(dev)
    else:
        arr = np.asarray(np.load(memory_path_on_disk(path) or path), np.float32)
    return torch.from_numpy(arr).to(dev)


# ---------------------------------------------------------------------------
# Chunked bank directory (.bankdir):
#   <dir>/manifest.json    {"rows", "dim", "dtype", "chunks": [{"file", "rows"}]}
#   <dir>/chunk_00000.npy  ...
# ---------------------------------------------------------------------------
def is_sharded_path(path: str) -> bool:
    return path.endswith(".bankdir") or os.path.isfile(os.path.join(path, SHARDED_MANIFEST))


def save_memory_sharded(memory, dir_path: str, *, chunk_rows: int = 262144) -> str:
    """Write a bank as a directory of row chunks and a manifest.

    `memory` is a (rows, dim) tensor on any device or numpy array (memmaps
    too), cut into `chunk_rows` chunks; or an iterable of such blocks,
    written one chunk per block. Peak host memory is one chunk."""
    os.makedirs(dir_path, exist_ok=True)
    if isinstance(memory, (torch.Tensor, np.ndarray)):
        n = memory.shape[0]
        blocks = (memory[s : min(s + chunk_rows, n)] for s in range(0, n, chunk_rows))
    else:
        blocks = memory
    chunks = []
    rows = 0
    dim = dtype = None
    for i, blk in enumerate(blocks):
        if dim is None:
            dim, dtype = int(blk.shape[1]), _dtype_name(blk.dtype)
        fname = f"chunk_{i:05d}.npy"
        np.save(os.path.join(dir_path, fname), _host_block(blk))
        chunks.append({"file": fname, "rows": int(blk.shape[0])})
        rows += int(blk.shape[0])
    with open(os.path.join(dir_path, SHARDED_MANIFEST), "w") as f:
        json.dump({"rows": rows, "dim": dim, "dtype": dtype, "chunks": chunks}, f)
    return dir_path


def sharded_memory_info(dir_path: str) -> dict:
    with open(os.path.join(dir_path, SHARDED_MANIFEST)) as f:
        return json.load(f)


def iter_memory_chunks(dir_path: str):
    """Yield (start_row, block) pairs chunk by chunk; each block is a CPU
    tensor of the manifest's dtype (one chunk read at a time)."""
    manifest = sharded_memory_info(dir_path)
    start = 0
    for c in manifest["chunks"]:
        blk = np.load(os.path.join(dir_path, c["file"]), mmap_mode="r")
        yield start, _as_tensor(blk, manifest["dtype"])
        start += c["rows"]


def _read_rows(dir_path: str, manifest: dict, start: int, stop: int, out: Optional[torch.Tensor] = None):
    """Rows [start, stop) as a CPU tensor, reading only the chunks that
    overlap them; or written into `out` (on any device), one chunk's piece
    at a time."""
    if out is None:
        out = torch.empty((stop - start, manifest["dim"]), dtype=_torch_dtype(manifest["dtype"]))
    c_start = 0
    for c in manifest["chunks"]:
        c_stop = c_start + c["rows"]
        lo, hi = max(start, c_start), min(stop, c_stop)
        if lo < hi:
            blk = np.load(os.path.join(dir_path, c["file"]), mmap_mode="r")
            piece = _as_tensor(blk[lo - c_start : hi - c_start], manifest["dtype"])
            if piece.dtype == torch.int16 and out.dtype == torch.bfloat16:
                piece = piece.view(torch.bfloat16)  # the uint16 bits of bf16 slabs
            out[lo - start : hi - start] = piece.to(out.device)
        if c_stop >= stop:
            break
        c_start = c_stop
    return out


def load_memory_sharded(dir_path: str, *, mesh=None, bank_axis: str = "bank", dtype=None, device=None):
    """A .bankdir as one tensor on `device` (default: CUDA; pass
    device='cpu' for a host tensor), in the manifest's dtype or `dtype`,
    assembled chunk by chunk: peak host memory is one chunk.

    With `mesh`: `(shards, rows)`, the rows zero-padded to
    `pad_rows_for_mesh` and split into one shard per device of the mesh's
    `bank_axis` (parallel/sharded_knn.py's layout), each read from disk
    straight onto its device (None, and not read, where another process of
    a process mesh holds it); `rows` is the real row count."""
    manifest = sharded_memory_info(dir_path)
    out_dtype = dtype or _torch_dtype(manifest["dtype"])
    if mesh is not None:
        from hbird_tpu_torch.parallel.sharded_knn import pad_rows_for_mesh

        rows, dim = manifest["rows"], manifest["dim"]
        devices = mesh.axis_devices(bank_axis)
        per = pad_rows_for_mesh(rows, len(devices)) // len(devices)
        shards = []
        for j, dev in enumerate(devices):
            if dev is None:
                shards.append(None)
                continue
            shard = torch.zeros((per, dim), dtype=out_dtype, device=dev)
            lo, hi = min(j * per, rows), min((j + 1) * per, rows)
            if hi > lo:
                shard[: hi - lo] = _read_rows(dir_path, manifest, lo, hi).to(dev).to(out_dtype)
            shards.append(shard)
        return shards, rows
    dev = resolve_device(device)
    out = torch.empty((manifest["rows"], manifest["dim"]), dtype=out_dtype, device=dev)
    for start, blk in iter_memory_chunks(dir_path):
        out[start : start + blk.shape[0]] = blk.to(out.device).to(out_dtype)
    return out


def iter_bankdir_windows(feature_dir: str, label_dir: Optional[str] = None, *, window_rows: int = 524288):
    """Yield (features (n, D), labels (n, C) or None) CPU tensors in fixed
    global-row windows, reading only the overlapping chunks of each
    directory (the two may be chunked differently). Each call returns a
    fresh generator that reads the disk again, as the streamed tree build
    needs."""
    f_info = sharded_memory_info(feature_dir)
    l_info = sharded_memory_info(label_dir) if label_dir else None
    if l_info is not None and l_info["rows"] != f_info["rows"]:
        raise ValueError(f"feature and label banks differ in rows: {f_info['rows']} != {l_info['rows']}")
    rows = f_info["rows"]
    for s in range(0, rows, window_rows):
        e = min(s + window_rows, rows)
        labs = _read_rows(label_dir, l_info, s, e) if l_info is not None else None
        yield _read_rows(feature_dir, f_info, s, e), labs


# ---------------------------------------------------------------------------
# Built-tree directory (.treedir):
#   <dir>/tree_meta.json    scalars (cap, valid_rows, bank_dtype, ...)
#   <dir>/meta.npz          centroids, leaf_valid, perm, slots (+ col_scale)
#   <dir>/slabs.bankdir/    (n_slots, D) leaf slabs; bf16 as uint16 bits
#   <dir>/labels.bankdir/   (n_slots, C) f32 soft labels (+ the per-slot
#                           int8 row scales as a last column)
# ---------------------------------------------------------------------------
def is_tree_path(path: str) -> bool:
    return path.endswith(".treedir") or os.path.isfile(os.path.join(path, TREE_META))


def tree_path_on_disk(path: str) -> Optional[str]:
    """The directory a saved tree at `path` lives in, or None."""
    if os.path.isdir(path) and os.path.isfile(os.path.join(path, TREE_META)):
        return path
    return None


def _spans_processes(shards) -> bool:
    """Whether another process holds some of these shards (None here)."""
    return any(s is None for s in shards)


def _save_rows_distributed(shards, dir_path: str, *, chunk_rows: int = 262144, dtype=None) -> None:
    """A .bankdir of row shards of equal length (a list, None where another
    process of a process mesh holds the shard): each process writes its own
    shards' rows, cut every `chunk_rows` within a shard, as
    chunk_g{first global row:012d}.npy; then (after a barrier, when the
    shards span processes) process 0 writes the manifest of every shard's
    chunks in row order, and all wait. The same files come out whichever
    process holds a shard. `dtype` casts the rows before they leave the
    device; bf16 is stored as uint16 bits."""
    os.makedirs(dir_path, exist_ok=True)
    first = next(s for s in shards if s is not None)
    rows, dim = first.shape
    chunks, stored = [], None
    for j, part in enumerate(shards):
        for s in range(0, rows, chunk_rows):
            name = f"chunk_g{j * rows + s:012d}.npy"
            chunks.append({"file": name, "rows": min(chunk_rows, rows - s)})
            if part is not None:
                blk = part[s : s + chunk_rows]
                blk = _host_block(blk if dtype is None else blk.to(dtype))
                stored = blk.dtype.name
                np.save(os.path.join(dir_path, name), blk)
    spans = _spans_processes(shards)
    if spans:
        distributed.barrier()
    if not spans or distributed.is_global_zero():
        with open(os.path.join(dir_path, SHARDED_MANIFEST), "w") as f:
            json.dump({"rows": rows * len(shards), "dim": int(dim), "dtype": stored, "chunks": chunks}, f)
    if spans:
        distributed.barrier()


def _storage_blocks(arr, chunk_rows: int, dtype=None):
    """Chunks of `arr` on the host, bf16 as uint16 bits (the .treedir's
    slab storage); `dtype` casts each chunk before it leaves the device."""
    n = arr.shape[0]
    for s in range(0, n, chunk_rows):
        blk = arr[s : min(s + chunk_rows, n)]
        if dtype is not None:
            blk = blk.to(dtype)
        yield _host_block(blk)


def save_tree_state(
    dir_path: str,
    *,
    ivf_bank: torch.Tensor,
    ivf_labels: torch.Tensor,
    centroids,
    leaf_valid,
    perm,
    slots,
    cap: int,
    valid_rows: int,
    bank_scale: Optional[float] = None,
    row_scale_in_labels: bool = False,
    col_scale=None,
    asym: bool = False,
    chunk_rows: int = 262144,
) -> str:
    """Write a built tree. Slabs and labels may live on the card; they are
    pulled to the host one chunk at a time. A meshed tree's slabs and
    labels (lists of shards) are written shard by shard
    (`_save_rows_distributed`); on a mesh over several processes every
    process calls this with the same small arrays, writes its own shards,
    and process 0 writes the meta files."""
    os.makedirs(dir_path, exist_ok=True)
    slab_dir, label_dir = os.path.join(dir_path, "slabs.bankdir"), os.path.join(dir_path, "labels.bankdir")
    meshed = isinstance(ivf_bank, (list, tuple))
    spans = meshed and _spans_processes(ivf_bank)
    if meshed:
        first = next(s for s in ivf_bank if s is not None)
        n_slots, dim = len(ivf_bank) * first.shape[0], first.shape[1]
        _save_rows_distributed(ivf_bank, slab_dir, chunk_rows=chunk_rows)
        _save_rows_distributed(ivf_labels, label_dir, chunk_rows=chunk_rows, dtype=torch.float32)
        labels_c = next(s for s in ivf_labels if s is not None).shape[1]
    else:
        first = ivf_bank
        n_slots, dim = ivf_bank.shape
        save_memory_sharded(_storage_blocks(ivf_bank, chunk_rows), slab_dir)
        save_memory_sharded(_storage_blocks(ivf_labels, chunk_rows, torch.float32), label_dir)
        labels_c = ivf_labels.shape[1]
    if spans and not distributed.is_global_zero():
        distributed.barrier()
        return dir_path

    def host(x, dtype):
        if isinstance(x, (list, tuple)):
            x = torch.cat([t.detach().cpu() for t in x])
        x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        return x.astype(dtype)

    meta_arrays = dict(
        centroids=host(centroids, np.float32),
        leaf_valid=host(leaf_valid, np.int32),
        perm=host(perm, np.int32),
        slots=host(slots, np.int32),
    )
    if col_scale is not None:
        meta_arrays["col_scale"] = host(col_scale, np.float32)
    np.savez(os.path.join(dir_path, "meta.npz"), **meta_arrays)
    meta = {
        "version": 1,
        "cap": int(cap),
        "valid_rows": int(valid_rows),
        "n_leaves": int(n_slots // cap),
        "dim": int(dim),
        # With row_scale_in_labels the last label column holds the per-slot
        # int8 scales; n_classes counts only the label columns.
        "n_classes": int(labels_c) - int(row_scale_in_labels),
        "bank_dtype": _dtype_name(first.dtype),
        "bank_scale": None if bank_scale is None else float(bank_scale),
        "row_scale_in_labels": bool(row_scale_in_labels),
        # int8_asym trees score bf16 queries against the codes: without the
        # flag a reload would score them as int8_rows.
        "asym": bool(asym),
    }
    with open(os.path.join(dir_path, TREE_META), "w") as f:
        json.dump(meta, f)
    if spans:
        distributed.barrier()
    return dir_path


def load_tree_state(dir_path: str, *, mesh=None, bank_axis: str = "bank", device=None) -> dict:
    """A saved tree as a dict for NearestNeighborSearchApprox.from_tree_state,
    every array a tensor on `device` (default: CUDA). Slabs and labels are
    assembled on the device chunk by chunk (peak device memory: the slabs,
    the labels and one chunk; peak host memory: one chunk).

    With `mesh`, the slabs, labels (and row scales) are lists of whole-leaf
    shards, each read from disk straight onto its device of the mesh's
    `bank_axis`; a leaf count the axis does not divide raises ValueError
    (a leaf would straddle two shards)."""
    dev = resolve_device(device)
    with open(os.path.join(dir_path, TREE_META)) as f:
        meta = json.load(f)
    bf16 = meta["bank_dtype"] == "bfloat16"  # stored as uint16 bits
    slab_dir, label_dir = os.path.join(dir_path, "slabs.bankdir"), os.path.join(dir_path, "labels.bankdir")
    if mesh is not None:
        devices = mesh.axis_devices(bank_axis)
        p = len(devices)
        if meta["n_leaves"] % p:
            raise ValueError(
                f"the tree has {meta['n_leaves']} leaves, not divisible by the mesh's {bank_axis!r} axis "
                f"({p}): leaves would straddle shard boundaries"
            )
        local = meta["n_leaves"] // p * meta["cap"]

        def shards(path, dtype):
            info = sharded_memory_info(path)
            return [None if d is None else _read_rows(path, info, j * local, (j + 1) * local,
                                                      out=torch.empty((local, info["dim"]), dtype=dtype, device=d))
                    for j, d in enumerate(devices)]  # None: another process's shard

        slabs = shards(slab_dir, torch.bfloat16 if bf16 else _torch_dtype(meta["bank_dtype"]))
        labels = shards(label_dir, torch.float32)
    else:
        slabs = load_memory_sharded(slab_dir, device=dev)
        if bf16 and slabs.dtype != torch.bfloat16:
            slabs = slabs.view(torch.bfloat16)
        labels = load_memory_sharded(label_dir, dtype=torch.float32, device=dev)
    row_scale = None
    if meta.get("row_scale_in_labels", False):
        split = (lambda f: [None if x is None else f(x) for x in labels]) if mesh is not None else (lambda f: f(labels))
        row_scale = split(lambda x: x[:, -1:].contiguous())
        labels = split(lambda x: x[:, :-1].contiguous())
    with np.load(os.path.join(dir_path, "meta.npz")) as z:
        arrays = {name: torch.from_numpy(z[name]).to(dev) for name in z.files}
    return dict(
        ivf_bank=slabs,
        ivf_labels=labels,
        centroids=arrays["centroids"],
        leaf_valid=arrays["leaf_valid"],
        perm=arrays["perm"].long(),
        slots=arrays["slots"].long(),
        cap=meta["cap"],
        valid_rows=meta["valid_rows"],
        bank_scale=meta["bank_scale"],
        bank_row_scale=row_scale,
        bank_col_scale=arrays.get("col_scale"),
        n_leaves=meta["n_leaves"],
        asym=meta.get("asym", False),
    )
