"""K1 on the GPU: the wrapper of the fused kNN top-k CUDA kernel.

Counterpart of hbird_tpu/ops/knn_pallas.py::pallas_knn (the TPU kernel
`_knn_kernel`) in all its forms:
- (a) dot product, f32 x f32 or bf16 x bf16;
- (b) expanded-norm L2 (`distance='l2'`/'euclidean') on a float bank: the
  bias ||b||^2/2 is computed here in f32 on each call (`l2_bias`) and
  subtracted in the kernel's epilogue;
- (c) int8 x int8 codes: the exact integer sum (s32 accumulators),
  converted to f32 once, round to nearest even, at every depth;
- (d) `row_scale`: each score times its int8 row's f32 scale, in the
  epilogue before masking;
- (e) asymmetric: bf16 queries against int8 codes, widened to bf16 inside
  the kernel.
f32 operands are scored at f32 accuracy on the TF32 tensor cores, in three
passes (3xTF32: each operand split into TF32 big and small parts).
The kernel source is ops/csrc/knn_topk.cu; ops/cuda_build.py compiles it
with `nvcc` for sm_90a into a shared library with a plain C interface at
first use, and it is loaded with ctypes.

`knn_topk` takes the kernel for CUDA tensors and the plain version
(ops/knn.py::exact_knn) for CPU tensors, and nothing else: a CUDA tensor
either launches the kernel or raises. Invalid combinations raise
`ValueError` on every device, as the JAX asserts do. `knn_topk.launches`
counts kernel launches, `knn_topk.forms` the same launches by form
(`form_name`).

Every form runs one persistent wgmma kernel over (bank split, 64-query
tile) items, at every depth and every k, and merges the splits' partial top
sets in a second pass from the same entry point. `plan_splits` picks the
split size here, the same plan for every element type (the same items and
tiles), so the rounds of items fill the SMs. The partial sets
(`parts_shape`), the per-query minimum keys they share and the select's
per-CTA scratch (`wgmma_scratch`: each consumer warp's running sets and
candidate buffers) are allocated here. That kernel keeps bf16, int8 and
asym queries in shared memory where they fit and streams each query chunk
beside its bank chunk past that (bf16 past D = 1,536, int8 past 3,072,
bf16 queries on int8 codes past 1,152; f32 queries always stream), so
every form runs it at every depth (`knn_topk_wgmma_smem` reports its
shared memory). `route` names the kernel a call runs. K2 (ops/ivf_cuda.py)
runs the same kernel over its probed slabs.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import torch

from hbird_tpu_torch.ops import cuda_build
from hbird_tpu_torch.ops.knn import L2_DISTANCES, exact_knn, l2_bias

MAX_K = 128
# (queries, bank) dtypes the kernel takes, and the form code it is passed.
FORMS = {
    (torch.float32, torch.float32): 0,
    (torch.bfloat16, torch.bfloat16): 1,
    (torch.int8, torch.int8): 2,
    (torch.bfloat16, torch.int8): 3,
}
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
)
# The wgmma kernel's tiling: 64 queries an item, 128 bank rows a tile.
WGMMA_BLOCK_Q = 64
WGMMA_BLOCK_M = 128
MIN_FILL = 0.9  # least share of the SMs' rounds of items that do work
MIN_TILES_PER_SPLIT = 4  # a split's bank tiles, against its item's query load
MAX_PARTS_BYTES = 512 << 20  # scratch of the partial top sets


def plan_splits(n_q: int, valid_rows: int, n_sm: int, k: int) -> Tuple[int, int]:
    """(split_rows, splits) of the wgmma kernel: the valid rows cut into
    `splits` ranges of `split_rows` (a multiple of 128; the last may be
    shorter), giving ceil(n_q / 64) * splits work items that `n_sm`
    persistent CTAs take in rounds. The fewest splits whose rounds keep at
    least MIN_FILL of the SMs busy (items / (rounds * n_sm)); failing that,
    the best fill (fewest splits among equals). Every split costs each query
    two more partial top sets to fill, so fewer is better once the card is
    full. Each split keeps MIN_TILES_PER_SPLIT tiles where it can, and the
    scratch stays under MAX_PARTS_BYTES."""
    tiles = -(-valid_rows // WGMMA_BLOCK_M)
    if tiles == 0:
        return WGMMA_BLOCK_M, 1
    q_tiles = -(-n_q // WGMMA_BLOCK_Q)
    per_split = 2 * 32 * (-(-k // 32)) * 8 * n_q  # bytes of scratch per split
    most = max(1, min(tiles // MIN_TILES_PER_SPLIT, MAX_PARTS_BYTES // per_split))
    best = None
    for want in range(1, most + 1):
        per = -(-tiles // want)
        splits = -(-tiles // per)
        items = q_tiles * splits
        fill = items / (-(-items // n_sm) * n_sm)
        if fill >= MIN_FILL:
            return per * WGMMA_BLOCK_M, splits
        if best is None or fill > best[0]:
            best = (fill, per * WGMMA_BLOCK_M, splits)
    return best[1], best[2]


def parts_shape(n_q: int, splits: int, k: int) -> Tuple[int, int, int]:
    """Shape of the wgmma kernel's scratch: per query, two partial sets (one
    per consumer warpgroup) per split of 32 * ceil(k / 32) 64-bit keys."""
    return n_q, 2 * splits, 32 * (-(-k // 32))


def wgmma_scratch(lib, prefix: str, n_q: int, splits: int, k: int, device):
    """(parts, thr, work, work_ctas) of the wgmma kernel of `lib` (K1's or
    K2's, entry points named `prefix`_*): the partial sets, the per-query
    minimum keys they share (zeros), and one CTA's select scratch
    (`prefix`_work_keys(k) keys) for each SM, the most CTAs it runs."""
    work_keys = getattr(lib, f"{prefix}_work_keys")
    work_keys.argtypes, work_keys.restype = (ctypes.c_int,), ctypes.c_int
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    parts = torch.empty(parts_shape(n_q, splits, k), dtype=torch.int64, device=device)
    thr = torch.zeros(n_q, dtype=torch.int64, device=device)
    work = torch.empty(n_sm * work_keys(k), dtype=torch.int64, device=device)
    return parts, thr, work, n_sm


def wgmma_smem(lib, prefix: str, d: int, form: int) -> int:
    """Shared memory of `lib`'s wgmma kernel for `form` at depth d."""
    fn = getattr(lib, f"{prefix}_wgmma_smem")
    fn.argtypes, fn.restype = (ctypes.c_int, ctypes.c_int), ctypes.c_int
    return fn(d, form)


def form_name(queries: torch.Tensor, bank: torch.Tensor, l2: bool, row_scale) -> str:
    """The K1 form a call runs: 'dot', 'l2' (bf16), 'f32', 'f32_l2',
    'int8', 'int8_rows', 'asym' or 'asym_rows'."""
    if bank.dtype == torch.float32:
        return "f32_l2" if l2 else "f32"
    if bank.dtype != torch.int8:
        return "l2" if l2 else "dot"
    base = "int8" if queries.dtype == torch.int8 else "asym"
    return base + ("_rows" if row_scale is not None else "")


def route(lib, queries: torch.Tensor, bank: torch.Tensor, prefix: str = "knn_topk") -> str:
    """The kernel a CUDA call of these operands runs in `lib` (K1's, or K2's
    with prefix 'ivf_topk'): 'wgmma', where the library reports shared
    memory for the form at this depth, as it does for every form at every
    depth; raises where it reports none."""
    form = FORMS[(queries.dtype, bank.dtype)]
    if wgmma_smem(lib, prefix, queries.shape[1], form) <= 0:
        raise RuntimeError(f"{prefix} reports no kernel for form {form} at depth {queries.shape[1]}")
    return "wgmma"


def _check(queries, bank, k, valid_rows, distance, row_scale) -> None:
    if queries.ndim != 2 or bank.ndim != 2:
        raise ValueError(f"queries and bank must be 2-D: {queries.shape}, {bank.shape}")
    if queries.shape[1] != bank.shape[1]:
        raise ValueError(f"depth mismatch: {queries.shape} vs {bank.shape}")
    if (queries.dtype, bank.dtype) not in FORMS:
        raise ValueError(
            "queries and bank must be f32/f32, bf16/bf16, int8/int8 or bf16/int8: "
            f"{queries.dtype}, {bank.dtype}"
        )
    if distance not in ("dot_product", *L2_DISTANCES):
        raise ValueError(f"distance must be 'dot_product', 'l2' or 'euclidean': {distance!r}")
    if distance in L2_DISTANCES and (bank.dtype == torch.int8 or row_scale is not None):
        raise ValueError("l2 requires a float bank and no row_scale")
    if row_scale is not None:
        if bank.dtype != torch.int8:
            raise ValueError("row_scale requires an int8 bank")
        if row_scale.numel() != bank.shape[0]:
            raise ValueError(f"row_scale has {row_scale.numel()} entries for {bank.shape[0]} rows")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}]: {k}")
    if not 0 <= valid_rows <= bank.shape[0]:
        raise ValueError(f"valid_rows must be in [0, {bank.shape[0]}]: {valid_rows}")
    for t in (bank, row_scale):
        if t is not None and t.device != queries.device:
            raise ValueError(f"queries on {queries.device}, an input on {t.device}")


def knn_topk(
    queries: torch.Tensor,
    bank: torch.Tensor,
    k: int,
    *,
    valid_rows: Optional[int] = None,
    distance: str = "dot_product",
    row_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k, fused (K1).

    Args:
        queries: (Q, D) f32, bf16 or int8 codes.
        bank: (M, D) on the same device: the queries' dtype, or int8 codes
            under int8 or bf16 queries.
        k: neighbours per query, 1..128.
        valid_rows: real bank rows (defaults to M); later rows never win.
        distance: 'dot_product', or 'l2'/'euclidean' on a float bank.
        row_scale: (M,) or (M, 1) per-row scales of an int8 bank.

    Returns:
        (values (Q, k) f32, indices (Q, k) int64), sorted by value
        descending, then index ascending; unfilled slots are (-inf, 0).
    """
    valid = bank.shape[0] if valid_rows is None else int(valid_rows)
    _check(queries, bank, k, valid, distance, row_scale)
    if queries.device.type == "cpu":
        return exact_knn(
            queries, bank, k, distance=distance, valid_rows=valid, row_scale=row_scale
        )
    if queries.device.type != "cuda":
        raise ValueError(f"knn_topk runs on CUDA or CPU tensors, not {queries.device}")
    if not (queries.is_contiguous() and bank.is_contiguous()):
        raise ValueError("knn_topk needs contiguous queries and bank")
    d = queries.shape[1]
    step = 16 if bank.dtype == torch.int8 else 8  # 16-byte rows of the staged vectors
    if d % step:
        raise ValueError(f"the K1 kernel needs a depth divisible by {step} for this form: {d}")
    if queries.data_ptr() % 16 or bank.data_ptr() % 16:
        raise ValueError("the K1 kernel needs 16-byte aligned queries and bank")
    l2 = distance in L2_DISTANCES
    bias = l2_bias(bank).contiguous() if l2 else None
    scale = row_scale.reshape(-1).float().contiguous() if row_scale is not None else None
    n_q, m = queries.shape[0], bank.shape[0]
    vals = torch.empty((n_q, k), dtype=torch.float32, device=queries.device)
    idx = torch.empty((n_q, k), dtype=torch.int64, device=queries.device)
    if n_q == 0:
        return vals, idx
    lib = cuda_build.load("knn_topk.cu", "knn_topk_launch", _ARGTYPES)
    route(lib, queries, bank)
    n_sm = torch.cuda.get_device_properties(queries.device).multi_processor_count
    split_rows, splits = plan_splits(n_q, valid, n_sm, k)
    parts, thr, work, work_ctas = wgmma_scratch(lib, "knn_topk", n_q, splits, k, queries.device)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.knn_topk_launch(
            queries.data_ptr(), bank.data_ptr(),
            scale.data_ptr() if scale is not None else None,
            bias.data_ptr() if bias is not None else None,
            vals.data_ptr(), idx.data_ptr(),
            n_q, m, d, valid, k, FORMS[(queries.dtype, bank.dtype)],
            parts.data_ptr(), thr.data_ptr(), work.data_ptr(), work_ctas, split_rows, stream,
        )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {err}")
    knn_topk.launches += 1
    knn_topk.forms[form_name(queries, bank, l2, row_scale)] += 1
    return vals, idx


knn_topk.launches = 0
knn_topk.forms = collections.Counter()
