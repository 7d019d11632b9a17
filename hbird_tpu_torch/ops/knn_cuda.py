"""K1 on the GPU: the wrapper of the fused kNN top-k CUDA kernel.

Counterpart of hbird_tpu/ops/knn_pallas.py::pallas_knn (the TPU kernel
`_knn_kernel`) in all its forms:
- (a) dot product, f32 x f32 or bf16 x bf16;
- (b) expanded-norm L2 (`distance='l2'`/'euclidean') on a float bank: the
  bias ||b||^2/2 is computed here in f32 on each call (`l2_bias`) and
  subtracted in the kernel's epilogue;
- (c) int8 x int8 codes, int32 accumulation converted once to f32;
- (d) `row_scale`: each score times its int8 row's f32 scale, in the
  epilogue before masking;
- (e) asymmetric: bf16 queries against int8 codes, widened to bf16 inside
  the kernel.
The kernel source is ops/csrc/knn_topk.cu; ops/cuda_build.py compiles it
with `nvcc` for sm_90a into a shared library with a plain C interface at
first use, and it is loaded with ctypes.

`knn_topk` takes the kernel for CUDA tensors and the plain version
(ops/knn.py::exact_knn) for CPU tensors, and nothing else: a CUDA tensor
either launches the kernel or raises. Invalid combinations raise
`ValueError` on every device, as the JAX asserts do. `knn_topk.launches`
counts kernel launches, `knn_topk.forms` the same launches by form.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import torch

from hbird_tpu_torch.ops import cuda_build
from hbird_tpu_torch.ops.knn import L2_DISTANCES, exact_knn, l2_bias

MAX_K = 128
# int8 x int8 scores stay exact in f32 only while 127^2 * D < 2^24.
MAX_INT8_DEPTH = 1024
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
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)


def form_name(queries: torch.Tensor, bank: torch.Tensor, l2: bool, row_scale) -> str:
    """The K1 form a call runs: 'dot', 'l2', 'int8', 'int8_rows', 'asym'
    or 'asym_rows'."""
    if bank.dtype != torch.int8:
        return "l2" if l2 else "dot"
    base = "int8" if queries.dtype == torch.int8 else "asym"
    return base + ("_rows" if row_scale is not None else "")


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
    if queries.dtype == torch.int8 and queries.shape[1] > MAX_INT8_DEPTH:
        raise ValueError(
            f"int8 x int8 scores are exact in f32 only up to D = {MAX_INT8_DEPTH}: "
            f"{queries.shape[1]}"
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
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.knn_topk_launch(
            queries.data_ptr(), bank.data_ptr(),
            scale.data_ptr() if scale is not None else None,
            bias.data_ptr() if bias is not None else None,
            vals.data_ptr(), idx.data_ptr(),
            n_q, m, d, valid, k, FORMS[(queries.dtype, bank.dtype)], stream,
        )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {err}")
    knn_topk.launches += 1
    knn_topk.forms[form_name(queries, bank, l2, row_scale)] += 1
    return vals, idx


knn_topk.launches = 0
knn_topk.forms = collections.Counter()
