"""K1 on the GPU: the wrapper of the fused kNN top-k CUDA kernel.

Counterpart of hbird_tpu/ops/knn_pallas.py::pallas_knn (the TPU kernel
`_knn_kernel`). The kernel source is ops/csrc/knn_topk.cu; ops/cuda_build.py
compiles it with `nvcc` for sm_90a into a shared library with a plain C
interface at first use, and it is loaded with ctypes.

`knn_topk` takes the kernel for CUDA tensors and the plain version
(ops/knn.py::exact_knn) for CPU tensors, and nothing else: a CUDA tensor
either launches the kernel or raises. `knn_topk.launches` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from hbird_tpu_torch.ops import cuda_build
from hbird_tpu_torch.ops.knn import exact_knn

MAX_K = 128
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
)


def _check(queries: torch.Tensor, bank: torch.Tensor, k: int, valid_rows: int) -> None:
    if queries.ndim != 2 or bank.ndim != 2:
        raise ValueError(f"queries and bank must be 2-D: {queries.shape}, {bank.shape}")
    if queries.shape[1] != bank.shape[1]:
        raise ValueError(f"depth mismatch: {queries.shape} vs {bank.shape}")
    if queries.dtype in (torch.int8, torch.uint8) or bank.dtype in (torch.int8, torch.uint8):
        raise NotImplementedError(
            "int8 banks and queries are K1 sub-slices (c) and (e) "
            "(ROADMAP.md, TPU kernels K1)"
        )
    if queries.dtype != bank.dtype or bank.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"queries and bank must share dtype float32 or bfloat16: "
            f"{queries.dtype}, {bank.dtype}"
        )
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}]: {k}")
    if not 0 <= valid_rows <= bank.shape[0]:
        raise ValueError(f"valid_rows must be in [0, {bank.shape[0]}]: {valid_rows}")
    if queries.device != bank.device:
        raise ValueError(f"queries on {queries.device}, bank on {bank.device}")


def knn_topk(
    queries: torch.Tensor,
    bank: torch.Tensor,
    k: int,
    *,
    valid_rows: Optional[int] = None,
    distance: str = "dot_product",
    row_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by dot product, fused (K1).

    Args:
        queries: (Q, D) f32 or bf16.
        bank: (M, D), same dtype and device as `queries`.
        k: neighbours per query, 1..128.
        valid_rows: real bank rows (defaults to M); later rows never win.
        distance / row_scale: only 'dot_product' without row scales exists
            yet; the others are later K1 sub-slices and raise.

    Returns:
        (values (Q, k) f32, indices (Q, k) int64), sorted by value
        descending, then index ascending; unfilled slots are (-inf, 0).
    """
    if distance != "dot_product":
        raise NotImplementedError(
            f"distance={distance!r}: the l2 form is K1 sub-slice (b) "
            "(ROADMAP.md, TPU kernels K1)"
        )
    if row_scale is not None:
        raise NotImplementedError(
            "row_scale is K1 sub-slice (d) (ROADMAP.md, TPU kernels K1)"
        )
    valid = bank.shape[0] if valid_rows is None else int(valid_rows)
    _check(queries, bank, k, valid)
    if queries.device.type == "cpu":
        return exact_knn(queries, bank, k, valid_rows=valid)
    if queries.device.type != "cuda":
        raise ValueError(f"knn_topk runs on CUDA or CPU tensors, not {queries.device}")
    if not (queries.is_contiguous() and bank.is_contiguous()):
        raise ValueError("knn_topk needs contiguous queries and bank")
    d = queries.shape[1]
    if d % 8:
        raise ValueError(f"the K1 kernel needs a depth divisible by 8: {d}")
    if queries.data_ptr() % 16 or bank.data_ptr() % 16:
        raise ValueError("the K1 kernel needs 16-byte aligned queries and bank")
    n_q, m = queries.shape[0], bank.shape[0]
    vals = torch.empty((n_q, k), dtype=torch.float32, device=queries.device)
    idx = torch.empty((n_q, k), dtype=torch.int64, device=queries.device)
    if n_q == 0:
        return vals, idx
    lib = cuda_build.load("knn_topk.cu", "knn_topk_launch", _ARGTYPES)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.knn_topk_launch(
            queries.data_ptr(), bank.data_ptr(), vals.data_ptr(), idx.data_ptr(),
            n_q, m, d, valid, k, int(queries.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {err}")
    knn_topk.launches += 1
    return vals, idx


knn_topk.launches = 0
