"""K2 on the GPU: the wrapper of the probed-leaf top-k CUDA kernel.

Counterpart of hbird_tpu/ops/ivf.py::pallas_ivf_knn (the TPU kernel
`_ivf_kernel`) in its bf16/f32 form. The kernel source is
ops/csrc/ivf_topk.cu; ops/cuda_build.py compiles it with `nvcc` for sm_90a
into a shared library with a plain C interface at first use, and it is
loaded with ctypes.

`ivf_topk` takes the kernel for CUDA tensors and the plain version
(ops/ivf.py::ivf_search_plain) for CPU tensors, and nothing else: a CUDA
tensor either launches the kernel or raises. `ivf_topk.launches` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from hbird_tpu_torch.ops import cuda_build
from hbird_tpu_torch.ops.ivf import ivf_search_plain

MAX_K = 128
BLOCK = 64  # queries per CTA: block_q must be a multiple of it on the card
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
)


def _check(queries, ivf_bank, leaf_ids, leaf_valid, k, cap, block_q) -> None:
    if queries.ndim != 2 or ivf_bank.ndim != 2:
        raise ValueError(f"queries and bank must be 2-D: {queries.shape}, {ivf_bank.shape}")
    if queries.shape[1] != ivf_bank.shape[1]:
        raise ValueError(f"depth mismatch: {queries.shape} vs {ivf_bank.shape}")
    if queries.dtype in (torch.int8, torch.uint8) or ivf_bank.dtype in (torch.int8, torch.uint8):
        raise NotImplementedError(
            "int8 leaf slabs are K2's int8 forms (ROADMAP.md, TPU kernels K2)"
        )
    if queries.dtype != ivf_bank.dtype or ivf_bank.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"queries and bank must share dtype float32 or bfloat16: "
            f"{queries.dtype}, {ivf_bank.dtype}"
        )
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}]: {k}")
    if cap < 1 or ivf_bank.shape[0] % cap:
        raise ValueError(f"bank rows {ivf_bank.shape[0]} are not slabs of cap={cap}")
    n_slabs = ivf_bank.shape[0] // cap
    if leaf_ids.ndim != 2 or leaf_ids.shape[0] * block_q != queries.shape[0]:
        raise ValueError(
            f"leaf_ids {tuple(leaf_ids.shape)} must hold one row per {block_q}-query "
            f"tile of {queries.shape[0]} queries"
        )
    if tuple(leaf_valid.shape) != (n_slabs,):
        raise ValueError(f"leaf_valid must have shape ({n_slabs},): {tuple(leaf_valid.shape)}")
    for t in (ivf_bank, leaf_ids, leaf_valid):
        if t.device != queries.device:
            raise ValueError(f"queries on {queries.device}, an input on {t.device}")


def ivf_topk(
    queries: torch.Tensor,
    ivf_bank: torch.Tensor,
    leaf_ids: torch.Tensor,
    leaf_valid: torch.Tensor,
    k: int,
    *,
    cap: int,
    block_q: int,
    row_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probed-leaf top-k by dot product, fused (K2).

    Args:
        queries: (Q, D) f32 or bf16, Q = n_tiles * block_q.
        ivf_bank: (n_slabs * cap, D) leaf-contiguous slabs, same dtype and
            device as `queries`.
        leaf_ids: (n_tiles, n_probe) int slab ids scanned by each query tile.
        leaf_valid: (n_slabs,) int real rows per slab.
        k: neighbours per query, 1..128.
        row_scale: the int8 epilogue's per-row scales, a later K2 form; raises.

    Returns:
        (values (Q, k) f32, IVF slot ids (Q, k) int64), sorted by value
        descending, then slot ascending; unfilled slots are (-inf, 0).
    """
    if row_scale is not None:
        raise NotImplementedError(
            "row_scale is K2's int8_rows form (ROADMAP.md, TPU kernels K2)"
        )
    _check(queries, ivf_bank, leaf_ids, leaf_valid, k, cap, block_q)
    if queries.device.type == "cpu":
        return ivf_search_plain(queries, ivf_bank, leaf_ids, leaf_valid, k, cap=cap)
    if queries.device.type != "cuda":
        raise ValueError(f"ivf_topk runs on CUDA or CPU tensors, not {queries.device}")
    if block_q < BLOCK or block_q % BLOCK:
        raise ValueError(f"the K2 kernel needs block_q a multiple of {BLOCK}: {block_q}")
    if not (queries.is_contiguous() and ivf_bank.is_contiguous()):
        raise ValueError("ivf_topk needs contiguous queries and bank")
    d = queries.shape[1]
    if d % 8:
        raise ValueError(f"the K2 kernel needs a depth divisible by 8: {d}")
    if queries.data_ptr() % 16 or ivf_bank.data_ptr() % 16:
        raise ValueError("the K2 kernel needs 16-byte aligned queries and bank")
    if ivf_bank.shape[0] >= 2**31:
        raise ValueError(f"the K2 kernel takes fewer than 2^31 slots: {ivf_bank.shape[0]}")
    lids = leaf_ids.to(torch.int32).contiguous()
    lvalid = leaf_valid.to(torch.int32).contiguous()
    n_q = queries.shape[0]
    vals = torch.empty((n_q, k), dtype=torch.float32, device=queries.device)
    idx = torch.empty((n_q, k), dtype=torch.int64, device=queries.device)
    if n_q == 0:
        return vals, idx
    lib = cuda_build.load("ivf_topk.cu", "ivf_topk_launch", _ARGTYPES)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ivf_topk_launch(
            queries.data_ptr(), ivf_bank.data_ptr(), lids.data_ptr(), lvalid.data_ptr(),
            vals.data_ptr(), idx.data_ptr(),
            n_q, lvalid.shape[0], cap, d, block_q, lids.shape[1], k,
            int(queries.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"K2 launch failed: CUDA error {err}")
    ivf_topk.launches += 1
    return vals, idx


ivf_topk.launches = 0
