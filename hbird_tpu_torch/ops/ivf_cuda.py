"""K2 on the GPU: the wrapper of the probed-leaf top-k CUDA kernel.

Counterpart of hbird_tpu/ops/ivf.py::pallas_ivf_knn (the TPU kernel
`_ivf_kernel`) in all its forms: f32 or bf16 slabs, int8 codes under int8
queries, int8 codes under bf16 queries (asymmetric), and the per-slot
`row_scale` epilogue on int8 slabs. The kernel source is
ops/csrc/ivf_topk.cu; ops/cuda_build.py compiles it with `nvcc` for sm_90a
into a shared library with a plain C interface at first use, and it is
loaded with ctypes.

Every form runs K1's persistent wgmma kernel over (probe split, 64-query
tile) items (ops/csrc/wgmma_topk.cuh) at every depth: f32 (3xTF32), bf16,
int8 (with or without row scales; the exact integer sum converted to f32
once) and bf16 queries on int8 codes (asym, asym_rows). The kernel keeps
the queries in shared memory where they fit and streams each query chunk
beside its slab chunk past that (f32 always, bf16 past D = 1,536, int8 past
3,072, asym past 1,152; `knn_cuda.route(lib, queries, bank, "ivf_topk")`
names the kernel a call runs). `plan_probe_splits` cuts each tile's probe
list so the rounds of items fill the SMs, and the partial sets are merged
in a second pass.

`ivf_topk` takes the kernel for CUDA tensors and the plain version
(ops/ivf.py::ivf_search_plain) for CPU tensors, and nothing else: a CUDA
tensor either launches the kernel or raises. Invalid combinations raise
`ValueError` on every device. `ivf_topk.launches` counts kernel launches,
`ivf_topk.forms` the same launches by form (ops/knn_cuda.py::form_name).
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import torch

from hbird_tpu_torch.ops import cuda_build
from hbird_tpu_torch.ops.ivf import ivf_search_plain
from hbird_tpu_torch.ops.knn_cuda import (
    FORMS, MAX_PARTS_BYTES, MIN_FILL, form_name, route, wgmma_scratch,
)

MAX_K = 128
BLOCK = 64  # queries per CTA: block_q must be a multiple of it on the card
MIN_PROBES_PER_SPLIT = 4  # a probe split's slabs, against its item's query load
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
)


def plan_probe_splits(n_q: int, n_probe: int, n_sm: int, k: int) -> int:
    """How many splits the wgmma kernel cuts each tile's probe list into
    (ceil(n_probe / splits) probes each, the last may hold fewer), giving
    n_q / 64 * splits work items that `n_sm` persistent CTAs take in rounds:
    the fewest whose rounds keep at least MIN_FILL of the SMs busy; failing
    that, the best fill (fewest among equals). Each split keeps
    MIN_PROBES_PER_SPLIT probes where it can, and the partial sets' scratch
    stays under MAX_PARTS_BYTES."""
    q_tiles = -(-n_q // BLOCK)
    per_split = 2 * 32 * (-(-k // 32)) * 8 * n_q  # bytes of scratch per split
    most = max(1, min(n_probe // MIN_PROBES_PER_SPLIT, MAX_PARTS_BYTES // per_split))
    best = None
    for want in range(1, most + 1):
        splits = -(-n_probe // -(-n_probe // want)) if n_probe else 1
        items = q_tiles * splits
        fill = items / (-(-items // n_sm) * n_sm)
        if fill >= MIN_FILL:
            return splits
        if best is None or fill > best[0]:
            best = (fill, splits)
    return best[1]


def _check(queries, ivf_bank, leaf_ids, leaf_valid, k, cap, block_q, row_scale) -> None:
    if queries.ndim != 2 or ivf_bank.ndim != 2:
        raise ValueError(f"queries and bank must be 2-D: {queries.shape}, {ivf_bank.shape}")
    if queries.shape[1] != ivf_bank.shape[1]:
        raise ValueError(f"depth mismatch: {queries.shape} vs {ivf_bank.shape}")
    if (queries.dtype, ivf_bank.dtype) not in FORMS:
        raise ValueError(
            "queries and bank must be f32/f32, bf16/bf16, int8/int8 or bf16/int8: "
            f"{queries.dtype}, {ivf_bank.dtype}"
        )
    if row_scale is not None:
        if ivf_bank.dtype != torch.int8:
            raise ValueError("row_scale requires an int8 bank")
        if row_scale.numel() != ivf_bank.shape[0]:
            raise ValueError(
                f"row_scale has {row_scale.numel()} entries for {ivf_bank.shape[0]} slots"
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
    for t in (ivf_bank, leaf_ids, leaf_valid, row_scale):
        if t is not None and t.device != queries.device:
            raise ValueError(f"queries on {queries.device}, an input on {t.device}")
    # The kernel reads the queries and slabs through TMA tensor maps, whose
    # base must be 16-byte aligned: a view into a larger allocation (a slab
    # shard of a meshed tree) must start on 16 bytes, or be copied first
    # (parallel/sharded_ivf.py::shard_ivf_state does).
    if queries.device.type == "cuda" and (queries.data_ptr() % 16 or ivf_bank.data_ptr() % 16):
        raise ValueError("the K2 kernel needs 16-byte aligned queries and bank (TMA tensor maps)")


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
        queries: (Q, D) f32, bf16 or int8 codes, Q = n_tiles * block_q.
        ivf_bank: (n_slabs * cap, D) leaf-contiguous slabs on the same
            device: the queries' dtype, or int8 codes under int8 or bf16
            queries.
        leaf_ids: (n_tiles, n_probe) int slab ids scanned by each query tile.
        leaf_valid: (n_slabs,) int real rows per slab.
        k: neighbours per query, 1..128.
        row_scale: (n_slabs * cap,) or (n_slabs * cap, 1) per-slot scales of
            int8 slabs; each score is multiplied by its slot's scale.

    Returns:
        (values (Q, k) f32, IVF slot ids (Q, k) int64), sorted by value
        descending, then slot ascending; unfilled slots are (-inf, 0).
    """
    _check(queries, ivf_bank, leaf_ids, leaf_valid, k, cap, block_q, row_scale)
    if queries.device.type == "cpu":
        return ivf_search_plain(
            queries, ivf_bank, leaf_ids, leaf_valid, k, cap=cap, row_scale=row_scale
        )
    if queries.device.type != "cuda":
        raise ValueError(f"ivf_topk runs on CUDA or CPU tensors, not {queries.device}")
    if block_q < BLOCK or block_q % BLOCK:
        raise ValueError(f"the K2 kernel needs block_q a multiple of {BLOCK}: {block_q}")
    if not (queries.is_contiguous() and ivf_bank.is_contiguous()):
        raise ValueError("ivf_topk needs contiguous queries and bank")
    d = queries.shape[1]
    step = 16 if ivf_bank.dtype == torch.int8 else 8  # 16-byte rows of the staged vectors
    if d % step:
        raise ValueError(f"the K2 kernel needs a depth divisible by {step} for this form: {d}")
    if ivf_bank.shape[0] >= 2**31:
        raise ValueError(f"the K2 kernel takes fewer than 2^31 slots: {ivf_bank.shape[0]}")
    lids = leaf_ids.to(torch.int32).contiguous()
    lvalid = leaf_valid.to(torch.int32).contiguous()
    scale = row_scale.reshape(-1).float().contiguous() if row_scale is not None else None
    n_q = queries.shape[0]
    vals = torch.empty((n_q, k), dtype=torch.float32, device=queries.device)
    idx = torch.empty((n_q, k), dtype=torch.int64, device=queries.device)
    if n_q == 0:
        return vals, idx
    lib = cuda_build.load("ivf_topk.cu", "ivf_topk_launch", _ARGTYPES)
    form = FORMS[(queries.dtype, ivf_bank.dtype)]
    n_probe = lids.shape[1]
    route(lib, queries, ivf_bank, "ivf_topk")
    n_sm = torch.cuda.get_device_properties(queries.device).multi_processor_count
    splits = plan_probe_splits(n_q, n_probe, n_sm, k)
    parts, thr, work, work_ctas = wgmma_scratch(lib, "ivf_topk", n_q, splits, k, queries.device)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ivf_topk_launch(
            queries.data_ptr(), ivf_bank.data_ptr(),
            scale.data_ptr() if scale is not None else None,
            lids.data_ptr(), lvalid.data_ptr(), vals.data_ptr(), idx.data_ptr(),
            n_q, lvalid.shape[0], cap, d, block_q, n_probe, k, form,
            parts.data_ptr(), thr.data_ptr(), work.data_ptr(), work_ctas, splits, stream,
        )
    if err != 0:
        raise RuntimeError(f"K2 launch failed: CUDA error {err}")
    ivf_topk.launches += 1
    ivf_topk.forms[form_name(queries, ivf_bank, False, row_scale)] += 1
    return vals, idx


ivf_topk.launches = 0
ivf_topk.forms = collections.Counter()
