"""Exact k-nearest-neighbour search: the plain PyTorch version of K1.

Counterpart of hbird_tpu/ops/knn.py::exact_knn and of the single-device
branch of hbird_tpu/parallel/sharded_knn.py::sharded_knn_with_labels.

`exact_knn` is a blockwise `torch.matmul` over bank tiles with f32
accumulation and a running top-k merge, so the (Q, M) score matrix is
never materialised. It is what the CPU tests compare with the JAX package
and what `chip_smoke.py` holds the CUDA kernel (ops/knn_cuda.py) against;
on the engine's path it runs only for CPU tensors.

Semantics shared with the kernel:
- scores are q·b in f32 (bf16 inputs are widened; their products are
  exact in f32);
- bank rows at or past `valid_rows` never win;
- unfilled slots (fewer than k valid rows) hold value -inf and index 0;
- results are sorted by value descending, then bank index ascending.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = float("-inf")


def exact_knn(
    queries: torch.Tensor,
    bank: torch.Tensor,
    k: int,
    *,
    valid_rows: Optional[int] = None,
    query_block: int = 1024,
    bank_block: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k neighbours of each query by dot product.

    Args:
        queries: (Q, D) f32 or bf16. NOT normalized (reference parity).
        bank: (M, D) memory bank (rows may be padded; see valid_rows).
        k: neighbours per query.
        valid_rows: number of real rows in `bank` (defaults to M).
        query_block / bank_block: tile sizes.

    Returns:
        (values (Q, k) f32, indices (Q, k) int64), on the inputs' device.
    """
    n_q = queries.shape[0]
    m = bank.shape[0]
    valid = m if valid_rows is None else max(0, min(int(valid_rows), m))
    dev = queries.device
    out_v = torch.empty((n_q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_q, k), dtype=torch.int64, device=dev)
    for q0 in range(0, n_q, query_block):
        qb = queries[q0 : q0 + query_block].float()
        n = qb.shape[0]
        vals = torch.full((n, k), NEG_INF, dtype=torch.float32, device=dev)
        idx = torch.zeros((n, k), dtype=torch.int64, device=dev)
        # Tiles past valid_rows would only hold -inf columns.
        for b0 in range(0, valid, bank_block):
            b1 = min(b0 + bank_block, valid)
            scores = qb @ bank[b0:b1].float().T
            cols = torch.arange(b0, b1, device=dev).expand(n, -1)
            # Running entries precede the tile and hold lower indices, and a
            # stable sort keeps that order among equal values: ties go to the
            # lowest index, and (-inf, 0) slots outrank nothing real.
            cand_v = torch.cat([vals, scores], dim=1)
            cand_i = torch.cat([idx, cols], dim=1)
            sv, order = torch.sort(cand_v, dim=1, descending=True, stable=True)
            vals = sv[:, :k]
            idx = torch.gather(cand_i, 1, order[:, :k])
        out_v[q0 : q0 + n] = vals
        out_i[q0 : q0 + n] = idx
    return out_v, out_i


def rerank_exact(
    queries: torch.Tensor,
    bank: torch.Tensor,
    cand_idx: torch.Tensor,
    k: int,
    *,
    cand_valid: Optional[torch.Tensor] = None,
    query_block: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact re-scoring of candidate rows (ScaNN `reorder` semantics).

    Counterpart of hbird_tpu/ops/knn.py::rerank_exact.

    Args:
        queries: (Q, D) full-precision queries.
        bank: (M, D) the re-scoring table (rows are cast to the queries'
            dtype).
        cand_idx: (Q, C) candidate row ids, k <= C.
        cand_valid: optional (Q, C) bool mask; invalid candidates (the
            first pass's -inf fillers) score -inf.

    Returns:
        (values (Q, k), row ids (Q, k)), by value descending, then
        candidate position (a stable sort, lax.top_k's order). Streamed
        over query blocks, so the (block, C, D) gather stays small.
    """
    vals_out, idx_out = [], []
    for q0 in range(0, queries.shape[0], query_block):
        q_blk = queries[q0 : q0 + query_block]
        idx_blk = cand_idx[q0 : q0 + query_block]
        cand = bank[idx_blk].to(q_blk.dtype)  # (qb, C, D)
        scores = torch.einsum("qd,qcd->qc", q_blk.float(), cand.float())
        if cand_valid is not None:
            scores = scores.masked_fill(~cand_valid[q0 : q0 + query_block], NEG_INF)
        sv, order = torch.sort(scores, dim=1, descending=True, stable=True)
        vals_out.append(sv[:, :k])
        idx_out.append(torch.gather(idx_blk, 1, order[:, :k]))
    if not vals_out:
        return (
            torch.zeros((0, k), dtype=torch.float32, device=queries.device),
            torch.zeros((0, k), dtype=cand_idx.dtype, device=queries.device),
        )
    return torch.cat(vals_out), torch.cat(idx_out)


def knn_with_labels(
    queries: torch.Tensor,
    bank: torch.Tensor,
    labels: torch.Tensor,
    k: int,
    *,
    valid_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k search + label gather on one device.

    Goes through `knn_topk`: the CUDA kernel for CUDA tensors, the plain
    `exact_knn` for CPU tensors.

    Returns:
        values (Q, k) f32, indices (Q, k) int64, neighbour labels (Q, k, C).
    """
    from hbird_tpu_torch.ops.knn_cuda import knn_topk

    vals, idx = knn_topk(queries, bank, k, valid_rows=valid_rows)
    return vals, idx, labels[idx]
