"""Exact k-nearest-neighbour search: the plain PyTorch version of K1.

Counterpart of hbird_tpu/ops/knn.py::exact_knn and of the single-device
branch of hbird_tpu/parallel/sharded_knn.py::sharded_knn_with_labels.

`exact_knn` is a blockwise `torch.matmul` over bank tiles (`dot_scores`)
and a running top-k merge, so the (Q, M) score matrix is never
materialised. It is what the CPU tests compare with the JAX package and
what `chip_smoke.py` holds the CUDA kernel (ops/knn_cuda.py) against; on
the engine's path it runs only for CPU tensors.

Semantics shared with the kernel (the forms of hbird_tpu/ops/knn_pallas.py
`_knn_kernel`):
- scores are q·b in f32 (`dot_scores`): bf16 inputs are widened, and so
  are int8 codes under bf16 queries (the asymmetric form); their products
  are exact in f32. An int8 x int8 score is the exact integer sum of the
  code products (int32 on the card, the TPU kernel's int32 accumulation),
  converted to f32 once, round to nearest even, at every depth: past
  2^24 (127^2 * D reaches it at D = 1,041) an f32 running sum would round
  at each step, differently in each order of summation;
- `row_scale` multiplies each score by its bank row's f32 scale, after
  the conversion and before masking (one rounding);
- `distance='l2'` subtracts the bias ||b||^2 / 2 (`l2_bias`, f32 from the
  bank as stored): argmax q·b - ||b||^2/2 is argmin ||q - b||^2;
- bank rows at or past `valid_rows` never win;
- unfilled slots (fewer than k valid rows) hold value -inf and index 0;
- results are sorted by value descending, then bank index ascending.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = float("-inf")
L2_DISTANCES = ("l2", "euclidean")


def l2_bias(bank: torch.Tensor) -> torch.Tensor:
    """(M,) f32 ||b||^2 / 2 of each bank row as stored."""
    b32 = bank.float()
    return 0.5 * (b32 * b32).sum(dim=1)


def dot_scores(queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(Q, R) f32 scores q·r of every query against every row. int8 x int8:
    the exact integer sums (f64 products of integers, exact below 2^53),
    rounded to f32 once; other inputs widened to f32 and summed in f32."""
    if queries.dtype == torch.int8 and rows.dtype == torch.int8:
        return (queries.double() @ rows.double().T).float()
    return queries.float() @ rows.float().T


def exact_knn(
    queries: torch.Tensor,
    bank: torch.Tensor,
    k: int,
    *,
    distance: str = "dot_product",
    valid_rows: Optional[int] = None,
    row_scale: Optional[torch.Tensor] = None,
    query_block: int = 1024,
    bank_block: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k neighbours of each query.

    Args:
        queries: (Q, D) f32, bf16 or int8 codes. NOT normalized (reference
            parity).
        bank: (M, D) memory bank (rows may be padded; see valid_rows): f32,
            bf16 or int8 codes.
        k: neighbours per query.
        distance: 'dot_product', or 'l2'/'euclidean' (score q·b - ||b||²/2,
            ordering-equal to ascending squared L2).
        valid_rows: number of real rows in `bank` (defaults to M).
        row_scale: optional (M,) or (M, 1) f32 per-row scales of an int8
            bank; scores become (q·codes) * row_scale.
        query_block / bank_block: tile sizes.

    Returns:
        (values (Q, k) f32, indices (Q, k) int64), on the inputs' device.
    """
    n_q = queries.shape[0]
    m = bank.shape[0]
    valid = m if valid_rows is None else max(0, min(int(valid_rows), m))
    dev = queries.device
    if distance in L2_DISTANCES:
        bias = l2_bias(bank)
    elif distance == "dot_product":
        bias = None
    else:
        raise ValueError(f"Unsupported distance measure: {distance}")
    scale = None if row_scale is None else row_scale.reshape(-1).float()
    out_v = torch.empty((n_q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_q, k), dtype=torch.int64, device=dev)
    for q0 in range(0, n_q, query_block):
        qb = queries[q0 : q0 + query_block]
        n = qb.shape[0]
        vals = torch.full((n, k), NEG_INF, dtype=torch.float32, device=dev)
        idx = torch.zeros((n, k), dtype=torch.int64, device=dev)
        # Tiles past valid_rows would only hold -inf columns.
        for b0 in range(0, valid, bank_block):
            b1 = min(b0 + bank_block, valid)
            scores = dot_scores(qb, bank[b0:b1])
            if scale is not None:
                scores = scores * scale[b0:b1]
            if bias is not None:
                scores = scores - bias[b0:b1]
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
    distance: str = "dot_product",
    rerank_bank: Optional[torch.Tensor] = None,
    rerank_queries: Optional[torch.Tensor] = None,
    rerank_candidates: int = 0,
    row_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k search + label gather on one device.

    Counterpart of the single-device branch of
    hbird_tpu/parallel/sharded_knn.py::sharded_knn_with_labels. Goes through
    `knn_topk`: the CUDA kernel for CUDA tensors, the plain `exact_knn` for
    CPU tensors.

    rerank_bank / rerank_queries / rerank_candidates: ScaNN's reorder(C):
    scan for `rerank_candidates` (clamped to the bank's rows) with the
    (possibly quantized) bank, then re-score them exactly against
    `rerank_bank` with `rerank_queries` (default: the queries) and keep k.
    First-pass fillers (-inf, or past valid_rows) never win the re-score.

    Returns:
        values (Q, k) f32, indices (Q, k) int64, neighbour labels (Q, k, C).
    """
    from hbird_tpu_torch.ops.knn_cuda import knn_topk

    valid = bank.shape[0] if valid_rows is None else int(valid_rows)
    n_cand = min(rerank_candidates, bank.shape[0]) if rerank_bank is not None else 0
    if n_cand > k:
        cvals, cand = knn_topk(
            queries, bank, n_cand, valid_rows=valid, distance=distance, row_scale=row_scale
        )
        vals, idx = rerank_exact(
            queries if rerank_queries is None else rerank_queries, rerank_bank, cand, k,
            cand_valid=torch.isfinite(cvals) & (cand < valid),
        )
    else:
        vals, idx = knn_topk(
            queries, bank, k, valid_rows=valid, distance=distance, row_scale=row_scale
        )
    return vals, idx, labels[idx]
