"""Exact flat kNN backend (the Faiss GpuIndexFlatIP/L2 analogue).

Counterpart of hbird_tpu/nn/search_exact.py (reference
hbird/nn/search_faiss.py:6-90), on one device:
- distance_measure: 'dot_product' (default) | 'l2'/'euclidean'
  (expanded-norm, K1's l2 form)
- `use_fp16` -> bf16 bank storage (faiss `config.useFloat16`,
  search_faiss.py:40); scores accumulate in f32
- `use_int8` / `quantization` ('int8', 'int8_rows', 'int8_asym') -> an int8
  bank (ops/quantize.py), dot product only; with
  `num_reordering_candidates` > n_neighbors a bf16 copy re-scores that many
  candidates exactly (ScaNN's reorder(C))
- search goes through K1 (ops/knn_cuda.py) on CUDA, its plain version on
  the CPU

Not ported yet, and raising rather than falling back: `idx_shard`,
`devices` and `mesh` (parallel/).
"""

from __future__ import annotations

from typing import Optional

from hbird_tpu_torch.nn.search_base import FlatSearch, not_ported, resolve_quantization


class NearestNeighborSearchExact(FlatSearch):
    def __init__(
        self,
        feature_memory,
        n_neighbors: int = 30,
        distance_measure: str = "dot_product",
        idx_shard: bool = False,
        use_fp16: bool = False,
        use_int8: bool = False,
        quantization: Optional[str] = None,
        num_reordering_candidates: int = 0,
        devices=None,
        mesh=None,
        label_memory=None,
        valid_rows: Optional[int] = None,
        device=None,
        **kwargs,
    ):
        quantization = resolve_quantization(use_int8, quantization)
        if quantization is not None and distance_measure.lower() != "dot_product":
            raise ValueError("use_int8 requires dot_product")
        if idx_shard or devices is not None:
            raise not_ported("bank sharding", "modules to port, 'parallel/'")
        super().__init__(
            feature_memory,
            n_neighbors,
            distance_measure,
            use_fp16=use_fp16,
            quantization=quantization,
            num_reordering_candidates=num_reordering_candidates,
            label_memory=label_memory,
            valid_rows=valid_rows,
            mesh=mesh,
            device=device,
        )
