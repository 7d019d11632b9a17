"""Exact flat kNN backend (the Faiss GpuIndexFlatIP/L2 analogue).

Counterpart of hbird_tpu/nn/search_exact.py (reference
hbird/nn/search_faiss.py:6-90):
- distance_measure: 'dot_product' (default) | 'l2'/'euclidean'
  (expanded-norm, K1's l2 form)
- `use_fp16` -> bf16 bank storage (faiss `config.useFloat16`,
  search_faiss.py:40); scores accumulate in f32
- `use_int8` / `quantization` ('int8', 'int8_rows', 'int8_asym') -> an int8
  bank (ops/quantize.py), dot product only; with
  `num_reordering_candidates` > n_neighbors a bf16 copy re-scores that many
  candidates exactly (ScaNN's reorder(C))
- `mesh` (parallel/mesh.py) with a 'bank' axis, or `idx_shard=True` with
  `devices` (the reference's `gpu_ids`; default: every CUDA card) -> rows
  sharded over the devices (IndexShards); `shard_strategy` 'gather' or
  'ring' (parallel/sharded_knn.py). Without `idx_shard`, `devices` is
  unused: the bank stays on one device (IndexReplicas' degenerate case)
- search goes through K1 (ops/knn_cuda.py) on CUDA, its plain version on
  the CPU, once per shard
"""

from __future__ import annotations

from typing import Optional

import torch

from hbird_tpu_torch.nn.search_base import FlatSearch, resolve_quantization
from hbird_tpu_torch.parallel.mesh import make_mesh


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
        shard_strategy: str = "gather",
        valid_rows: Optional[int] = None,
        device=None,
        **kwargs,
    ):
        quantization = resolve_quantization(use_int8, quantization)
        if quantization is not None and distance_measure.lower() != "dot_product":
            raise ValueError("use_int8 requires dot_product")
        self.idx_shard = idx_shard
        self.devices = devices
        if mesh is None and idx_shard:
            if devices is None and torch.cuda.is_available():
                devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if devices is not None and len(devices) > 1:
                mesh = make_mesh((len(devices),), ("bank",), devices)
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
            shard_strategy=shard_strategy,
            device=device,
        )
