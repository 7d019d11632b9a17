"""The flat bank both nearest-neighbour backends share.

Counterpart of hbird_tpu/nn/search_base.py (reference
hbird/nn/search_base.py:3-31): construction takes the feature memory;
`find_nearest_neighbors(q, k)` returns (indices, distances) as numpy
arrays; `search_with_labels` is the fused path the engine uses (scores and
neighbour labels without leaving the device).

Both backends (`search_exact`, `search_approx`) store and search the flat
bank the same way: `FlatSearch` below, so the JAX package's abstract base
has no counterpart. The flat bank is f32, bf16 or int8 codes (the
`quantization` modes of hbird_tpu/nn/search_exact.py), scored by dot
product or expanded-norm L2, searched by K1 and optionally reordered
exactly (ScaNN's reorder(C)). With a mesh whose 'bank' axis is larger
than 1 (parallel/mesh.py), the stored arrays are lists of row shards, one
per bank-axis device, and K1 runs once per shard
(parallel/sharded_knn.py: 'gather', or the exact backend's 'ring'). The
approx backend's IVF tree (`use_tree=True`) overrides the storage and the
search (parallel/sharded_ivf.py on a mesh). On a mesh whose bank axis
spans the processes of a torch.distributed group
(parallel/distributed.py::process_mesh) the row shards held by another
process are None here; every process passes the same queries and gets the
same answers, and row gathers sum over the group.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from hbird_tpu_torch.device import resolve_device
from hbird_tpu_torch.ops.knn import L2_DISTANCES, knn_with_labels
from hbird_tpu_torch.ops.quantize import (
    block_column_scales,
    global_scale,
    quantize_bank_int8,
    quantize_bank_int8_ah,
    quantize_queries_int8,
)
from hbird_tpu_torch.parallel import distributed
from hbird_tpu_torch.parallel.sharded_knn import (
    first_shard,
    ring_knn_with_labels,
    shard_rows,
    sharded_knn_with_labels,
    take,
)

QUANTIZATIONS = ("int8", "int8_rows", "int8_asym")


def bank_mesh(mesh):
    """The mesh when its 'bank' axis shards the bank (size > 1), else None."""
    return mesh if mesh is not None and mesh.shape.get("bank", 1) > 1 else None


def resolve_quantization(use_int8: bool, quantization: Optional[str]) -> Optional[str]:
    """The int8 storage scheme: 'int8' (global scale; `use_int8` alone),
    'int8_rows' (per-row scales), 'int8_asym' (per-row scales, bf16 queries
    against the codes), or None (float storage)."""
    if quantization is None:
        return "int8" if use_int8 else None
    qz = str(quantization).lower()
    if qz not in QUANTIZATIONS:
        raise ValueError(f"quantization must be 'int8', 'int8_rows' or 'int8_asym': {quantization!r}")
    return qz


class FlatSearch:
    """Flat bank on one device, searched by K1.

    The bank is stored in bf16 (`use_fp16`) or f32, or as int8 codes under
    `quantization` ('int8': one global scale; 'int8_rows'/'int8_asym': a
    scale per row, dequantized in K1's epilogue), on `device` (default: the
    device of a tensor `feature_memory`, else CUDA). A torch int8 tensor
    under a global-scale quantization is taken as codes already quantized
    with `bank_scale`. With `num_reordering_candidates` > n_neighbors an
    int8 bank keeps a bf16 copy (`rerank_bank`) and the search re-scores
    that many candidates exactly. `dims_per_block` / `aniso_threshold`
    (per-row modes) select the score_ah quantizer. `valid_rows` masks
    padded trailing rows.

    With a bank `mesh`, every stored array is split into row shards over
    its 'bank' axis (`shard_rows`: zero-padded to equal shards) and
    `shard_strategy` picks the sharded search: 'gather' (K1 on each shard
    with all the queries, then the merge) or 'ring' (query blocks visit the
    shards). `feature_memory` / `label_memory` may then also arrive as
    lists of shards already (bank/io.py::load_memory_sharded), with
    `valid_rows` their real rows; a quantized bank is quantized shard by
    shard with its global and column scales taken over every shard, so its
    codes are the joined bank's. On a mesh over a process group the shard
    lists hold None for the other processes' shards; a whole bank given to
    every process is stored (quantized) whole, then sharded.
    """

    dims_per_block: Optional[int] = None
    aniso_threshold: Optional[float] = None

    def __init__(
        self,
        feature_memory,
        n_neighbors: int = 30,
        distance_measure: str = "dot_product",
        *,
        use_fp16: bool = False,
        quantization: Optional[str] = None,
        num_reordering_candidates: int = 0,
        bank_scale: Optional[float] = None,
        label_memory=None,
        valid_rows: Optional[int] = None,
        mesh=None,
        shard_strategy: str = "gather",
        device=None,
    ):
        self.distance_measure = distance_measure.lower()
        if self.distance_measure not in ("dot_product", *L2_DISTANCES):
            raise ValueError(f"Unsupported distance measure: {distance_measure}")
        if shard_strategy not in ("gather", "ring"):
            raise ValueError(f"shard_strategy must be 'gather' or 'ring': {shard_strategy!r}")
        self.mesh = bank_mesh(mesh)
        self.shard_strategy = shard_strategy
        sharded_in = isinstance(feature_memory, (list, tuple))
        if sharded_in and self.mesh is None:
            raise ValueError("a bank given as shards needs a mesh with a 'bank' axis")
        if device is None and isinstance(feature_memory, torch.Tensor):
            device = feature_memory.device
        self.device = resolve_device(device)
        self.n_neighbors = n_neighbors
        self.use_fp16 = bool(use_fp16)
        self._set_quantization(quantization, num_reordering_candidates)
        self.rerank_bank = None
        store = torch.bfloat16 if self.use_fp16 else torch.float32
        if sharded_in:
            shards = [None if s is None else s.to(d) for s, d in zip(feature_memory, self.mesh.axis_devices("bank"))]
            n_rows = len(shards) * first_shard(shards).shape[0]
            if self.quantization is not None:
                self.bank = self._quantized_shards(shards, bank_scale)
            else:
                self.bank = [None if s is None else s.to(store).contiguous() for s in shards]
        else:
            x = self._as_tensor(feature_memory)
            if self.quantization is not None:
                self.bank = self._quantized_state(x, bank_scale)
            else:
                self.bank = x.float().to(store).contiguous()
            n_rows = self.bank.shape[0]
        if label_memory is None:
            label_memory = torch.zeros((n_rows, 1), dtype=torch.float32)
        if isinstance(label_memory, (list, tuple)):
            self.labels = [None if s is None else s.float() for s in label_memory]
        else:
            self.labels = torch.as_tensor(label_memory, dtype=torch.float32, device=self.device)
        self.valid_rows = n_rows if valid_rows is None else int(valid_rows)
        if self.mesh is not None:
            self._shard_state()

    def _shard_state(self) -> None:
        """Split every stored array into row shards over the bank axis."""
        def split(x):
            return x if x is None or isinstance(x, list) else shard_rows(x, self.mesh)

        self.bank, self.labels = split(self.bank), split(self.labels)
        self.rerank_bank, self.bank_row_scale = split(self.rerank_bank), split(self.bank_row_scale)

    def _set_quantization(self, quantization: Optional[str], num_reordering_candidates: int):
        self.quantization = quantization
        self.int8_rows = quantization in ("int8_rows", "int8_asym")
        self.int8_asym = quantization == "int8_asym"
        self.num_reordering_candidates = int(num_reordering_candidates)
        self.bank_scale = self.bank_row_scale = self.bank_col_scale = None

    def _as_tensor(self, feature_memory) -> torch.Tensor:
        """The memory on the device: torch tensors keep their dtype (int8
        codes stay codes), anything else becomes f32."""
        if isinstance(feature_memory, torch.Tensor):
            return feature_memory.to(self.device)
        return torch.as_tensor(np.asarray(feature_memory, np.float32), device=self.device)

    def _quantize_bank(self, bank_f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """int8 codes and their scale ((M, 1) per row, else 0-d) by the
        configured scheme; the score_ah knobs (per-row modes) record the
        column scales in `bank_col_scale`."""
        if self.int8_rows and (self.dims_per_block is not None or self.aniso_threshold is not None):
            codes, scale, self.bank_col_scale = quantize_bank_int8_ah(
                bank_f, dims_per_block=self.dims_per_block, aniso_threshold=self.aniso_threshold
            )
            return codes, scale
        return quantize_bank_int8(bank_f, per_row=self.int8_rows)

    def _take_codes(self, x: torch.Tensor, bank_scale: Optional[float]):
        """Codes and per-row scales (None for a global scale, which goes to
        `bank_scale`) of the memory: a torch int8 tensor is taken as codes
        already quantized with the given global `bank_scale`."""
        if x.dtype == torch.int8:
            if bank_scale is None:
                raise ValueError("int8 bank injection requires bank_scale")
            if self.int8_rows:
                raise ValueError("pre-quantized int8 injection is global-scale only")
            self.bank_scale = torch.tensor(float(bank_scale), dtype=torch.float32, device=self.device)
            return x.contiguous(), None
        codes, scale = self._quantize_bank(x.float())
        if self.int8_rows:
            return codes, scale
        self.bank_scale = scale
        return codes, None

    def _quantized_state(self, x: torch.Tensor, bank_scale: Optional[float]) -> torch.Tensor:
        if x.dtype != torch.int8 and self.num_reordering_candidates > self.n_neighbors:
            # Full-precision copy for the exact re-ordering pass (bf16: half
            # the f32 footprint, exact enough for re-scoring).
            self.rerank_bank = x.float().to(torch.bfloat16)
        codes, self.bank_row_scale = self._take_codes(x, bank_scale)
        return codes.contiguous()

    def _quantized_shards(self, shards, bank_scale: Optional[float]):
        """`_quantized_state` of a bank given as row shards: codes (and the
        rerank copy) shard by shard."""
        if first_shard(shards).dtype != torch.int8 and self.num_reordering_candidates > self.n_neighbors:
            self.rerank_bank = [None if s is None else s.float().to(torch.bfloat16) for s in shards]
        codes, self.bank_row_scale = self._quantize_shards(shards, bank_scale)
        return [None if c is None else c.contiguous() for c in codes]

    def _quantize_shards(self, shards, bank_scale):
        """int8 codes of row shards and their per-row scales (None under a
        global scale, which goes to `bank_scale`), shard by shard: the global
        abs-max and the score_ah column scales are taken over every shard
        (and over the processes of a mesh that spans several), so the codes
        are the unsharded bank's."""
        dev, mesh = self.device, self.mesh
        own = [s for s in shards if s is not None]
        if own[0].dtype == torch.int8:
            if bank_scale is None:
                raise ValueError("int8 bank injection requires bank_scale")
            if self.int8_rows:
                raise ValueError("pre-quantized int8 injection is global-scale only")
            self.bank_scale = torch.tensor(float(bank_scale), dtype=torch.float32, device=dev)
            return shards, None

        def group_max(t):  # over this process's shards, then over the processes
            return distributed.all_max(t) if mesh.spans_processes else t

        if not self.int8_rows:
            top = group_max(torch.stack([s.float().abs().max().to(dev) for s in own]).max())
            self.bank_scale = global_scale(top)
            return [None if s is None else quantize_bank_int8(s, per_row=False, scale=self.bank_scale)[0]
                    for s in shards], None
        if self.dims_per_block is None and self.aniso_threshold is None:
            out = [None if s is None else quantize_bank_int8(s, per_row=True) for s in shards]
        else:
            if self.dims_per_block is not None:
                col_max = group_max(torch.stack([s.float().abs().amax(dim=0).to(dev) for s in own]).amax(dim=0))
                self.bank_col_scale = block_column_scales(col_max[None], self.dims_per_block)
            col = self.bank_col_scale
            out = [None if s is None else quantize_bank_int8_ah(
                s, aniso_threshold=self.aniso_threshold, col_scale=None if col is None else col.to(s.device))[:2]
                for s in shards]
        return [None if o is None else o[0] for o in out], [None if o is None else o[1] for o in out]

    @property
    def device_state(self):
        """The searched arrays, passed explicitly to the pure search: the
        bank and its labels, and an int8 bank's scales and rerank copy."""
        state = {"bank": self.bank, "labels": self.labels}
        if self.rerank_bank is not None:
            state["rerank_bank"] = self.rerank_bank
        if self.quantization is not None:
            if self.bank_row_scale is not None:
                state["bank_row_scale"] = self.bank_row_scale
            else:
                state["bank_scale"] = self.bank_scale
            if self.bank_col_scale is not None:
                state["bank_col_scale"] = self.bank_col_scale
        return state

    def _rows(self, x, idx: torch.Tensor) -> torch.Tensor:
        """x[idx] of a tensor, or of a list of row shards (each row from its
        owning shard; on a mesh over several processes, summed over them)."""
        if not isinstance(x, list):
            return x[idx]
        return take(x, idx, self.mesh)

    def _dequantize(self, state, rows: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
        """Stored rows taken at positions `sel` of the bank, as features:
        int8 codes times their scales (codes * s_row * c_col, or *
        bank_scale); float rows as stored."""
        if rows.dtype != torch.int8:
            return rows
        if "bank_row_scale" in state:
            rows = rows.float() * self._rows(state["bank_row_scale"], sel)
            col = state.get("bank_col_scale")
            return rows if col is None else rows * col
        return rows.float() * state["bank_scale"]

    def gather_features_pure(self, state, idx: torch.Tensor) -> torch.Tensor:
        """Feature rows by row id, dequantized: the bf16 rerank copy when
        there is one, else the stored rows through `_dequantize`."""
        if "rerank_bank" in state:
            return self._rows(state["rerank_bank"], idx)
        return self._dequantize(state, self._rows(state["bank"], idx), idx)

    def _cast_queries(self, state, q: torch.Tensor):
        """Queries as the bank's scan takes them, and the query scale of
        int8 query codes (None otherwise). The column-block scales of the
        score_ah quantizer fold into the queries; int8_asym keeps bf16
        queries."""
        bank = state["bank"]
        if isinstance(bank, list):  # a shard this process holds
            bank = first_shard(bank)
        if bank.dtype != torch.int8:
            return q.to(bank.dtype).contiguous(), None
        col = state.get("bank_col_scale")
        qq = q.float() * col if col is not None else q
        if self.int8_asym:
            return qq.to(torch.bfloat16).contiguous(), None
        q_cast, q_scale = quantize_queries_int8(qq)
        return q_cast.contiguous(), q_scale

    @staticmethod
    def _true_units(state, vals: torch.Tensor, q_scale) -> torch.Tensor:
        """Scores of int8 query codes back to approximate dot products, the
        units of the cross-attention temperature: row-scaled scores carry
        the bank's side already, global ones need bank_scale too."""
        if q_scale is None:
            return vals
        if "bank_row_scale" in state:
            return vals * q_scale
        return vals * (state["bank_scale"] * q_scale)

    def search_with_labels(
        self, q: torch.Tensor, k: Optional[int] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Fused search: (values, indices, labels)."""
        return self.search_with_labels_pure(self.device_state, q, k)

    def search_with_labels_pure(
        self, state, q: torch.Tensor, k: Optional[int] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Search over an explicit state dict: values (Q, k) f32 in dot
        units (exact bf16 dots when reordered), indices (Q, k) int64,
        labels (Q, k, C)."""
        k = k or self.n_neighbors
        rerank_bank = state.get("rerank_bank")
        rerank = rerank_bank is not None and self.num_reordering_candidates > k
        q_cast, q_scale = self._cast_queries(state, q)
        distance = "dot_product" if self.distance_measure == "dot_product" else "l2"
        if self.mesh is None:
            search, extra = knn_with_labels, {}
        elif self.shard_strategy == "ring":
            # Queries split over every mesh axis: each data row runs its
            # own ring rather than repeating the same one.
            parts = tuple(ax for ax in ("data", "bank") if self.mesh.shape.get(ax, 1) > 1)
            search, extra = ring_knn_with_labels, {"mesh": self.mesh, "query_partition": parts}
        else:
            search, extra = sharded_knn_with_labels, {"mesh": self.mesh}
        vals, idx, labels = search(
            q_cast, state["bank"], state["labels"], k, valid_rows=self.valid_rows,
            distance=distance, **extra,
            rerank_bank=rerank_bank if rerank else None,
            rerank_queries=q.to(torch.bfloat16) if rerank else None,
            rerank_candidates=self.num_reordering_candidates if rerank else 0,
            row_scale=state.get("bank_row_scale"),
        )
        # Reordered scores are exact bf16 dots already.
        return (vals if rerank else self._true_units(state, vals, q_scale)), idx, labels

    def find_nearest_neighbors(
        self, q, k: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(indices, distances) for queries q, as numpy arrays, like the
        reference backends (search_faiss.py:83-90)."""
        k = k or self.n_neighbors
        if not isinstance(q, torch.Tensor):
            q = torch.as_tensor(np.asarray(q, np.float32))
        q = q.to(self.device, torch.float32)
        vals, idx, _ = self.search_with_labels(q, k)
        return idx.cpu().numpy(), vals.cpu().numpy()
