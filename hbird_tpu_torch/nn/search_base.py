"""The flat bank both nearest-neighbour backends share.

Counterpart of hbird_tpu/nn/search_base.py (reference
hbird/nn/search_base.py:3-31): construction takes the feature memory;
`find_nearest_neighbors(q, k)` returns (indices, distances) as numpy
arrays; `search_with_labels` is the fused path the engine uses (scores and
neighbour labels without leaving the device).

Both backends (`search_exact`, `search_approx`) store and search the flat
dot-product bank the same way: `FlatSearch` below, so the JAX package's
abstract base has no counterpart yet. The approx backend's IVF tree
(`use_tree=True`) overrides the storage and the search. Options of the JAX
backends that need a later slice raise `NotImplementedError` and name
their ROADMAP item; none falls back silently.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from hbird_tpu_torch.device import resolve_device
from hbird_tpu_torch.ops.knn import knn_with_labels


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for an option of the JAX package that a later slice ports."""
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, {item})")


class FlatSearch:
    """Flat dot-product bank on one device, searched by K1.

    The bank is stored in bf16 (`use_fp16`) or f32 on `device` (default:
    the device of a tensor `feature_memory`, else CUDA); scores accumulate
    in f32. `valid_rows` masks padded trailing rows.
    """

    def __init__(
        self,
        feature_memory,
        n_neighbors: int = 30,
        distance_measure: str = "dot_product",
        *,
        use_fp16: bool = False,
        label_memory=None,
        valid_rows: Optional[int] = None,
        mesh=None,
        device=None,
    ):
        if distance_measure.lower() != "dot_product":
            raise not_ported(
                f"distance_measure={distance_measure!r}", "TPU kernels K1 (b), l2"
            )
        if mesh is not None:
            raise not_ported("a device mesh", "modules to port, 'parallel/'")
        if device is None and isinstance(feature_memory, torch.Tensor):
            device = feature_memory.device
        self.device = resolve_device(device)
        self.n_neighbors = n_neighbors
        self.use_fp16 = bool(use_fp16)
        store = torch.bfloat16 if self.use_fp16 else torch.float32
        self.bank = torch.as_tensor(
            feature_memory, dtype=torch.float32, device=self.device
        ).to(store).contiguous()
        if label_memory is None:
            label_memory = torch.zeros((self.bank.shape[0], 1), dtype=torch.float32)
        self.labels = torch.as_tensor(label_memory, dtype=torch.float32, device=self.device)
        self.valid_rows = self.bank.shape[0] if valid_rows is None else int(valid_rows)

    def gather_features_pure(self, state, idx: torch.Tensor) -> torch.Tensor:
        """Stored feature rows (in the bank's dtype) by row id."""
        return state["bank"][idx]

    @property
    def device_state(self):
        """The bank and its labels, passed explicitly to the pure search."""
        return {"bank": self.bank, "labels": self.labels}

    def search_with_labels(
        self, q: torch.Tensor, k: Optional[int] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Fused search: (values, indices, labels)."""
        return self.search_with_labels_pure(self.device_state, q, k)

    def search_with_labels_pure(
        self, state, q: torch.Tensor, k: Optional[int] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Search over an explicit state dict: queries are cast to the
        bank's dtype; values (Q, k) f32, indices (Q, k) int64, labels
        (Q, k, C)."""
        bank = state["bank"]
        k = k or self.n_neighbors
        q_cast = q.to(bank.dtype).contiguous()
        return knn_with_labels(
            q_cast, bank, state["labels"], k, valid_rows=self.valid_rows
        )

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
