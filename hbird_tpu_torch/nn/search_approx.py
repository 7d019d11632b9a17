"""'scann' backend: the flat bank, or the IVF tree (ScaNN's tree()).

Counterpart of hbird_tpu/nn/search_approx.py, on one device. Two modes:

- **flat (default)**: the JAX package routes the flat dot-product 'scann'
  search to the exact fused kernel (it dominated every approximate full
  scan measured there), with a bf16 bank by default; so does this one,
  through K1. ScaNN's tuning knobs are accepted for config compatibility
  and are inert on this path, as in the JAX package.
- **tree (`use_tree=True`, the engine's nn_method='ivf')**: ScaNN's
  tree(num_leaves, num_leaves_to_search): spherical k-means leaves on a
  row sample, capacity-refined; a capacity-balanced leaf-slab layout; a
  probed-leaf scan through K2 (ops/ivf.py, ops/ivf_cuda.py). Returned ids
  are original bank rows. `num_reordering_candidates > k` re-scores a
  widened shortlist exactly (ScaNN's reorder(C)).

Not ported yet, and raising rather than falling back: `use_int8`,
`quantization` and `bank_scale` (K1 c-e, K2's int8 forms and
ops/quantize), distances other than dot_product (K1 b), `mesh`
(parallel/). `.treedir` save/load, `from_bankdir` and the streamed build
belong to bank/io; `state_spec`/`pin_expected_rows` served the JAX
package's ahead-of-time compile and have no counterpart.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hbird_tpu_torch.device import resolve_device
from hbird_tpu_torch.nn.search_base import FlatSearch, not_ported
from hbird_tpu_torch.ops import ivf
from hbird_tpu_torch.ops.ivf_cuda import MAX_K
from hbird_tpu_torch.ops.knn import rerank_exact
from hbird_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class NearestNeighborSearchApprox(FlatSearch):
    """Flat bank searched by K1, or (use_tree=True) the IVF tree by K2.

    Tree args (the JAX backend's, with its defaults): num_leaves,
    num_leaves_to_search, tree_slack, probe_mode ('auto' | 'tile' |
    'query'), tree_refine_rounds, tree_sample_rows (alias
    training_sample_size), kmeans_iters, full_lloyd_iters, seed,
    query_block (256), num_reordering_candidates, recall_target (used by
    `calibrate_n_probe`).
    """

    def __init__(
        self,
        feature_memory,
        n_neighbors: int = 30,
        distance_measure: str = "dot_product",
        num_leaves: int = 512,
        num_leaves_to_search: int = 32,
        anisotropic_quantization_threshold: Optional[float] = None,
        num_reordering_candidates: int = 0,
        dimensions_per_block: Optional[int] = None,
        recall_target: Optional[float] = None,
        use_fp16: bool = True,
        use_tree: bool = False,
        use_int8: bool = False,
        quantization: Optional[str] = None,
        bank_scale: Optional[float] = None,
        tree_slack: float = 1.3,
        probe_mode: str = "auto",
        full_lloyd_iters: int = 0,
        tree_refine_rounds: int = 2,
        tree_sample_rows: int = 131072,
        kmeans_iters: int = 12,
        mesh=None,
        label_memory=None,
        query_block: Optional[int] = None,
        seed: int = 0,
        valid_rows: Optional[int] = None,
        device=None,
        **kwargs,
    ):
        self.use_tree = bool(use_tree) and distance_measure.lower() == "dot_product"
        if use_int8 or quantization is not None or bank_scale is not None:
            raise not_ported(
                "int8 quantization",
                "TPU kernels K2, int8 forms" if self.use_tree else "TPU kernels K1 (c)-(e)",
            )
        if (
            anisotropic_quantization_threshold is not None
            or dimensions_per_block is not None
        ):
            logger.warning(
                "anisotropic_quantization_threshold/dimensions_per_block act "
                "on the per-row int8 modes; with %s bank storage they are "
                "ignored.",
                "bf16" if use_fp16 else "f32",
            )
        recall_explicit = recall_target is not None
        if recall_target is None:
            frac = num_leaves_to_search / max(1, num_leaves)
            recall_target = float(np.clip(0.9 + 0.4 * frac, 0.5, 0.99))
        self.recall_target = recall_target
        self.num_leaves = num_leaves
        self.num_leaves_to_search = num_leaves_to_search
        self.num_reordering_candidates = num_reordering_candidates
        if not self.use_tree:
            if num_reordering_candidates > 0 or recall_explicit:
                logger.info(
                    "Flat dot-product 'scann' routes to the exact kernel "
                    "(recall 1.0); num_reordering_candidates/recall_target are "
                    "bypassed. Pass use_tree=True (or nn_method='ivf') for "
                    "tree(num_leaves, num_leaves_to_search) pruning."
                )
            super().__init__(
                feature_memory,
                n_neighbors,
                distance_measure,
                use_fp16=use_fp16,
                label_memory=label_memory,
                valid_rows=valid_rows,
                mesh=mesh,
                device=device,
            )
            return

        if mesh is not None:
            raise not_ported("a device mesh", "modules to port, 'parallel/'")
        if probe_mode not in ("auto", "tile", "query"):
            raise ValueError(f"probe_mode must be 'auto', 'tile' or 'query': {probe_mode!r}")
        if "training_sample_size" in kwargs:  # ScaNN's name for the sample size
            tree_sample_rows = int(kwargs.pop("training_sample_size"))
        self.n_neighbors = n_neighbors
        self.use_fp16 = bool(use_fp16)
        self.tree_slack = float(tree_slack)
        self.probe_mode = probe_mode
        self.full_lloyd_iters = int(full_lloyd_iters)
        self.tree_refine_rounds = int(tree_refine_rounds)
        self.tree_sample_rows = int(tree_sample_rows)
        self.kmeans_iters = int(kmeans_iters)
        self.seed = int(seed)
        self.query_block = int(query_block or 256)
        if device is None and isinstance(feature_memory, torch.Tensor):
            device = feature_memory.device
        self.device = resolve_device(device)
        store = torch.bfloat16 if self.use_fp16 else torch.float32
        # Store dtype straight away: the centroids see the rows as stored.
        bank = torch.as_tensor(feature_memory, dtype=torch.float32, device=self.device).to(store)
        if label_memory is None:
            label_memory = torch.zeros((bank.shape[0], 1), dtype=torch.float32)
        labels = torch.as_tensor(label_memory, dtype=torch.float32, device=self.device)
        if valid_rows is not None and valid_rows < bank.shape[0]:
            # Padding rows clustered into leaves would count in leaf_valid
            # and surface as score-0 ghost neighbours.
            bank, labels = bank[:valid_rows], labels[:valid_rows]
        self._build_tree(bank.contiguous(), labels)

    def _tree_geometry(self, n_rows: int):
        return ivf.tree_layout(n_rows, self.num_leaves, slack=self.tree_slack)

    def _build_tree(self, bank: torch.Tensor, labels: torch.Tensor) -> None:
        """Leaf-partition the bank: train centroids, balance rows into
        fixed-capacity leaves, copy into the leaf-contiguous layout.
        `build_seconds` holds the wall time of each stage."""
        dev = self.device
        times = self.build_seconds = {}
        m = bank.shape[0]
        n_leaves, cap = self._tree_geometry(m)
        self._n_leaves, self._cap = n_leaves, cap
        rng = np.random.default_rng(self.seed)
        pick = rng.choice(m, min(m, self.tree_sample_rows), replace=False)
        sample = bank[torch.as_tensor(pick, device=dev)].float()
        with ivf.phase_seconds(times, "kmeans", dev):
            self.centroids = ivf.train_centroids(
                sample, n_leaves, iters=self.kmeans_iters,
                generator=torch.Generator().manual_seed(self.seed),
            )
        if self.full_lloyd_iters > 0:
            # Before the capacity refinement, which plain Lloyd would undo.
            with ivf.phase_seconds(times, "full_lloyd", dev):
                self.centroids = ivf.full_bank_lloyd(
                    bank, self.centroids, iters=self.full_lloyd_iters
                )
        if self.tree_refine_rounds > 0:
            with ivf.phase_seconds(times, "refine", dev):
                self.centroids = ivf.refine_centroids_balanced(
                    sample, self.centroids, slack=self.tree_slack,
                    rounds=self.tree_refine_rounds,
                )
        with ivf.phase_seconds(times, "assign", dev):
            choices, scores = ivf.assign_leaves(
                bank, self.centroids, n_choices=3, return_scores=True
            )
        with ivf.phase_seconds(times, "layout", dev):
            slots, fill = ivf.balanced_layout(choices, n_leaves, cap, scores=scores)
        with ivf.phase_seconds(times, "scatter", dev):
            self.bank, self.labels, self.perm = ivf.build_ivf_arrays(
                bank, labels, slots, n_leaves, cap
            )
        # original row -> leaf slot, and real rows per leaf
        self.slots = torch.as_tensor(slots, dtype=torch.int64, device=dev)
        self.leaf_valid = torch.as_tensor(fill, dtype=torch.int32, device=dev)
        self.valid_rows = m

    @property
    def device_state(self):
        """The searched arrays, passed explicitly to the pure search."""
        state = {"bank": self.bank, "labels": self.labels}
        if self.use_tree:
            state.update(
                centroids=self.centroids,
                leaf_valid=self.leaf_valid,
                perm=self.perm,
                slots=self.slots,
            )
        return state

    def gather_features_pure(self, state, idx: torch.Tensor) -> torch.Tensor:
        if not self.use_tree:
            return super().gather_features_pure(state, idx)
        # idx holds original row ids; the stored bank is leaf-ordered.
        return state["bank"][state["slots"][idx]]

    def search_with_labels_pure(
        self, state, q: torch.Tensor, k: Optional[int] = None, *, probe_mode: Optional[str] = None
    ):
        """Search over an explicit state dict: (values (Q, k) f32, original
        row ids (Q, k) int64, labels (Q, k, C)). `probe_mode` overrides the
        backend's for the tree (the engine's eval step passes 'tile')."""
        if not self.use_tree:
            return super().search_with_labels_pure(state, q, k)
        bank = state["bank"]
        k = k or self.n_neighbors
        reorder = self.num_reordering_candidates > k
        kk = self.num_reordering_candidates if reorder else k
        if kk > MAX_K:
            logger.warning(
                "num_reordering_candidates=%d exceeds the tree kernel's "
                "128-candidate limit; clamping to 128.", kk,
            )
            kk = MAX_K
        vals, idx_ivf = ivf.ivf_search(
            q.to(bank.dtype).contiguous(),
            bank,
            state["centroids"],
            state["leaf_valid"],
            kk,
            cap=self._cap,
            n_probe=min(self.num_leaves_to_search, self._n_leaves),
            block_q=self.query_block,
            probe_mode=probe_mode or self.probe_mode,
        )
        if reorder:
            vals, idx_ivf = rerank_exact(
                q.float(), bank, idx_ivf, k, cand_valid=torch.isfinite(vals)
            )
        out_labels = state["labels"][idx_ivf]
        # Public ids are original rows. Degenerate probes (< k valid
        # candidates) can surface padding slots (perm -1): clamp to 0.
        idx = torch.clamp(state["perm"][idx_ivf], min=0)
        return vals, idx, out_labels

    def calibrate_n_probe(
        self,
        recall_target: float,
        *,
        k: Optional[int] = None,
        n_queries: int = 21904,
        seed: int = 0,
        max_probe: Optional[int] = None,
    ) -> int:
        """Pick the smallest `num_leaves_to_search` whose measured
        recall@k meets `recall_target`, and install it.

        Probing every leaf is exact search, so recall is the overlap with
        the full-probe result on `n_queries` bank rows used as their own
        queries (the default matches an engine batch's density). Probes
        under the runtime's granularity: 'query' for a 'query' backend,
        else 'tile'. Geometric ladder, then one bisection level.
        """
        if not self.use_tree:
            raise ValueError("probe calibration is a tree-mode feature")
        k = k or self.n_neighbors
        rng = np.random.default_rng(seed)
        n_q = min(n_queries, self.valid_rows)
        choice = torch.as_tensor(rng.choice(self.valid_rows, n_q, replace=False), device=self.device)
        q = self.bank[self.slots[choice]]
        cal_mode = "query" if self.probe_mode == "query" else "tile"

        def probe(n_probe, probe_mode=cal_mode):
            _, idx = ivf.ivf_search(
                q, self.bank, self.centroids, self.leaf_valid, k,
                cap=self._cap, n_probe=n_probe, block_q=self.query_block,
                probe_mode=probe_mode,
            )
            return idx.cpu().numpy()

        # Full probe is exact under either granularity; tile mode avoids
        # duplicating every query once per leaf.
        oracle = probe(self._n_leaves, probe_mode="tile")

        def recall(idx):
            s = np.sort(idx, axis=1)
            first = np.ones(s.shape, bool)  # count each distinct id once
            first[:, 1:] = s[:, 1:] != s[:, :-1]
            hits = (s[:, :, None] == oracle[:, None, :]).any(axis=2) & first
            return float(np.mean(hits.sum(axis=1) / k))

        hi_cap = min(max_probe or self._n_leaves, self._n_leaves)
        lo = 0
        n_probe = 1
        while n_probe < hi_cap:
            r = recall(probe(n_probe))
            if r >= recall_target:
                break
            lo = n_probe
            n_probe *= 2
        else:
            n_probe = hi_cap
            # hi_cap == n_leaves is the oracle itself
            r = 1.0 if hi_cap == self._n_leaves else recall(probe(n_probe))
        while n_probe - lo > max(1, lo // 4):
            mid = (lo + n_probe) // 2
            r_mid = recall(probe(mid))
            if r_mid >= recall_target:
                n_probe, r = mid, r_mid
            else:
                lo = mid
        logger.info(
            "Calibrated num_leaves_to_search=%d for recall_target=%.3f "
            "(measured recall@%d=%.4f over %d queries)",
            n_probe, recall_target, k, r, n_q,
        )
        self.num_leaves_to_search = n_probe
        return n_probe
