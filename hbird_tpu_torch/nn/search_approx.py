"""'scann' backend: the flat bank, or the IVF tree (ScaNN's tree()).

Counterpart of hbird_tpu/nn/search_approx.py, on one device. Two modes:

- **flat (default)**: the JAX package routes the flat 'scann' search
  (dot product or l2) to the exact fused kernel (it dominated every
  approximate full scan measured there), with a bf16 bank by default; so
  does this one, through K1. An int8 bank (`use_int8`, `quantization`) is
  an approximate scan and honours `num_reordering_candidates` (reorder(C)
  against a bf16 copy); on a float bank ScaNN's tuning knobs are accepted
  for config compatibility and are inert, as in the JAX package.
- **tree (`use_tree=True`, the engine's nn_method='ivf')**: ScaNN's
  tree(num_leaves, num_leaves_to_search): spherical k-means leaves on a
  row sample, capacity-refined; a capacity-balanced leaf-slab layout; a
  probed-leaf scan through K2 (ops/ivf.py, ops/ivf_cuda.py). Returned ids
  are original bank rows. `num_reordering_candidates > k` re-scores a
  widened shortlist exactly (ScaNN's reorder(C)), except on int8 slabs,
  where re-scoring the same codes would keep their order. An int8 tree is
  trained, assigned and probed on the codes (cast to f32), its per-row
  scales scattered into the slab layout.

ScaNN's score_ah knobs (`dimensions_per_block`,
`anisotropic_quantization_threshold`) act on the per-row int8 modes
(ops/quantize.py::quantize_bank_int8_ah) and warn otherwise.

A tree built elsewhere: `from_tree_state` takes prebuilt slabs,
`from_bankdir` builds them by the streamed three-pass build from .bankdir
banks (the flat bank never on the device), and `save_tree`/`load_tree`
write and read a built tree as a .treedir (bank/io.py), in the JAX
package's format.

A flat bank on a `mesh` with a 'bank' axis is sharded over it and searched
by K1 once per shard, merged by 'gather' (parallel/sharded_knn.py), as in
the JAX package. A tree on a mesh (its sharded build, `shard_probe`, the
meshed streamed build and a .treedir placed on a mesh) is not ported yet
and raises; it is the next slice of ROADMAP queue 1 ('sharded_ivf').
`state_spec`/`pin_expected_rows` served the JAX package's ahead-of-time
compile and have no counterpart.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hbird_tpu_torch.device import resolve_device
from hbird_tpu_torch.nn.search_base import NEXT_SLICE, FlatSearch, not_ported, resolve_quantization
from hbird_tpu_torch.ops import ivf
from hbird_tpu_torch.ops.ivf_cuda import MAX_K
from hbird_tpu_torch.ops.knn import L2_DISTANCES, rerank_exact
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
        distance = distance_measure.lower()
        if distance not in ("dot_product", *L2_DISTANCES):
            raise ValueError(f"Unsupported distance measure: {distance_measure}")
        knobs_set = (
            anisotropic_quantization_threshold is not None or dimensions_per_block is not None
        )
        quantization = resolve_quantization(False, quantization)
        per_row = quantization in ("int8_rows", "int8_asym")
        if knobs_set and not per_row:
            logger.warning(
                "anisotropic_quantization_threshold/dimensions_per_block act on "
                "the per-row int8 modes (pass quantization='int8_rows' or "
                "'int8_asym'); with %s bank storage they are ignored.",
                quantization or ("bf16" if use_fp16 else "f32"),
            )
        if per_row and dimensions_per_block is not None:
            self.dims_per_block = int(dimensions_per_block)
            if self.dims_per_block < 1:
                raise ValueError(f"dimensions_per_block must be >= 1: {dimensions_per_block}")
        if per_row and anisotropic_quantization_threshold is not None:
            self.aniso_threshold = float(anisotropic_quantization_threshold)
            if not 0.0 < self.aniso_threshold < 1.0:
                raise ValueError(
                    "anisotropic_quantization_threshold must be in (0, 1): "
                    f"{anisotropic_quantization_threshold}"
                )
        if quantization is not None and distance != "dot_product":
            raise ValueError("int8 quantization requires dot_product scoring")
        self.use_tree = bool(use_tree) and distance == "dot_product"
        if use_tree and not self.use_tree:
            logger.warning(
                "use_tree requires dot_product scoring; falling back to the flat scan."
            )
        if not (self.use_tree or distance == "dot_product"):
            use_int8 = False  # a flat l2 scan keeps its float bank
        quantization = resolve_quantization(use_int8, quantization)
        recall_explicit = recall_target is not None
        if recall_target is None:
            frac = num_leaves_to_search / max(1, num_leaves)
            recall_target = float(np.clip(0.9 + 0.4 * frac, 0.5, 0.99))
        self.recall_target = recall_target
        self.num_leaves = num_leaves
        self.num_leaves_to_search = num_leaves_to_search
        if not self.use_tree:
            if quantization is None and distance == "dot_product" and (
                num_reordering_candidates > 0 or recall_explicit
            ):
                logger.info(
                    "Flat dot-product 'scann' routes to the exact kernel "
                    "(recall 1.0); num_reordering_candidates/recall_target are "
                    "bypassed. Pass use_tree=True (or nn_method='ivf') for "
                    "tree(num_leaves, num_leaves_to_search) pruning."
                )
            super().__init__(
                feature_memory,
                n_neighbors,
                distance,
                use_fp16=use_fp16,
                quantization=quantization,
                num_reordering_candidates=num_reordering_candidates,
                bank_scale=bank_scale,
                label_memory=label_memory,
                valid_rows=valid_rows,
                mesh=mesh,
                device=device,
            )
            return

        if mesh is not None:
            raise not_ported("a meshed tree", NEXT_SLICE)
        if probe_mode not in ("auto", "tile", "query"):
            raise ValueError(f"probe_mode must be 'auto', 'tile' or 'query': {probe_mode!r}")
        self.mesh = None
        if "training_sample_size" in kwargs:  # ScaNN's name for the sample size
            tree_sample_rows = int(kwargs.pop("training_sample_size"))
        self.n_neighbors = n_neighbors
        self.use_fp16 = bool(use_fp16)
        self.distance_measure = distance
        self._set_quantization(quantization, num_reordering_candidates)
        self.rerank_bank = None
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
        if feature_memory is None:
            return  # from_tree_state installs a built tree
        bank = self._as_tensor(feature_memory)
        if label_memory is None:
            label_memory = torch.zeros((bank.shape[0], 1), dtype=torch.float32)
        labels = torch.as_tensor(label_memory, dtype=torch.float32, device=self.device)
        if valid_rows is not None and valid_rows < bank.shape[0]:
            # Padding rows clustered into leaves would count in leaf_valid
            # and surface as score-0 ghost neighbours.
            bank, labels = bank[:valid_rows], labels[:valid_rows]
        row_scale = None
        if self.quantization is not None:
            bank, row_scale = self._take_codes(bank, bank_scale)
        else:
            # Store dtype straight away: the centroids see the rows as stored.
            bank = bank.float().to(torch.bfloat16 if self.use_fp16 else torch.float32)
        self._build_tree(bank.contiguous(), labels, row_scale)

    def _tree_geometry(self, n_rows: int):
        return ivf.tree_layout(n_rows, self.num_leaves, slack=self.tree_slack)

    def _build_tree(
        self, bank: torch.Tensor, labels: torch.Tensor, row_scale: Optional[torch.Tensor]
    ) -> None:
        """Leaf-partition the bank (as stored: int8 codes are clustered as
        f32 codes): train centroids, balance rows into fixed-capacity
        leaves, copy into the leaf-contiguous layout, with the per-row
        scales `row_scale` (M, 1) in the same slots (empty slots keep 0).
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
            if row_scale is not None:
                self.bank_row_scale = torch.zeros(
                    (n_leaves * cap, 1), dtype=torch.float32, device=dev
                ).index_copy_(0, torch.as_tensor(slots, device=dev), row_scale)
        # original row -> leaf slot, and real rows per leaf
        self.slots = torch.as_tensor(slots, dtype=torch.int64, device=dev)
        self.leaf_valid = torch.as_tensor(fill, dtype=torch.int32, device=dev)
        self.valid_rows = m

    @property
    def device_state(self):
        """The searched arrays, passed explicitly to the pure search."""
        state = super().device_state
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
        # idx holds original row ids; the stored bank is leaf-ordered, and so
        # are the per-slot scales.
        slot_idx = state["slots"][idx]
        return self._dequantize(state, state["bank"][slot_idx], slot_idx)

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
        # Re-scoring int8 slabs would rank by the same codes: no reorder.
        reorder = self.num_reordering_candidates > k and self.quantization is None
        kk = self.num_reordering_candidates if reorder else k
        if kk > MAX_K:
            logger.warning(
                "num_reordering_candidates=%d exceeds the tree kernel's "
                "128-candidate limit; clamping to 128.", kk,
            )
            kk = MAX_K
        q_cast, q_scale = self._cast_queries(state, q)
        vals, idx_ivf = ivf.ivf_search(
            q_cast,
            bank,
            state["centroids"],
            state["leaf_valid"],
            kk,
            cap=self._cap,
            n_probe=min(self.num_leaves_to_search, self._n_leaves),
            block_q=self.query_block,
            probe_mode=probe_mode or self.probe_mode,
            row_scale=state.get("bank_row_scale"),
        )
        vals = self._true_units(state, vals, q_scale)
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
        queries (the default matches an engine batch's density; an int8
        tree's rows are its codes, ranked with its per-row scales). Probes
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
                probe_mode=probe_mode, row_scale=self.bank_row_scale,
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

    # ------------------------------------------------------------------
    # A tree built elsewhere: streamed from a .bankdir, or saved (.treedir)
    # ------------------------------------------------------------------
    @classmethod
    def from_tree_state(
        cls,
        ivf_bank,
        ivf_labels,
        centroids,
        leaf_valid,
        perm,
        slots,
        *,
        cap: int,
        valid_rows: int,
        n_neighbors: int = 30,
        bank_scale=None,
        bank_row_scale=None,
        bank_col_scale=None,
        mesh=None,
        device=None,
        **kwargs,
    ):
        """The tree backend over prebuilt leaf slabs (the streamed build's or
        a saved tree's), with no flat bank and no build. The arrays go to
        `device` (default: the slabs' device if they are a tensor, else
        CUDA). int8 slabs need their scale: `bank_scale` (global) or
        `bank_row_scale` (per slot, (n_slots, 1)); `bank_col_scale` holds
        the score_ah column scales. Search options pass through `kwargs`."""
        if mesh is not None:
            raise not_ported("a meshed tree", NEXT_SLICE)
        if device is None and isinstance(ivf_bank, torch.Tensor):
            device = ivf_bank.device
        n_slots = ivf_bank.shape[0]
        if n_slots % cap:
            raise ValueError(f"{n_slots} slots are not whole leaves of {cap}")
        int8 = ivf_bank.dtype == torch.int8
        kwargs.setdefault("num_leaves", n_slots // cap)
        kwargs.setdefault("use_tree", True)
        kwargs.setdefault("use_int8", int8)
        if kwargs["use_int8"]:
            if bank_scale is None and bank_row_scale is None:
                raise ValueError("int8 slab injection requires bank_scale or bank_row_scale")
            if bank_row_scale is not None:
                kwargs.setdefault("quantization", "int8_rows")
        if str(kwargs.get("quantization") or "").lower() in ("int8_rows", "int8_asym") and bank_row_scale is None:
            raise ValueError(
                f"quantization={kwargs['quantization']!r} slab injection requires bank_row_scale "
                "(the per-slot scales the codes were quantized with)"
            )
        self = cls(None, n_neighbors=n_neighbors, device=device, **kwargs)
        dev = self.device

        def put(x, dtype=None):
            t = torch.as_tensor(x).to(dev)
            return t if dtype is None else t.to(dtype)

        self.bank = put(ivf_bank).contiguous()
        self.labels = put(ivf_labels, torch.float32).contiguous()
        self.centroids = put(centroids, torch.float32)
        self.leaf_valid = put(leaf_valid, torch.int32)
        self.perm = put(perm, torch.int64)
        self.slots = put(slots, torch.int64)
        self._n_leaves, self._cap = n_slots // cap, int(cap)
        self.valid_rows = int(valid_rows)
        if bank_row_scale is not None:
            self.bank_row_scale = put(bank_row_scale, torch.float32).reshape(-1, 1).contiguous()
        elif bank_scale is not None:
            self.bank_scale = torch.tensor(float(bank_scale), dtype=torch.float32, device=dev)
        # Injected slabs are quantized already: only handed-over column
        # scales apply.
        self.bank_col_scale = None if bank_col_scale is None else put(bank_col_scale, torch.float32)
        return self

    @classmethod
    def from_bankdir(
        cls,
        feature_dir: str,
        label_dir: Optional[str] = None,
        *,
        n_neighbors: int = 30,
        window_rows: int = 524288,
        num_leaves: int = 512,
        tree_slack: float = 1.3,
        kmeans_iters: int = 12,
        tree_refine_rounds: int = 2,
        tree_sample_rows: int = 131072,
        seed: int = 0,
        bank_scale=None,
        mesh=None,
        device=None,
        **kwargs,
    ):
        """The tree backend built by the streamed three-pass build
        (ops/ivf.py::build_tree_streamed) from .bankdir banks read window by
        window: the flat bank never exists on the host or the device.

        Float banks are cast to the tree's store dtype (bf16 unless
        use_fp16=False) on the device, window by window. An int8 .bankdir
        needs `bank_scale`, its global scale; `use_int8` cannot quantize a
        float .bankdir here (that needs another full pass) and is ignored
        with a warning, and the per-row modes raise."""
        from hbird_tpu_torch.bank.io import iter_bankdir_windows, sharded_memory_info

        if mesh is not None:
            raise not_ported("the meshed streamed tree build", NEXT_SLICE)
        dev = resolve_device(device)
        info = sharded_memory_info(feature_dir)
        is_int8 = info["dtype"] == "int8"
        qz = str(kwargs.get("quantization") or "").lower()
        if qz in ("int8_rows", "int8_asym"):
            raise ValueError(
                f"quantization={qz!r} is not supported for streamed .bankdir tree builds: quantize at "
                "save time (global scale) or build from an in-memory bank."
            )
        if kwargs.pop("use_int8", False) and not is_int8:
            logger.warning(
                "use_int8 ignored for a %s .bankdir streamed load: quantization would need an extra "
                "full pass; save an int8 .bankdir + bank_scale for the quantized path.",
                info["dtype"],
            )
        store = torch.int8 if is_int8 else (torch.bfloat16 if kwargs.get("use_fp16", True) else torch.float32)

        def stream():
            for rows, labs in iter_bankdir_windows(feature_dir, label_dir, window_rows=window_rows):
                yield rows.to(dev).to(store), labs

        parts = ivf.build_tree_streamed(
            stream, info["rows"], num_leaves, slack=tree_slack, kmeans_iters=kmeans_iters,
            refine_rounds=tree_refine_rounds, sample_rows=tree_sample_rows, seed=seed,
        )
        self = cls.from_tree_state(
            parts["ivf_bank"], parts["ivf_labels"], parts["centroids"], parts["leaf_fill"],
            parts["perm"], parts["slots"], cap=parts["cap"], valid_rows=parts["valid_rows"],
            n_neighbors=n_neighbors, bank_scale=bank_scale, num_leaves=parts["n_leaves"],
            tree_slack=tree_slack, device=dev, **kwargs,
        )
        self.build_seconds = parts["build_seconds"]
        return self

    def save_tree(self, dir_path: str, *, chunk_rows: int = 262144) -> str:
        """Write the built tree (slabs, labels, centroids, layout) to
        `dir_path`, conventionally '*.treedir', in the JAX package's format.
        Slabs come off the device one chunk at a time. int8 trees keep their
        scales (per-slot scales as a last label column), bf16 slabs are
        stored as uint16 bits."""
        from hbird_tpu_torch.bank.io import save_tree_state

        if not self.use_tree or getattr(self, "_cap", None) is None:
            raise ValueError("save_tree requires a BUILT tree backend (use_tree=true / nn_method='ivf')")
        int8 = self.quantization is not None
        scale = float(self.bank_scale) if int8 and self.bank_scale is not None else None
        row_scale_in_labels = int8 and self.bank_row_scale is not None
        labels = self.labels
        if row_scale_in_labels:
            labels = torch.cat([self.labels.float(), self.bank_row_scale], dim=1)
        return save_tree_state(
            dir_path,
            ivf_bank=self.bank,
            ivf_labels=labels,
            centroids=self.centroids,
            leaf_valid=self.leaf_valid,
            perm=self.perm,
            slots=self.slots,
            cap=self._cap,
            valid_rows=self.valid_rows,
            bank_scale=scale,
            row_scale_in_labels=row_scale_in_labels,
            col_scale=self.bank_col_scale,
            asym=self.int8_asym,
            chunk_rows=chunk_rows,
        )

    @classmethod
    def load_tree(cls, dir_path: str, *, n_neighbors: int = 30, mesh=None, device=None, **kwargs):
        """The tree backend from a save_tree() directory (either package's),
        its slabs assembled on `device` (default: CUDA) chunk by chunk.
        Search options (num_leaves_to_search, recall_target, ...) pass
        through `kwargs`."""
        from hbird_tpu_torch.bank.io import load_tree_state

        if mesh is not None:
            raise not_ported("a meshed tree", NEXT_SLICE)
        state = load_tree_state(dir_path, device=device)
        if state.pop("asym", False):
            # A tree saved in int8_asym mode scores bf16 queries on the codes.
            kwargs.setdefault("quantization", "int8_asym")
        return cls.from_tree_state(
            state["ivf_bank"], state["ivf_labels"], state["centroids"], state["leaf_valid"],
            state["perm"], state["slots"], cap=state["cap"], valid_rows=state["valid_rows"],
            n_neighbors=n_neighbors, bank_scale=state["bank_scale"],
            bank_row_scale=state["bank_row_scale"], bank_col_scale=state["bank_col_scale"],
            num_leaves=state["n_leaves"], device=state["ivf_bank"].device, **kwargs,
        )
