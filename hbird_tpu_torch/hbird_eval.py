"""The Hummingbird evaluation engine in PyTorch.

Counterpart of hbird_tpu/hbird_eval.py (reference hbird/hbird_eval.py:54-722):
`HbirdEvaluation` builds a feature+soft-label memory bank from a training
loader and scores a validation loader by k-NN retrieval + cosine
cross-attention label transfer + class-matching mIoU; `hbird_evaluation`
is the one-call wrapper.

Dataflow on the device (CUDA unless the caller passes device="cpu"):
- memory step per batch: backbone forward + GT patchify + soft labels
  (+ bounded rarity sampling) + L2 normalisation; each step's rows are
  written in place into the bank, allocated once on the device when its
  row count is known (bounded, or `dataset_size` given), else kept as
  slabs and concatenated after the build;
- eval step per batch: backbone forward -> kNN search (K1, the fused CUDA
  kernel ops/csrc/knn_topk.cu, over the flat bank; or, for 'ivf'/'tree',
  K2, ops/csrc/ivf_topk.cu, over the probed leaves of the IVF tree) ->
  score-based cross-attention -> bilinear upsample -> argmax -> confusion
  matrix. Only the (C, C) counts and the
  (B, H, W) predicted maps come back to the host.
- ragged last batches are zero-padded to the first batch's size; padded
  images carry ignore-labelled GT and their bank rows are dropped. A later
  batch larger than the first fails in `_pad_batch`, as in the JAX engine.
- the host's part of each batch lies in program spans (utils/profiling.py,
  recorded only while a torch.profiler runs): `hbird.<phase>.feed` (the
  loader's next item, padding, the copies to the device), `hbird.<phase>.step`
  and its pieces, and `hbird.eval.consume` (batch i-1's results copied back
  and counted once batch i is queued).

Behavioural quirks kept for parity (SURVEY Appendix):
- the memory build folds ignore label 255 into background 0
  (reference hbird_eval.py:309-310); eval does NOT remap — the metric
  masks ignore_index (hbird_eval.py:219-220).
- queries are not L2-normalized before retrieval; bank rows are.
- features are normalized without an epsilon (hbird_eval.py:324).
- Hungarian matching is the default scoring mode (hbird_eval.py:253).

The eval step runs eagerly, but it stands for the JAX engine's jitted
step, where a tree backend's probe_mode='auto' resolves to tile probing
(the queries are tracers there): so the step passes 'tile' for 'auto'.

Persistence (bank/io.py, the JAX package's formats): f_mem_p / l_mem_p
save the bank after the build (.npy/.npz/.pt, .bankdir), and an f_mem_p
ending in '.treedir' saves the built IVF index; load_memory=True restores
them instead of building (a .treedir as it was saved; .bankdirs with a tree
backend through the streamed tree build; flat files through the usual
index build), and falls back to a build when nothing is on disk.

A device mesh (parallel/mesh.py; a device may repeat): its 'bank' axis
shards the flat bank's rows (K1 once per shard, parallel/sharded_knn.py)
or, with nn_method='ivf', the tree's leaves (K2 once per shard,
parallel/sharded_ivf.py; nn_params shard_probe and tree_build_layout), and
the bank is accumulated padded to equal shards (`pad_rows_for_mesh`), its
real rows carried as `valid_rows`. Its 'data' axis splits each batch's
backbone forward over the axis's devices (the batch padded to a multiple of
the axis), and the rest of each step runs on the engine's device.

Several processes (parallel/distributed.py) run the engine in one of two
ways:
- data parallel (no mesh, or one within the process): each process feeds its
  own slice of the val split into its own bank's search, and the
  confusion matrices are summed across the processes before scoring;
- a bank axis over the processes (`process_mesh`): every process builds
  the same bank from the full train split on its card, the backend keeps
  this process's shards (copies) and the engine drops the whole bank after
  the index build; every process feeds the same val batches, since the
  meshed searches need the same queries everywhere, and so scores the same
  images: its own matrix is the whole count and is not summed (the JAX
  engine sums it, which scales every entry by the process count and
  leaves the mIoU as it is).
`conf_mat` keeps the matrix the last `evaluate` scored.
"""

from __future__ import annotations

import copy
import itertools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

try:
    from tqdm import tqdm
except ImportError:  # pragma: no cover

    def tqdm(iterator, *args, **kwargs):
        return iterator


from hbird_tpu_torch.core.attention import cross_attention_from_scores
from hbird_tpu_torch.core.patchify import patch_soft_labels, patchify_gt
from hbird_tpu_torch.core.sampling import sample_patches
from hbird_tpu_torch.device import resolve_device
from hbird_tpu_torch.models.extractor import FeatureExtractor, FeatureExtractorSimple
from hbird_tpu_torch.models.vit import ViT
from hbird_tpu_torch.nn.search_approx import NearestNeighborSearchApprox
from hbird_tpu_torch.nn.search_base import bank_mesh
from hbird_tpu_torch.nn.search_exact import NearestNeighborSearchExact
from hbird_tpu_torch.parallel.distributed import process_count
from hbird_tpu_torch.parallel.mesh import canonical_device
from hbird_tpu_torch.parallel.sharded_knn import pad_rows_for_mesh
from hbird_tpu_torch.utils.eval_metrics import PredsmIoU, confusion_matrix
from hbird_tpu_torch.utils.logging import get_logger
from hbird_tpu_torch.utils.profiling import PhaseTimer, maybe_trace, span

logger = get_logger(__name__)
_ENGINES = itertools.count()  # each engine's serial, the `engine` of its spans

_NN_ALIASES = {
    "faiss": "exact",
    "exact": "exact",
    "flat": "exact",
    "scann": "approx",
    "approx": "approx",
    "ivf": "ivf",
    "tree": "ivf",
}


def _as_batch(x) -> np.ndarray:
    """Loader output -> numpy batch; uint8 stays uint8, else float32."""
    x = np.asarray(x)
    if x.dtype == np.uint8:
        return x
    return x.astype(np.float32, copy=False)


def _pad_batch(x: np.ndarray, batch_size: int) -> Tuple[np.ndarray, int]:
    """Zero-pad a ragged batch up to the first batch's size."""
    n = x.shape[0]
    if n == batch_size:
        return x, n
    pad = np.zeros((batch_size - n,) + x.shape[1:], x.dtype)
    return np.concatenate([x, pad]), n


class HbirdEvaluation:
    """Build the memory bank, then evaluate retrieval-based segmentation.

    Args mirror the JAX engine (and the reference, hbird/hbird_eval.py:97-182):
        feature_extractor: FeatureExtractor / FeatureExtractorSimple with
            `forward_features`, `eval_spatial_resolution`, `d_model`.
        train_loader: iterable of (images, masks) numpy batches.
        num_classes: C.
        n_neighbours: k (default 30).
        augmentation_epoch: memory-build passes over the train loader.
        device: 'cuda' (the default when None) or 'cpu'; CUDA on a host
            without a GPU raises.
        nn_method: 'faiss'/'exact' or 'scann'/'approx' (default), both the
            flat bank searched by K1; 'ivf'/'tree', the approx backend's
            IVF tree searched by K2.
        nn_params: extra backend kwargs (use_fp16, num_leaves,
            num_leaves_to_search, recall_target, ...). For the tree, a
            recall_target without num_leaves_to_search calibrates the probe
            count after the build.
        memory_size: bank row cap; enables per-image rarity sampling.
        dataset_size: #train images (required with memory_size).
        seed: seed of the sampling-noise generator.
        bf16_bank: store the exact backend's bank in bfloat16.
        device_norm: (mean, std) for normalising uint8 batches on the device.
        f_mem_p / l_mem_p: where to save the feature / label memory (and
            with load_memory, where to restore them from); see the module
            docstring for the formats.
        load_memory: restore the memory or index instead of building it.
        mesh: a parallel.mesh.Mesh ('bank' shards the flat bank or the
            tree's leaves, 'data' splits each batch's forward); see the
            module docstring.
        timer: PhaseTimer to record the phases in (a fresh one by default).
    """

    # Defaults for engines made without __init__ (injection paths).
    mesh = None
    _data_devices: Optional[List[torch.device]] = None
    _bank_valid_rows: Optional[int] = None
    conf_mat: Optional[np.ndarray] = None
    _serial = -1
    _batch = -1  # the batch the phase's loop is on, the `batch` of its spans

    def __init__(
        self,
        feature_extractor,
        train_loader,
        num_classes: int,
        n_neighbours: int = 30,
        augmentation_epoch: int = 1,
        device=None,
        nn_method: str = "scann",
        nn_params: Optional[Dict[str, Any]] = None,
        memory_size: Optional[int] = None,
        dataset_size: Optional[int] = None,
        f_mem_p: Optional[str] = None,
        l_mem_p: Optional[str] = None,
        *,
        mesh=None,
        seed: int = 123,
        bf16_bank: bool = False,
        device_norm=None,
        load_memory: bool = False,
        timer: Optional[PhaseTimer] = None,
    ) -> None:
        method = _NN_ALIASES.get(nn_method.lower())
        if method is None:
            raise AssertionError(
                "Only faiss/exact, scann/approx and ivf/tree are supported"
            )
        self.device = resolve_device(device)
        self.mesh = mesh
        self._data_devices = (
            mesh.axis_devices("data") if mesh is not None and mesh.shape.get("data", 1) > 1 else None
        )
        self._replicas: Dict[torch.device, Any] = {}
        self._bank_valid_rows: Optional[int] = None
        self._device_norm = device_norm
        self.nn_params = dict(nn_params or {})
        self.feature_extractor = feature_extractor
        self.nn_method = method
        self.augmentation_epoch = augmentation_epoch
        self.memory_size = memory_size
        self.n_neighbours = n_neighbours
        self.num_classes = num_classes
        self.bf16_bank = bf16_bank
        self.f_mem_p = f_mem_p
        self.l_mem_p = l_mem_p
        self._dataset_size = dataset_size
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self.timer = timer if timer is not None else PhaseTimer()
        self._serial = next(_ENGINES)

        self.num_sampled_features: Optional[int] = None
        eval_spatial_resolution = feature_extractor.eval_spatial_resolution
        logger.info(
            "Initializing memory: nn_method=%s, memory_size=%s, augmentation_epoch=%s",
            nn_method,
            str(memory_size),
            augmentation_epoch,
        )
        if memory_size is not None:
            if dataset_size is None:
                raise ValueError("dataset_size must be provided when memory_size is set.")
            denom = dataset_size * augmentation_epoch
            self.num_sampled_features = max(1, memory_size // max(1, denom))
            n_patches = eval_spatial_resolution * eval_spatial_resolution
            if self.num_sampled_features > n_patches:
                logger.warning(
                    "memory_size budgets %d patches/image but images only "
                    "have %d; clamping (bank will be trimmed).",
                    self.num_sampled_features,
                    n_patches,
                )
                self.num_sampled_features = n_patches
            logger.info(
                "Bounded memory: %d rows => %d sampled patches per image",
                memory_size,
                self.num_sampled_features,
            )

        with torch.inference_mode():
            if load_memory:
                with self.timer.phase("memory_build"):
                    loaded = self.load_memory()
                    self._sync()
                if loaded:
                    logger.info("Memory restored from disk; skipping the train build.")
                    self._release_bank()
                    return
                logger.warning(
                    "load_memory=True but no persisted memory found at f_mem_p=%s / "
                    "l_mem_p=%s; building from the train loader.",
                    self.f_mem_p,
                    self.l_mem_p,
                )
            with maybe_trace("memory_build"), self.timer.phase("memory_build"):
                self._create_memory(train_loader)
                self._sync()
            self._save_memory()
            with maybe_trace("index_build"), self.timer.phase("index_build"):
                self._create_nn(
                    self.n_neighbours, nn_method=self.nn_method, **self.nn_params
                )
                self._sync()
            self._save_tree_if_requested()
            self._release_bank()

    def _release_bank(self) -> None:
        """On a bank axis over processes the backend holds this process's
        shards: the engine lets the whole bank go."""
        if self.mesh is not None and self.mesh.spans_processes:
            self.feature_memory = self.label_memory = None

    def _sync(self) -> None:
        """Wait for the device, so a phase's time covers its work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _span(self, name: str, batch: Optional[int] = None):
        """The span `name` of `batch`, by default the one the phase's loop
        is on."""
        return span(name, engine=self._serial, batch=self._batch if batch is None else batch)

    def _fed(self, loader, phase: str, prepare):
        """prepare(x, y) of each loader item, the loop's batch index in
        `_batch`. Taking the item and `prepare` (padding, the copies to the
        device) are the span `hbird.<phase>.feed`."""
        items = iter(loader)
        for i in itertools.count():
            self._batch = i
            with self._span(f"hbird.{phase}.feed"):
                item = next(items, None)
                if item is None:
                    return
                out = prepare(*item)
            yield out

    # ------------------------------------------------------------------
    # Memory construction
    # ------------------------------------------------------------------
    def _put_batch(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    def _pad_target(self, n: int) -> int:
        """Batch size: the first batch's, rounded up to split evenly over
        the mesh's 'data' axis."""
        d = len(self._data_devices) if self._data_devices else 1
        return -(-n // d) * d

    def _replica(self, dev: torch.device):
        """The feature extractor on `dev`: itself on the engine's device,
        else a copy whose module is moved there (made once)."""
        dev = canonical_device(dev)
        if dev == canonical_device(self.device):
            return self.feature_extractor
        if dev not in self._replicas:
            rep = copy.deepcopy(self.feature_extractor)
            for name in ("vit", "model"):
                module = getattr(rep, name, None)
                if isinstance(module, torch.nn.Module):
                    module.to(dev)
            self._replicas[dev] = rep
        return self._replicas[dev]

    def _forward_features(self, imgs: torch.Tensor) -> torch.Tensor:
        """(B, N, D) backbone features on the engine's device. With a 'data'
        axis the batch splits evenly over its devices; every slice is
        launched before any result moves back."""
        with self._span("hbird.forward"):
            if self._data_devices is None:
                return self.feature_extractor.forward_features(self._prep_images(imgs))[0]
            parts = []
            for dev, x in zip(self._data_devices, imgs.chunk(len(self._data_devices))):
                parts.append(self._replica(dev).forward_features(self._prep_images(x.to(dev)))[0])
            return torch.cat([f.to(self.device) for f in parts])

    def _prep_images(self, imgs: torch.Tensor) -> torch.Tensor:
        """uint8 batches are normalized on the device: (x/255 - mean)/std."""
        if imgs.dtype != torch.uint8:
            return imgs
        if self._device_norm is not None:
            mean, std = self._device_norm
        else:
            from hbird_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

            mean, std = IMAGENET_MEAN, IMAGENET_STD
        mean = torch.tensor(mean, dtype=torch.float32, device=imgs.device).reshape(1, -1, 1, 1)
        std = torch.tensor(std, dtype=torch.float32, device=imgs.device).reshape(1, -1, 1, 1)
        return (imgs.to(torch.float32) / 255.0 - mean) / std

    @staticmethod
    def _mask_ids(masks: torch.Tensor) -> torch.Tensor:
        """Masks arrive either float id/255 (ToTensor convention) or raw
        uint8 class ids (device-normalize pipelines)."""
        if masks.dtype == torch.uint8:
            return masks.to(torch.int64)
        return torch.round(masks * 255.0).to(torch.int64)

    def _memory_step(self, imgs: torch.Tensor, masks: torch.Tensor):
        fe = self.feature_extractor
        c = self.num_classes
        feats = self._forward_features(imgs)  # (B, N, D)
        with self._span("hbird.memory.labels"):
            y = self._mask_ids(masks)
            y = torch.where(y == 255, torch.zeros_like(y), y)
            patch_size = imgs.shape[-1] // fe.eval_spatial_resolution
            pgt = patchify_gt(y, patch_size)  # (B, S, S, P)
            label = patch_soft_labels(pgt, c)  # (B, S, S, C)
        with self._span("hbird.memory.sample"):
            if self.memory_size is None:
                normed = feats / torch.linalg.vector_norm(feats, dim=2, keepdim=True)
                return normed.reshape(-1, feats.shape[-1]), label.reshape(-1, c)
            sampled, idx = sample_patches(
                feats, pgt, c, self.num_sampled_features, generator=self._generator
            )
            normed = sampled / torch.linalg.vector_norm(sampled, dim=2, keepdim=True)
            lbl = label.reshape(label.shape[0], -1, c)
            lbl = torch.gather(lbl, 1, idx[..., None].expand(-1, -1, c))
            return normed.reshape(-1, sampled.shape[-1]), lbl.reshape(-1, c)

    def _create_memory(self, train_loader) -> None:
        """Run the memory step over the loader into the bank (bounded banks
        stop at memory_size rows).

        When dataset_size is known the final row count is too (dataset_size
        · rows per image · augmentation_epoch, at most memory_size): the f32
        feature and label banks are allocated once and each step's rows are
        written in place, so the card never holds the bank twice. A feed
        shorter than dataset_size says leaves a trimmed copy; rows beyond
        the count (a longer feed) wait on the host and are joined to the
        bank there after the build. Without dataset_size the steps' slabs
        are concatenated after the build.

        With a bank mesh the allocation is padded to equal shards
        (`pad_rows_for_mesh`) and kept padded; its real rows go to the
        backend as `valid_rows`."""
        d, c = self.feature_extractor.d_model, self.num_classes
        esr = self.feature_extractor.eval_spatial_resolution
        alloc = None
        if self._dataset_size:
            per_image = esr * esr if self.memory_size is None else self.num_sampled_features
            alloc = self._dataset_size * per_image * self.augmentation_epoch
            if self.memory_size is not None:
                alloc = min(alloc, self.memory_size)
        bank = labels_bank = None
        meshed = bank_mesh(self.mesh) is not None
        if alloc is not None:
            alloc_rows = pad_rows_for_mesh(alloc, self.mesh.shape["bank"]) if meshed else alloc
            bank = torch.zeros((alloc_rows, d), dtype=torch.float32, device=self.device)
            labels_bank = torch.zeros((alloc_rows, c), dtype=torch.float32, device=self.device)
        feature_chunks: List[torch.Tensor] = []
        label_chunks: List[torch.Tensor] = []
        rows = 0
        n_imgs = 0
        batch_size: Optional[int] = None

        def prepare(x, y):
            nonlocal batch_size
            x = _as_batch(x)
            y = _as_batch(y)
            if batch_size is None:
                batch_size = self._pad_target(x.shape[0])
            x, valid = _pad_batch(x, batch_size)
            y, _ = _pad_batch(y, batch_size)
            with self._span("hbird.memory.put"):
                return self._put_batch(x), self._put_batch(y), valid

        epochs = (
            tqdm(train_loader, desc="Memory creation loop", leave=False)
            for _ in tqdm(range(self.augmentation_epoch), desc="Augmentation loop")
        )
        for x, y, valid in self._fed(itertools.chain.from_iterable(epochs), "memory", prepare):
            with self._span("hbird.memory.step"):
                feats, labels = self._memory_step(x, y)
                n_rows = valid * (feats.shape[0] // batch_size)
                if self.memory_size is not None:
                    n_rows = min(n_rows, self.memory_size - rows)
                if alloc is None:
                    feature_chunks.append(feats[:n_rows])
                    label_chunks.append(labels[:n_rows])
                    rows += n_rows
                    n_imgs += valid
                    continue
                with self._span("hbird.memory.write"):
                    n_in = max(0, min(n_rows, alloc - rows))
                    if n_in:
                        bank[rows : rows + n_in].copy_(feats[:n_in])
                        labels_bank[rows : rows + n_in].copy_(labels[:n_in])
                    if n_in < n_rows:
                        if not feature_chunks:
                            logger.warning(
                                "Memory overflow: the %d preallocated rows are full but the "
                                "loader keeps yielding; the excess waits on the host and is "
                                "joined to the bank after the build. Check "
                                "dataset_size/augmentation_epoch.",
                                alloc,
                            )
                        feature_chunks.append(feats[n_in:n_rows].cpu())
                        label_chunks.append(labels[n_in:n_rows].cpu())
                rows += n_rows
                n_imgs += valid
        self.timer.add_items("memory_build", n_imgs)
        if bank is None:
            if len(feature_chunks) == 1:
                bank, labels_bank = feature_chunks[0], label_chunks[0]
            elif feature_chunks:
                bank, labels_bank = torch.cat(feature_chunks), torch.cat(label_chunks)
            else:
                bank = torch.zeros((0, d), dtype=torch.float32, device=self.device)
                labels_bank = torch.zeros((0, c), dtype=torch.float32, device=self.device)
        elif feature_chunks:
            # Joined on the host, the device bank freed before the upload:
            # the card holds the bank once.
            bank = torch.cat([bank.cpu(), *feature_chunks])
            labels_bank = torch.cat([labels_bank.cpu(), *label_chunks])
            bank, labels_bank = bank.to(self.device), labels_bank.to(self.device)
        elif meshed:
            # Kept padded to equal shards; the padding is masked out.
            self._bank_valid_rows = rows
        elif rows < alloc:
            # A copy: a view would keep the whole allocation alive.
            bank, labels_bank = bank[:rows].clone(), labels_bank[:rows].clone()
        self.feature_memory, self.label_memory = bank, labels_bank
        logger.info(
            "%s memory: %d x %d rows (%s)",
            "Bounded" if self.memory_size is not None else "Unbounded",
            self.feature_memory.shape[0],
            self.feature_memory.shape[1],
            "written in place" if alloc is not None else "concatenated",
        )

    # ------------------------------------------------------------------
    # Persistence (bank/io.py; reference hbird_eval.py:371-400)
    # ------------------------------------------------------------------
    def _save_memory(self) -> None:
        """Save the built bank to f_mem_p / l_mem_p. An f_mem_p ending in
        '.treedir' is the built index, saved after the index build
        (_save_tree_if_requested); the label save does not depend on it."""
        from hbird_tpu_torch.bank.io import is_tree_path, save_memory

        rows = self._bank_valid_rows  # a meshed bank's padding is not saved
        if self.f_mem_p is not None and not is_tree_path(self.f_mem_p):
            # save_memory may append '.npy': keep the path written.
            self.f_mem_p = save_memory(self.feature_memory[:rows], self.f_mem_p)
            logger.info("Saved feature memory to: %s", self.f_mem_p)
        if self.l_mem_p is not None:
            self.l_mem_p = save_memory(self.label_memory[:rows], self.l_mem_p)
            logger.info("Saved label memory to: %s", self.l_mem_p)

    def _save_tree_if_requested(self) -> None:
        """An f_mem_p ending in '.treedir' saves the BUILT IVF index (a
        reload skips k-means, layout and scatter). A flat backend saves its
        flat feature memory to f_mem_p + '.flat.npy' instead."""
        from hbird_tpu_torch.bank.io import is_tree_path, save_memory

        if self.f_mem_p is None or not is_tree_path(self.f_mem_p):
            return
        if not getattr(self.NN_algorithm, "use_tree", False):
            fallback = save_memory(self.feature_memory[: self._bank_valid_rows], self.f_mem_p + ".flat")
            logger.warning(
                "f_mem_p=%s requests a tree save but the backend is not a tree (nn_method=%s); "
                "saved the FLAT feature memory to %s instead. Use nn_method='ivf' for a tree, "
                "or a '.npy/.bankdir' path for flat banks.",
                self.f_mem_p,
                self.nn_method,
                fallback,
            )
            return
        self.NN_algorithm.save_tree(self.f_mem_p)
        logger.info("Saved built tree index to: %s", self.f_mem_p)

    def load_memory(self) -> bool:
        """Restore the saved memory or index; False when nothing is on disk.

        - f_mem_p a saved tree (.treedir): the index as saved (l_mem_p
          unused); the search options of nn_params apply.
        - f_mem_p and l_mem_p both .bankdirs with a tree backend: the
          streamed tree build from disk windows (the flat bank is never
          assembled).
        - otherwise both flat files: loaded onto the device, then the usual
          index build; with a bank mesh, .bankdirs load straight into
          padded shards (bank/io.py::load_memory_sharded).
        A recall_target without num_leaves_to_search calibrates the probe
        count of a tree, as after a build."""
        from hbird_tpu_torch.bank.io import (
            is_sharded_path,
            load_memory,
            load_memory_sharded,
            memory_path_on_disk,
            tree_path_on_disk,
        )

        if self.f_mem_p is not None and tree_path_on_disk(self.f_mem_p):
            search_keys = (
                "num_leaves_to_search", "recall_target", "query_block",
                "shard_probe", "num_reordering_candidates",
            )
            kwargs = {k: v for k, v in self.nn_params.items() if k in search_keys}
            self.NN_algorithm = NearestNeighborSearchApprox.load_tree(
                self.f_mem_p, n_neighbors=self.n_neighbours, mesh=bank_mesh(self.mesh), device=self.device,
                **kwargs,
            )
            self.feature_memory = self.label_memory = None
            logger.info("Loaded built tree index from: %s", self.f_mem_p)
            self._finish_nn(kwargs)
            return True
        if (
            self.f_mem_p is None
            or self.l_mem_p is None
            or memory_path_on_disk(self.f_mem_p) is None
            or memory_path_on_disk(self.l_mem_p) is None
        ):
            logger.warning("Memory files not found or paths not provided; skipping load.")
            return False
        if (
            (self.nn_method == "ivf" or self.nn_params.get("use_tree"))
            and is_sharded_path(self.f_mem_p)
            and is_sharded_path(self.l_mem_p)
        ):
            _, kwargs = self._nn_cls_kwargs("ivf", **self.nn_params)
            kwargs.pop("use_tree", None)
            kwargs.pop("use_fp16", None)
            self.NN_algorithm = NearestNeighborSearchApprox.from_bankdir(
                self.f_mem_p, self.l_mem_p, n_neighbors=self.n_neighbours, mesh=bank_mesh(self.mesh),
                device=self.device, **kwargs,
            )
            self.feature_memory = self.label_memory = None
            logger.info("Loaded .bankdir memory via the streamed tree build.")
            self._finish_nn(kwargs)
            return True
        if bank_mesh(self.mesh) is not None and is_sharded_path(self.f_mem_p) and is_sharded_path(self.l_mem_p):
            self.feature_memory, self._bank_valid_rows = load_memory_sharded(
                self.f_mem_p, mesh=self.mesh, dtype=torch.float32, device=self.device
            )
            self.label_memory, _ = load_memory_sharded(
                self.l_mem_p, mesh=self.mesh, dtype=torch.float32, device=self.device
            )
        else:
            self.feature_memory = load_memory(self.f_mem_p, device=self.device)
            self.label_memory = load_memory(self.l_mem_p, device=self.device)
        self._create_nn(self.n_neighbours, nn_method=self.nn_method, **self.nn_params)
        logger.info("Loaded memory from disk.")
        return True

    # ------------------------------------------------------------------
    # NN backend
    # ------------------------------------------------------------------
    def _nn_cls_kwargs(self, nn_method: str, **kwargs):
        """The backend class and its kwargs for `nn_method`: the tree for
        'ivf'; a bf16 bank for the approx backend by default, and for the
        exact backend when the engine's bf16_bank says so (faiss
        useFloat16)."""
        method = _NN_ALIASES.get(nn_method, nn_method)
        cls = (
            NearestNeighborSearchApprox
            if method in ("approx", "ivf")
            else NearestNeighborSearchExact
        )
        if method == "ivf":
            kwargs.setdefault("use_tree", True)
        kwargs.setdefault(
            "use_fp16", self.bf16_bank or cls is NearestNeighborSearchApprox
        )
        return cls, kwargs

    def _create_nn(self, n_neighbours: int = 30, nn_method: str = "exact", **kwargs):
        logger.info("Building NN index: method=%s, k=%d", nn_method, n_neighbours)
        cls, kwargs = self._nn_cls_kwargs(nn_method, **kwargs)
        if self._bank_valid_rows is not None:
            # A meshed bank arrives padded to equal shards.
            kwargs.setdefault("valid_rows", self._bank_valid_rows)
        self.NN_algorithm = cls(
            self.feature_memory,
            n_neighbors=n_neighbours,
            label_memory=self.label_memory,
            mesh=bank_mesh(self.mesh),
            device=self.device,
            **kwargs,
        )
        self._finish_nn(kwargs)

    def _finish_nn(self, kwargs) -> None:
        """After a backend is built or loaded: a tree with a recall_target
        and no explicit probe count calibrates it (ScaNN's recall-tuned
        index, done by measurement); the eval step's search options."""
        tree = getattr(self.NN_algorithm, "use_tree", False)
        if tree and kwargs.get("recall_target") is not None and "num_leaves_to_search" not in kwargs:
            self.NN_algorithm.calibrate_n_probe(self.NN_algorithm.recall_target)
        # The JAX engine's jitted step sees tracers, for which 'auto'
        # probing means tile probing.
        self._search_opts = (
            {"probe_mode": "tile"}
            if tree and self.NN_algorithm.probe_mode == "auto"
            else {}
        )

    # ------------------------------------------------------------------
    # Evaluation
    # ------------------------------------------------------------------
    def _eval_step(self, imgs, masks, esr: int, ignore_index, return_knn_details: bool):
        nn = self.NN_algorithm
        c = self.num_classes
        k = self.n_neighbours
        b, _, h, w = imgs.shape
        feats = self._forward_features(imgs)
        d = feats.shape[-1]
        q = feats.reshape(-1, d)
        state = nn.device_state
        with self._span("hbird.search"):
            vals, idx, labels = nn.search_with_labels_pure(state, q, k, **self._search_opts)
        with self._span("hbird.eval.label_transfer"):
            q_norm = torch.linalg.vector_norm(q, dim=-1)
            label_hat = cross_attention_from_scores(
                vals.reshape(b, -1, k), q_norm.reshape(b, -1), labels.reshape(b, -1, k, c)
            )  # (B, N, C)
            lh = label_hat.reshape(b, esr, esr, c).permute(0, 3, 1, 2)
            resized = F.interpolate(
                lh, size=(h, w), mode="bilinear", align_corners=False, antialias=False
            )
            pred = resized.argmax(dim=1)  # (B, H, W), first maximum on ties
        with self._span("hbird.eval.confusion"):
            y = self._mask_ids(masks).reshape(b, h, w)
            conf = confusion_matrix(y, pred, c, c, ignore_index)
            if c <= 255:
                # Class ids (and the 255 ignore sentinel) fit in uint8.
                pred = pred.to(torch.uint8)
                y = torch.clamp(y, 0, 255).to(torch.uint8)
        details = None
        if return_knn_details:
            key_feats = nn.gather_features_pure(state, idx).float()
            details = (
                key_feats.reshape(b, -1, k, d),
                labels.reshape(b, -1, k, c),
                label_hat,
            )
        return conf, pred, y, details

    def evaluate(
        self,
        val_loader,
        eval_spatial_resolution: int,
        return_knn_details: bool = False,
        ignore_index: int = 255,
    ):
        """Score the validation loader; returns mIoU (and optional details).

        Matches the reference `evaluate` (hbird_eval.py:184-265): Hungarian
        matching via PredsmIoU.compute(is_global_zero=True).
        """
        metric = PredsmIoU(self.num_classes, self.num_classes, ignore_index=ignore_index)
        knns, knns_labels, knns_ca_labels = [], [], []
        batch_size: Optional[int] = None
        n_imgs = 0

        def consume(item):
            nonlocal n_imgs
            conf, pred, y_ids, details, valid, batch = item
            with self._span("hbird.eval.consume", batch):
                n_imgs += valid
                with self._span("hbird.eval.consume.wait", batch):
                    conf_np = conf.cpu().numpy()
                pred_np = pred.cpu().numpy()[:valid]
                y_np = y_ids.cpu().numpy()[:valid]
                # Masked pred stream for reordered_preds (reference parity).
                mask = (
                    (y_np >= 0)
                    & (y_np < self.num_classes)
                    & (pred_np >= 0)
                    & (pred_np < self.num_classes)
                )
                if ignore_index is not None:
                    mask &= y_np != ignore_index
                metric.update_with_conf_mat(conf_np, pred=pred_np[mask])
                if return_knn_details and details is not None:
                    kf, kl, ca = details
                    knns.append(kf.cpu().numpy()[:valid])
                    knns_labels.append(kl.cpu().numpy()[:valid])
                    knns_ca_labels.append(ca.cpu().numpy()[:valid])

        def prepare(x, y):
            nonlocal batch_size
            x = _as_batch(x)
            y = _as_batch(y)
            if batch_size is None:
                batch_size = self._pad_target(x.shape[0])
            x, valid = _pad_batch(x, batch_size)
            # Padded images: all-ignore GT so they don't touch the metric.
            ign = ignore_index if ignore_index is not None else 255
            if y.dtype == np.uint8:
                y_pad = np.full((batch_size,) + y.shape[1:], ign, np.uint8)
            else:
                y_pad = np.full((batch_size,) + y.shape[1:], ign / 255.0, np.float32)
            y_pad[:valid] = y
            with self._span("hbird.eval.put"):
                return self._put_batch(x), self._put_batch(y_pad), valid

        logger.info("Starting evaluation loop...")
        # One-batch lag: batch i+1 is queued on the device before batch i's
        # results are copied to the host.
        in_flight = None
        with torch.inference_mode(), maybe_trace("evaluate"), self.timer.phase("evaluate"):
            feed = self._fed(tqdm(val_loader, desc="Evaluation loop"), "eval", prepare)
            for x, y, valid in feed:
                with self._span("hbird.eval.step"):
                    out = self._eval_step(x, y, eval_spatial_resolution, ignore_index, return_knn_details)
                if in_flight is not None:
                    consume(in_flight)
                in_flight = (*out, valid, self._batch)
            if in_flight is not None:
                consume(in_flight)
        self.timer.add_items("evaluate", n_imgs)
        with self.timer.phase("metric_compute"):
            # Data-parallel processes scored their own images: their matrices
            # add up. On a bank axis over the processes each scored them all.
            sync = process_count() > 1 and not (self.mesh is not None and self.mesh.spans_processes)
            jac, tp, fp, fn, reordered_preds, matched_bg_clusters = metric.compute(
                is_global_zero=True, return_reordered=False, sync_distributed=sync
            )
            self.conf_mat = metric.computed_conf_mat
        if return_knn_details:
            details_out = {
                "knns": np.concatenate(knns) if knns else np.zeros((0,)),
                "knns_labels": np.concatenate(knns_labels) if knns_labels else np.zeros((0,)),
                "knns_ca_labels": np.concatenate(knns_ca_labels)
                if knns_ca_labels
                else np.zeros((0,)),
            }
            logger.info("Evaluation complete (with KNN details).")
            return jac, details_out
        logger.info("Evaluation complete.")
        return jac


def hbird_evaluation(
    model,
    d_model: int,
    patch_size: int,
    dataset_name: str,
    data_dir: str,
    batch_size: int = 64,
    input_size: int = 224,
    augmentation_epoch: int = 1,
    device: str = "cuda",
    return_knn_details: bool = False,
    n_neighbours: int = 30,
    nn_method: str = "scann",
    nn_params: Optional[Dict[str, Any]] = None,
    ftr_extr_fn=None,
    memory_size: Optional[int] = None,
    num_workers: int = 8,
    ignore_index: int = 255,
    train_fs_path: Optional[str] = None,
    val_fs_path: Optional[str] = None,
    *,
    mesh=None,
    seed: int = 123,
    bf16_bank: bool = False,
    bf16_model: bool = False,
    f_mem_p: Optional[str] = None,
    l_mem_p: Optional[str] = None,
    load_memory: bool = False,
    loader_mode: str = "thread",
    device_normalize: bool = True,
    timer: Optional[PhaseTimer] = None,
):
    """High-level one-call evaluation (signature of the JAX engine's
    `hbird_evaluation`, reference hbird_eval.py:640-722).

    `model` may be:
    - this package's `ViT` (moved to `device` and prepared for
      `input_size`), used with FeatureExtractor;
    - any object, if `ftr_extr_fn(model, imgs) -> (B, N, D)` is given
      (the reference's pluggable protocol, README.md:147);
    - an existing FeatureExtractor / FeatureExtractorSimple.

    device_normalize (default True): the host feed ships uint8 images and
    class-id masks, normalised on the device.
    """
    from hbird_tpu_torch.data import get_dataset
    from hbird_tpu_torch.data.transforms import (
        get_hbird_train_transforms,
        get_hbird_val_transforms,
    )

    dev = resolve_device(device)
    eval_spatial_resolution = input_size // patch_size

    if isinstance(model, (FeatureExtractor, FeatureExtractorSimple)):
        feature_extractor = model
    elif ftr_extr_fn is None:
        if not isinstance(model, ViT):
            raise TypeError(
                "model must be a ViT, a feature extractor, or come with ftr_extr_fn"
            )
        model.to(dev).prepare(input_size)
        feature_extractor = FeatureExtractor(
            model,
            eval_spatial_resolution=eval_spatial_resolution,
            d_model=d_model,
            use_bf16=bf16_model,
        )
    else:
        feature_extractor = FeatureExtractorSimple(
            model,
            ftr_extr_fn=ftr_extr_fn,
            eval_spatial_resolution=eval_spatial_resolution,
            d_model=d_model,
        )

    train_transforms = get_hbird_train_transforms(
        input_size, device_normalize=device_normalize
    )
    val_transforms = get_hbird_val_transforms(
        input_size, device_normalize=device_normalize
    )
    dataset, ignore_index_local = get_dataset(
        dataset_name,
        data_dir,
        batch_size,
        num_workers,
        train_transforms,
        val_transforms,
        train_fs_path,
        val_fs_path,
        loader_mode=loader_mode,
    )
    # Dataset-local ignore_index wins unless the caller overrides with a
    # non-default value (reference hbird_eval.py:714-715).
    effective_ignore = ignore_index if ignore_index != 255 else ignore_index_local

    evaluator = HbirdEvaluation(
        feature_extractor,
        dataset.train_dataloader(),
        num_classes=dataset.get_num_classes(),
        n_neighbours=n_neighbours,
        augmentation_epoch=augmentation_epoch,
        device=dev,
        nn_method=nn_method,
        nn_params=nn_params,
        memory_size=memory_size,
        dataset_size=dataset.get_train_dataset_size(),
        f_mem_p=f_mem_p,
        l_mem_p=l_mem_p,
        load_memory=load_memory,
        mesh=mesh,
        seed=seed,
        bf16_bank=bf16_bank,
        device_norm=train_transforms.get("device_norm"),
        timer=timer,
    )
    result = evaluator.evaluate(
        dataset.val_dataloader(),
        eval_spatial_resolution=eval_spatial_resolution,
        return_knn_details=return_knn_details,
        ignore_index=effective_ignore,
    )
    logger.info("Phase stats: %s", evaluator.timer.summary())
    return result
