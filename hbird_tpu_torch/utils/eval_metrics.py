"""Streaming class-matching mIoU (PredsmIoU).

Counterpart of hbird_tpu/utils/eval_metrics.py (reference
hbird/utils/eval_metrics.py:13-339): a streaming confusion matrix with
Hungarian (default) or greedy many-to-one pred->gt matching, plus the
`compute_miou` legacy adapter.

- `confusion_matrix` is a bincount of gt*P + pred over the valid pixels,
  in int64, on whatever device the inputs live on; it equals the JAX
  package's chunked one-hot matmul count for count.
- The Hungarian assignment stays on the host (scipy, else the native
  solver, else numpy).
- `compute(sync_distributed=True)` sums the confusion matrix over the
  torch.distributed process group first (parallel/distributed.py), and
  keeps the local matrix as it was.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

try:
    from scipy.optimize import linear_sum_assignment as _scipy_lsa

    _SCIPY_AVAILABLE = True
except ImportError:  # pragma: no cover
    _SCIPY_AVAILABLE = False

from hbird_tpu_torch.utils.hungarian import hungarian as _np_hungarian


def linear_sum_assignment(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Hungarian assignment, in the JAX package's order: scipy when
    installed, else the native solver (utils/native.py) when it builds,
    else the numpy solver."""
    if _SCIPY_AVAILABLE:
        return _scipy_lsa(cost)
    from hbird_tpu_torch.utils import native

    if native.available():
        return native.hungarian(cost)
    return _np_hungarian(cost)


def confusion_matrix(
    gt: torch.Tensor,
    pred: torch.Tensor,
    num_gt: int,
    num_pred: int,
    ignore_index: Optional[int] = None,
) -> torch.Tensor:
    """Confusion matrix (rows = GT classes, cols = predicted classes).

    Invalid or ignored pixels contribute nothing (reference masking,
    eval_metrics.py:86-95).

    Args:
        gt, pred: integer class-id tensors of identical shape.
        num_gt, num_pred: matrix dimensions G, P.
        ignore_index: optional GT label to drop.

    Returns:
        (G, P) int64 counts, on the inputs' device.
    """
    gt = gt.reshape(-1).to(torch.int64)
    pred = pred.reshape(-1).to(torch.int64)
    valid = (gt >= 0) & (gt < num_gt) & (pred >= 0) & (pred < num_pred)
    if ignore_index is not None:
        valid &= gt != ignore_index
    flat = gt[valid] * num_pred + pred[valid]
    return torch.bincount(flat, minlength=num_gt * num_pred).reshape(
        num_gt, num_pred
    )


class PredsmIoU:
    """Streaming mIoU with Hungarian / many-to-one class matching.

    Mirrors the reference constructor and `update`/`compute` signatures
    (reference hbird/utils/eval_metrics.py:25-288).
    """

    def __init__(
        self,
        num_pred_classes: int,
        num_gt_classes: int,
        device=None,  # accepted for API parity; the metric lives on the host
        ignore_index: Optional[int] = None,
        prefer_cuda: bool = True,  # accepted for API parity; unused
        store_reordered_preds: bool = True,
    ) -> None:
        del device, prefer_cuda
        self.num_pred_classes = int(num_pred_classes)
        self.num_gt_classes = int(num_gt_classes)
        self.ignore_index = int(ignore_index) if ignore_index is not None else None
        self.store_reordered_preds = bool(store_reordered_preds)
        self._conf_mat = np.zeros(
            (self.num_gt_classes, self.num_pred_classes), dtype=np.int64
        )
        self._pred_chunks: List[np.ndarray] = []

    # ------------------------------------------------------------------
    def reset(self) -> None:
        self._conf_mat[:] = 0
        self._pred_chunks.clear()

    def update(self, gt, pred) -> None:
        """Stream a batch of (gt, pred) class-id arrays of identical shape."""
        gt = np.asarray(gt)
        pred = np.asarray(pred)
        if gt.shape != pred.shape:
            raise ValueError(f"Shapes must match. Got gt={gt.shape}, pred={pred.shape}")
        conf = confusion_matrix(
            torch.from_numpy(np.ascontiguousarray(gt.reshape(-1))),
            torch.from_numpy(np.ascontiguousarray(pred.reshape(-1))),
            self.num_gt_classes,
            self.num_pred_classes,
            self.ignore_index,
        )
        self._conf_mat += conf.numpy()
        if self.store_reordered_preds:
            # Keep only pixels surviving the ignore/range masks, matching the
            # reference's retained-preds stream (eval_metrics.py:86-109).
            g = gt.reshape(-1)
            p = pred.reshape(-1)
            valid = (
                (g >= 0)
                & (g < self.num_gt_classes)
                & (p >= 0)
                & (p < self.num_pred_classes)
            )
            if self.ignore_index is not None:
                valid &= g != self.ignore_index
            self._pred_chunks.append(p[valid].astype(np.int32))

    def update_with_conf_mat(self, conf: np.ndarray, pred=None) -> None:
        """Accumulate a precomputed confusion matrix (e.g. from the
        engine's eval step). `pred` (optional, already masked) feeds the
        reordered-preds stream."""
        self._conf_mat += np.asarray(conf, dtype=np.int64)
        if self.store_reordered_preds and pred is not None:
            # Store in the incoming dtype (uint8 from the fused eval step);
            # per-batch astype passes add up over a whole val set.
            self._pred_chunks.append(np.asarray(pred).reshape(-1))

    # ------------------------------------------------------------------
    def _score_matrix(self, precision_based: bool = False) -> np.ndarray:
        c = self._conf_mat.astype(np.float64)
        row_sum = c.sum(axis=1, keepdims=True)
        col_sum = c.sum(axis=0, keepdims=True)
        eps = 1e-8
        if not precision_based:
            denom = np.clip(row_sum + col_sum - c, eps, None)
        else:
            denom = np.clip(np.broadcast_to(col_sum, c.shape), eps, None)
        return c / denom

    def _many_to_one_mapping(self, precision_based: bool = False) -> np.ndarray:
        return self._score_matrix(precision_based).argmax(axis=0).astype(np.int64)

    def _hungarian_mapping(self) -> np.ndarray:
        iou = self._score_matrix(precision_based=False)
        row_ind, col_ind = linear_sum_assignment(1.0 - iou)
        mapping = np.zeros(self.num_pred_classes, dtype=np.int64)  # unmatched -> bg
        mapping[col_ind] = row_ind
        return mapping

    def _tp_fp_fn_from_mapping(
        self, mapping: Optional[np.ndarray]
    ) -> Tuple[List[int], List[int], List[int]]:
        c = self._conf_mat
        g, p = c.shape
        row_sum = c.sum(axis=1)
        if mapping is None:  # linear probe: identity columns
            col_sum = c.sum(axis=0)
            tp, fp, fn = [], [], []
            for i in range(g):
                tp_i = int(c[i, i]) if i < p else 0
                fp_i = int(col_sum[i] - c[i, i]) if i < p else 0
                fn_i = int(row_sum[i] - (c[i, i] if i < p else 0))
                tp.append(tp_i)
                fp.append(fp_i)
                fn.append(fn_i)
            return tp, fp, fn
        c_mapped = np.zeros((g, g), dtype=c.dtype)
        np.add.at(c_mapped, (slice(None), mapping), c)
        col_sum_mapped = c_mapped.sum(axis=0)
        tp_t = np.diag(c_mapped)
        fp_t = col_sum_mapped - tp_t
        fn_t = row_sum - tp_t
        return tp_t.tolist(), fp_t.tolist(), fn_t.tolist()

    @staticmethod
    def _miou_from_counts(tp, fp, fn) -> float:
        tp = np.asarray(tp, np.float64)
        fp = np.asarray(fp, np.float64)
        fn = np.asarray(fn, np.float64)
        iou = tp / np.clip(tp + fp + fn, 1e-8, None)
        return float(iou.mean())

    # ------------------------------------------------------------------
    def compute(
        self,
        is_global_zero: bool,
        many_to_one: bool = False,
        precision_based: bool = False,
        linear_probe: bool = False,
        sync_distributed: bool = False,
        return_reordered: bool = True,
    ):
        """Compute (miou, tp, fp, fn, reordered_preds, matched_bg_fraction).

        Defaults mirror the reference call site
        (hbird/hbird_eval.py:253 -> Hungarian matching).
        """
        local_conf = None
        if sync_distributed:
            from hbird_tpu_torch.parallel.distributed import sync_conf_mat

            # A collective: every process calls it, before the
            # is_global_zero return. The local matrix is restored after, so
            # a second compute() does not sum already-summed matrices.
            local_conf = self._conf_mat
            self._conf_mat = np.asarray(sync_conf_mat(local_conf), np.int64)
        try:
            return self._compute_from_conf_mat(
                is_global_zero,
                many_to_one=many_to_one,
                precision_based=precision_based,
                linear_probe=linear_probe,
                return_reordered=return_reordered,
            )
        finally:
            if local_conf is not None:
                self._conf_mat = local_conf

    def _compute_from_conf_mat(
        self,
        is_global_zero: bool,
        *,
        many_to_one: bool,
        precision_based: bool,
        linear_probe: bool,
        return_reordered: bool,
    ):
        if not is_global_zero:
            return 0.0, [], [], [], [], 0.0

        if linear_probe:
            mapping = None
            matched_bg = 0.0
        elif many_to_one:
            mapping = self._many_to_one_mapping(precision_based)
            matched_bg = float((mapping == 0).sum() / max(self.num_pred_classes, 1))
        else:
            mapping = self._hungarian_mapping()
            matched_bg = 1.0 / max(self.num_gt_classes, 1)

        tp, fp, fn = self._tp_fp_fn_from_mapping(mapping)
        miou = self._miou_from_counts(tp, fp, fn)

        if return_reordered:
            if not self.store_reordered_preds:
                raise RuntimeError(
                    "return_reordered=True requires store_reordered_preds=True during updates."
                )
            if self._pred_chunks:
                pred_all = np.concatenate(self._pred_chunks)
            else:
                pred_all = np.zeros((0,), np.int64)
            if mapping is None:
                reordered = pred_all.astype(np.int64)
            else:
                reordered = mapping[pred_all]
            # Reference parity: callers who opt in get the LIST the
            # reference emits (its per-pixel `.tolist()` remaps,
            # eval_metrics.py:272-285) — list ops (`+`, `.index`,
            # truthiness) on the 5th return value must keep working. The
            # ~seconds-scale conversion is borne only by these callers;
            # the engine passes return_reordered=False.
            reordered_list = reordered.tolist()
        else:
            reordered_list = []

        return miou, tp, fp, fn, reordered_list, matched_bg

    # --- Backwards-compatible single-shot adapter -----------------------
    def compute_miou(
        self,
        gt: np.ndarray,
        pred: np.ndarray,
        num_pred: int,
        num_gt: int,
        many_to_one: bool = False,
        precision_based: bool = False,
        linear_probe: bool = False,
    ):
        """Single-shot numpy adapter. NOTE: the reference adapter assigns
        swapped-named temporaries and then swaps them back at the update
        call (eval_metrics.py:316-321) — the net effect is a plain
        update(gt, pred); golden-tested against the reference module."""
        self.__init__(
            num_pred_classes=num_pred,
            num_gt_classes=num_gt,
            ignore_index=self.ignore_index,
            store_reordered_preds=True,
        )
        self.update(np.asarray(gt), np.asarray(pred))
        miou, tp, fp, fn, reordered, bg = self.compute(
            is_global_zero=True,
            many_to_one=many_to_one,
            precision_based=precision_based,
            linear_probe=linear_probe,
            sync_distributed=False,
            return_reordered=True,
        )
        return (
            float(miou),
            [np.int64(x) for x in tp],
            [np.int64(x) for x in fp],
            [np.int64(x) for x in fn],
            [np.int64(x) for x in reordered],
            float(bg),
        )
