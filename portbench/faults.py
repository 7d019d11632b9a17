"""Faults planted under the timed path: the program broken underneath while
the harness drives the rest of a run. The control test plants each on the
CPU (portbench/test_portbench_control.py) and `portbench.calibrate --fault`
on the card, at a cell's own size.

Each plant takes `patch(owner, name, value)`, as pytest's
`monkeypatch.setattr`; FAULTS gives, by name, the plant, the number that
has to catch it and the job kinds in which the fault can happen.
"""

from __future__ import annotations

import numpy as np
import torch


def bank_unwritten(patch):
    """A memory step that leaves the bank as it was (rows never written)."""
    from hbird_tpu_torch import hbird_eval

    step = hbird_eval.HbirdEvaluation._memory_step

    def memory_step(self, imgs, masks):
        feats, labels = step(self, imgs, masks)
        return torch.zeros_like(feats), labels

    patch(hbird_eval.HbirdEvaluation, "_memory_step", memory_step)


def half_batch(patch):
    """Half of each eval batch left out of the confusion counts."""
    from hbird_tpu_torch import hbird_eval

    counts = hbird_eval.confusion_matrix

    def confusion_matrix(gt, pred, num_gt, num_pred, ignore_index=None):
        half = gt.shape[0] // 2
        return counts(gt[:half], pred[:half], num_gt, num_pred, ignore_index)

    patch(hbird_eval, "confusion_matrix", confusion_matrix)


def neighbours_shifted(patch):
    """The search's answers altered where they are made: each neighbour
    shifted by one row."""
    from hbird_tpu_torch.nn import search_approx

    search = search_approx.NearestNeighborSearchApprox.search_with_labels_pure

    def search_with_labels_pure(self, state, q, k=None, **kwargs):
        vals, idx, labels = search(self, state, q, k, **kwargs)
        return vals, (idx + 1) % self.valid_rows, labels

    patch(search_approx.NearestNeighborSearchApprox, "search_with_labels_pure", search_with_labels_pure)


def prediction_shifted(patch):
    """The predicted map shifted by one class after the counts."""
    from hbird_tpu_torch import hbird_eval

    step = hbird_eval.HbirdEvaluation._eval_step

    def eval_step(self, *args, **kwargs):
        conf, pred, y, details = step(self, *args, **kwargs)
        return conf, (pred + 1) % self.num_classes, y, details

    patch(hbird_eval.HbirdEvaluation, "_eval_step", eval_step)


def attention_zeroed(patch):
    """The flash attention kernel (K3) returning zeros."""
    from hbird_tpu_torch.models import vit

    patch(vit, "flash_attention", lambda q, k, v, scale: torch.zeros_like(q))


def random_leaves(patch):
    """The tree dealing its rows to leaves at random: each row's leaf
    preferences drawn at random in place of its nearest centroids."""
    from hbird_tpu_torch.ops import ivf

    def assign_leaves(bank, centroids, n_choices=3, block_rows=1 << 18, return_scores=False):
        rng = np.random.default_rng(0)
        shape = (bank.shape[0], min(n_choices, centroids.shape[0]))
        ids = rng.integers(0, centroids.shape[0], shape).astype(np.int32)
        return (ids, np.zeros(shape, np.float32)) if return_scores else ids

    patch(ivf, "assign_leaves", assign_leaves)


def initial_centroids(patch):
    """The tree keeping its initial centroids (sample rows): no k-means
    iteration and no balanced refinement."""
    from hbird_tpu_torch.ops import ivf

    train = ivf.train_centroids

    def train_centroids(sample, n_leaves, **kwargs):
        return train(sample, n_leaves, **dict(kwargs, iters=0))

    patch(ivf, "train_centroids", train_centroids)
    patch(ivf, "refine_centroids_balanced", lambda sample, centroids, **kwargs: centroids)


FAULTS = {
    "bank_unwritten": (bank_unwritten, "bank", ("eval", "job")),
    "half_batch": (half_batch, "gt_hist", ("eval", "job")),
    "neighbours_shifted": (neighbours_shifted, "knn", ("eval", "job")),
    "prediction_shifted": (prediction_shifted, "pred", ("eval", "job")),
    "attention_zeroed": (attention_zeroed, "feat", ("eval", "job")),
    "random_leaves": (random_leaves, "leaf", ("job",)),
    "initial_centroids": (initial_centroids, "centroid", ("job",)),
}
