"""core/ and utils/eval_metrics of the port against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: patchify, soft labels, sampled indices and the confusion
matrix are exact; cross-attention 1e-6 (f32 softmax and einsum in another
order); PredsmIoU equal (both score the same int64 confusion matrix).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hbird_tpu import core as jcore
from hbird_tpu.utils import eval_metrics as jmetrics
from hbird_tpu_torch import core as tcore
from hbird_tpu_torch.utils import eval_metrics as tmetrics


@pytest.mark.parametrize("num_classes, patch", [(5, 4), (21, 2), (3, 8)])
def test_patchify_and_soft_labels_exact(num_classes, patch):
    rng = np.random.default_rng(num_classes)
    # ids up to C + 2: ids >= C are all-zero one-hot rows on both sides
    gt = rng.integers(0, num_classes + 3, size=(2, 1, 16, 16)).astype(np.int32)
    jp = jcore.patchify_gt(jnp.asarray(gt), patch)
    tp = tcore.patchify_gt(torch.from_numpy(gt), patch)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    jl = jcore.patch_soft_labels(jp, num_classes)
    tl = tcore.patch_soft_labels(tp, num_classes)
    assert tl.dtype == torch.float32
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_cross_attention_literal():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 5, 8)).astype(np.float32)
    k = rng.normal(size=(2, 5, 4, 8)).astype(np.float32)
    v = rng.random((2, 5, 4, 3)).astype(np.float32)
    j = jcore.cross_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    t = tcore.cross_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)


def test_cross_attention_from_scores():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 6, 8)).astype(np.float32)
    bank = rng.normal(size=(2, 6, 5, 8)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    scores = np.einsum("bnd,bnkd->bnk", q, bank).astype(np.float32)
    q_norm = np.linalg.norm(q, axis=-1).astype(np.float32)
    v = rng.random((2, 6, 5, 4)).astype(np.float32)
    j = jcore.cross_attention_from_scores(
        jnp.asarray(scores), jnp.asarray(q_norm), jnp.asarray(v)
    )
    t = tcore.cross_attention_from_scores(
        torch.from_numpy(scores), torch.from_numpy(q_norm), torch.from_numpy(v)
    )
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)


@pytest.mark.parametrize("num_samples", [1, 7, 16])
def test_sample_patches_with_jax_noise(num_samples):
    rng = np.random.default_rng(num_samples)
    # few classes over 4x4 patches, so many patches share a rarity score
    gt = rng.integers(0, 3, size=(3, 1, 16, 16)).astype(np.int32)
    gt[0] = 0  # one image with a single class: every score ties
    feats = rng.normal(size=(3, 16, 6)).astype(np.float32)
    key = jax.random.PRNGKey(num_samples)
    pgt = jcore.patchify_gt(jnp.asarray(gt), 4)
    js, ji = jcore.sample_patches(key, jnp.asarray(feats), pgt, 4, num_samples)
    # the noise sample_patches draws inside, handed to the port
    noise = np.array(jax.random.uniform(key, (3, 16), dtype=jnp.float32))
    ts, ti = tcore.sample_patches(
        torch.from_numpy(feats),
        torch.from_numpy(np.array(pgt)),
        4,
        num_samples,
        noise=torch.from_numpy(noise),
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jsc, jnz = jcore.patch_sampling_scores(pgt, 4)
    tsc, tnz = tcore.patch_sampling_scores(torch.from_numpy(np.array(pgt)), 4)
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(tnz.numpy(), np.asarray(jnz))


def test_sample_patches_generator_is_reproducible():
    rng = np.random.default_rng(0)
    pgt = torch.from_numpy(rng.integers(0, 3, size=(2, 4, 4, 16)))
    feats = torch.from_numpy(rng.normal(size=(2, 16, 3)).astype(np.float32))
    a = tcore.sample_patches(feats, pgt, 3, 5, generator=torch.Generator().manual_seed(7))
    b = tcore.sample_patches(feats, pgt, 3, 5, generator=torch.Generator().manual_seed(7))
    assert torch.equal(a[1], b[1])


@pytest.mark.parametrize("ignore_index", [None, 255, 0])
def test_confusion_matrix_bit_equal(ignore_index):
    rng = np.random.default_rng(3)
    gt = rng.integers(0, 24, size=(4, 33, 17)).astype(np.int32)
    gt[0, :5] = 255
    gt[1, :3] = -1
    pred = rng.integers(-1, 23, size=(4, 33, 17)).astype(np.int32)
    j = jmetrics.confusion_matrix(jnp.asarray(gt), jnp.asarray(pred), 21, 21, ignore_index)
    t = tmetrics.confusion_matrix(torch.from_numpy(gt), torch.from_numpy(pred), 21, 21, ignore_index)
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize(
    "mode", [{}, {"many_to_one": True}, {"linear_probe": True}, {"many_to_one": True, "precision_based": True}],
    ids=["hungarian", "many_to_one", "linear_probe", "precision"],
)
def test_predsmiou_compute_equal(mode):
    rng = np.random.default_rng(5)
    jm = jmetrics.PredsmIoU(6, 5, ignore_index=255)
    tm = tmetrics.PredsmIoU(6, 5, ignore_index=255)
    for _ in range(3):
        gt = rng.integers(0, 5, size=(2, 9, 9)).astype(np.int64)
        gt[:, 0] = 255
        pred = (gt + rng.integers(0, 2, size=gt.shape)) % 6
        jm.update(gt, pred)
        tm.update(gt, pred)
    jres = jm.compute(is_global_zero=True, **mode)
    tres = tm.compute(is_global_zero=True, **mode)
    assert tres[0] == jres[0]
    for a, b in zip(tres[1:5], jres[1:5]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tres[5] == jres[5]


def test_predsmiou_compute_miou_adapter_equal():
    rng = np.random.default_rng(9)
    gt = rng.integers(0, 4, size=(50,))
    pred = rng.integers(0, 4, size=(50,))
    j = jmetrics.PredsmIoU(4, 4).compute_miou(gt, pred, 4, 4)
    t = tmetrics.PredsmIoU(4, 4).compute_miou(gt, pred, 4, 4)
    assert t[0] == j[0]
    assert t[4] == j[4]


def test_predsmiou_sync_distributed_raises():
    """sync_distributed=True raised until parallel/distributed.py was
    ported; with no process group it now scores the local matrix, which it
    leaves as it was (across processes: tests/test_torch_distributed.py)."""
    m = tmetrics.PredsmIoU(3, 3)
    m.update(np.array([0, 1, 2, 2]), np.array([0, 1, 1, 2]))
    before = m._conf_mat.copy()
    synced = m.compute(is_global_zero=True, sync_distributed=True, return_reordered=False)
    assert synced == m.compute(is_global_zero=True, return_reordered=False)
    np.testing.assert_array_equal(m._conf_mat, before)
