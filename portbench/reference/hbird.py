"""The plain Hummingbird evaluation: memory rows, search, label transfer,
prediction, confusion counts and the Hungarian mIoU.

Written from the reference's description (hbird/hbird_eval.py): the memory
build folds ignore 255 into background, takes each patch's soft label as
its pixels' class frequency, keeps per image the `k_rows` patches of least
perturbed class rarity (class frequency summed over the classes present,
times U(0, 1) noise, empty patches last, ties to the lower index), and
L2-normalises their features; the eval step takes k neighbours by dot
product, weighs their labels by softmax(score / (‖q‖·β)), upsamples the
(C, S, S) map bilinearly to the image and takes the first largest class.

The noise is the engine's: its seed is an input of the run, and the
reference draws the same uniforms from a generator seeded alike. Every
function takes plain tensors; nothing of the program is imported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.vit import fp8_round

BETA = 0.02
EMPTY = 1e6


def patch_pixels(masks: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, 1, H, W) class ids -> (B, S·S, p·p) int64, 255 folded to 0."""
    y = masks.long()
    y = torch.where(y == 255, torch.zeros_like(y), y)
    b, _, h, w = y.shape
    s1, s2 = h // patch, w // patch
    y = y.reshape(b, s1, patch, s2, patch).permute(0, 1, 3, 2, 4)
    return y.reshape(b, s1 * s2, patch * patch)


def soft_labels(pixels: torch.Tensor, classes: int) -> torch.Tensor:
    """(B, P, p·p) ids -> (B, P, C) pixel class frequencies."""
    one_hot = (pixels[..., None] == torch.arange(classes, device=pixels.device)).float()
    return one_hot.sum(dim=2) / pixels.shape[-1]


def sampled_patches(pixels: torch.Tensor, classes: int, k_rows: int, noise: torch.Tensor) -> torch.Tensor:
    """(B, k_rows) patch indices kept per image."""
    present = (pixels[..., None] == torch.arange(classes, device=pixels.device)).any(dim=2).float()
    freq = present.sum(dim=1, keepdim=True)  # (B, 1, C)
    score = (present * freq).sum(dim=2)  # (B, P)
    score = torch.where(present.any(dim=2), score * noise, torch.full_like(score, EMPTY))
    return torch.sort(score, dim=1, stable=True).indices[:, :k_rows]


def engine_noise(seed: int, batch_indices, shape, device) -> dict:
    """{batch index: the uniforms the engine's generator gives that memory
    step} (one draw of `shape` per step, in order)."""
    g = torch.Generator(device=device).manual_seed(seed)
    want, out = set(batch_indices), {}
    for i in range(max(want, default=-1) + 1):
        u = torch.rand(shape, generator=g, dtype=torch.float32, device=device)
        if i in want:
            out[i] = u
    return out


def memory_rows(features: torch.Tensor, labels: torch.Tensor, idx: torch.Tensor):
    """Normalised feature rows and soft labels of the kept patches, for one
    image: features (P, D), labels (P, C), idx (K,)."""
    f = features[idx]
    return f / torch.linalg.vector_norm(f, dim=1, keepdim=True), labels[idx]


def exact_topk(q: torch.Tensor, rows, k: int, block: int = 1 << 18,
               precision: str = "f32") -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k by dot product of q (n, D) over the rows of `rows` (an (M, D)
    tensor), in blocks: (scores (n, k), row ids (n, k)), best first.
    precision='fp8' rounds each query and bank row to float8 e4m3 under a
    per-row scale before the product (the control)."""
    if precision == "fp8":
        q = fp8_round(q, dim=1)
    best_v = torch.full((q.shape[0], k), float("-inf"), device=q.device)
    best_i = torch.zeros((q.shape[0], k), dtype=torch.int64, device=q.device)
    m = rows.shape[0]
    for lo in range(0, m, block):
        r = rows[lo:lo + block].float()
        if precision == "fp8":
            r = fp8_round(r, dim=1)
        s = q @ r.t()
        v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
        cat_v = torch.cat([best_v, v], dim=1)
        cat_i = torch.cat([best_i, i + lo], dim=1)
        best_v, at = torch.topk(cat_v, k, dim=1)
        best_i = torch.gather(cat_i, 1, at)
    return best_v, best_i


def scores_of(q: torch.Tensor, rows: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Exact f32 dot products of q (n, D) with rows[ids] (n, k)."""
    return torch.einsum("nd,nkd->nk", q.float(), rows[ids].float())


def tile_leaves(q_batch: torch.Tensor, centroids: torch.Tensor, n_probe: int, block_q: int,
                precision: str = "bf16"):
    """Tile probing of a batch of queries: queries ordered by their best
    leaf (stably), cut into tiles of `block_q` (the last filled with copies
    of the last query), each tile probing the `n_probe` leaves of largest
    tile-wise maximum score, ties to the lower leaf. The queries are scored
    as the scan stores them (bf16, or fp8 for the control). Returns
    ((n_tiles, n_probe) leaf ids, (n,) tile of each query)."""
    qs = fp8_round(q_batch.float(), dim=1) if precision == "fp8" else q_batch.to(torch.bfloat16).float()
    c = centroids.float()
    s = qs @ c.t()
    order = torch.sort(torch.argmax(s, dim=1), stable=True).indices
    n = qs.shape[0]
    pad = (-n) % block_q
    so = s[order]
    if pad:
        so = torch.cat([so, so[-1:].expand(pad, -1)])
    tile_max = so.reshape(-1, block_q, c.shape[0]).amax(dim=1)
    probes = torch.sort(tile_max, dim=1, descending=True, stable=True).indices[:, :n_probe]
    tile_of = torch.empty(n, dtype=torch.int64, device=qs.device)
    tile_of[order] = torch.arange(n, device=qs.device) // block_q
    return probes, tile_of


def tile_probes(q_batch: torch.Tensor, centroids: torch.Tensor, n_probe: int, block_q: int,
                precision: str = "bf16") -> torch.Tensor:
    """(n, n_probe) leaves each query of the batch probes (`tile_leaves`)."""
    probes, tile_of = tile_leaves(q_batch, centroids, n_probe, block_q, precision)
    return probes[tile_of]


def probed_topk(q: torch.Tensor, probes: torch.Tensor, rows: torch.Tensor, perm: torch.Tensor,
                leaf_valid: torch.Tensor, cap: int, k: int,
                precision: str = "f32") -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of each query over the valid rows of the leaves it probes:
    leaf L holds original rows perm[L·cap : L·cap + leaf_valid[L]].
    Returns (scores (n, k), original row ids (n, k))."""
    out_v = torch.empty((q.shape[0], k), device=q.device)
    out_i = torch.empty((q.shape[0], k), dtype=torch.int64, device=q.device)
    groups = {}
    for i, key in enumerate(map(tuple, probes.tolist())):
        groups.setdefault(key, []).append(i)
    col = torch.arange(cap, device=q.device)
    lv = leaf_valid.long()
    for key, members in groups.items():
        leaves = torch.tensor(key, device=q.device)
        slots = (leaves[:, None] * cap + col)[col < lv[leaves][:, None]]
        ids = perm[slots]
        sel = torch.tensor(members, device=q.device)
        v, at = exact_topk(q[sel], rows[ids], k, precision=precision)
        out_v[sel], out_i[sel] = v, ids[at]
    return out_v, out_i


def label_transfer(scores: torch.Tensor, q_norm: torch.Tensor, labels: torch.Tensor,
                   beta: float = BETA, dtype=torch.float32) -> torch.Tensor:
    """(n, k) scores, (n,) query norms, (n, k, C) neighbour labels ->
    (n, C) soft labels, computed in `dtype` (bfloat16 for the control)."""
    denom = torch.clamp(q_norm, min=1e-12)[:, None] * beta
    att = torch.softmax(scores.to(dtype) / denom.to(dtype), dim=1)
    return torch.einsum("nk,nkc->nc", att, labels.to(dtype)).float()


def predict(label_hat: torch.Tensor, grid: int, size: int, dtype=torch.float32) -> torch.Tensor:
    """(S·S, C) soft labels of one image -> (size, size) class map (the
    first largest class), upsampled in `dtype`."""
    c = label_hat.shape[-1]
    m = label_hat.reshape(1, grid, grid, c).permute(0, 3, 1, 2).to(dtype)
    up = F.interpolate(m, size=(size, size), mode="bilinear", align_corners=False)
    return up[0].argmax(dim=0)


def confusion(gt: np.ndarray, pred: np.ndarray, classes: int, ignore: Optional[int] = 255) -> np.ndarray:
    """(C, C) counts, rows ground truth, columns prediction."""
    gt = gt.reshape(-1).astype(np.int64)
    pred = pred.reshape(-1).astype(np.int64)
    ok = (gt >= 0) & (gt < classes) & (pred >= 0) & (pred < classes)
    if ignore is not None:
        ok &= gt != ignore
    return np.bincount(gt[ok] * classes + pred[ok], minlength=classes * classes).reshape(classes, classes)


def hungarian_miou(conf: np.ndarray) -> float:
    """mIoU after matching predicted to true classes one to one by the
    Hungarian method on 1 - IoU; unmatched predictions count as background."""
    from scipy.optimize import linear_sum_assignment

    c = conf.astype(np.float64)
    rows, cols = c.sum(axis=1, keepdims=True), c.sum(axis=0, keepdims=True)
    iou = c / np.clip(rows + cols - c, 1e-8, None)
    r, k = linear_sum_assignment(1.0 - iou)
    mapping = np.zeros(conf.shape[1], dtype=np.int64)
    mapping[k] = r
    mapped = np.zeros((conf.shape[0], conf.shape[0]), dtype=conf.dtype)
    np.add.at(mapped, (slice(None), mapping), conf)
    tp = np.diag(mapped).astype(np.float64)
    fp = mapped.sum(axis=0) - tp
    fn = conf.sum(axis=1) - tp
    return float((tp / np.clip(tp + fp + fn, 1e-8, None)).mean())
