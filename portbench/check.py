"""How `correct` is decided: the outputs of the timed path against the
plain reference (portbench/reference/), after the window has closed.

Each number below is judged against its limit in `limits/<cell>.json`:

- `feat`: the forward. Largest relative error (Frobenius, per image) of the
  sampled train and val images' patch features against the f32 reference
  forward of the same images and weights.
- `bank`: the memory build. For the sampled train images and one image of
  every memory-step batch, its rows of the bank (at the image's own
  offset) against the reference's own: the kept patches from the masks and
  the engine's noise, normalised features and soft labels. Relative row
  error plus the largest label error; a wrong patch, label, batch or
  offset reads near 1.
- `knn`: the search, judged on the program's own queries (the forward is
  `feat`'s). Per sampled query, how far the worst returned neighbour's
  exact f32 score lies below the k-th best exact score over the rows the
  method searches (the whole bank; on a tree, the valid rows of the leaves
  the query's tile probes, worked out from the tree's centroids), or how
  far a returned score lies from the exact score of its row; in units of
  ‖q‖. The largest over the sample.
- `pred`: label transfer, upsampling and argmax, judged on the program's
  own neighbours (the search is `knn`'s). The share of pixels of a sampled
  val image whose class differs from the reference's map made from the
  same scores, rows and query norms; the largest.
- `conf` (exact): each sampled batch's confusion counts against counts of
  its predicted map and ground truth.
- `gt_hist` (exact): the rows of the window's confusion matrix against the
  class histogram of every val image the window fed: a batch, or part of
  one, left out of the count reads here.
- `miou` (exact): the mIoU returned against the reference's Hungarian mIoU
  of the same matrix.
- `tree` (exact, trees): every bank row in exactly one slot of its leaf's
  valid range, slabs equal to the bank's rows in bf16, slab labels equal
  to the bank's, fill counts equal to the rows placed.
- `leaf` (trees): the share of bank rows whose leaf is none of their
  `ASSIGN_CHOICES` nearest centroids by exact f32 scores. The tree puts a
  row elsewhere only when all of those leaves are full.
- `centroid` (trees): over the leaves, the median of one less the cosine
  between a leaf's centroid and the sum of the f32 rows it holds. The
  tree's k-means puts each centroid in the mean direction of its rows; a
  centroid left where it started, at one row, reads far off it.
- `launches` (exact, on the card): kernel launches of the window that are
  not what the traffic names (`traffic/<name>.json`'s "launches").

The reference follows the program's own state in two places, and checks
that state by itself first: it searches the program's f32 bank (whose
rows of one image a batch `bank` checks against the reference) and, on a
tree, the program's centroids and leaves (which `tree`, `leaf` and
`centroid` check). The control (`control()`) is the
reference computed in float8 e4m3 in the program's place.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from portbench.data import MASK_IGNORE
from portbench.harness import engine_seed, split
from portbench.model import make_weights
from portbench.reference import hbird as ref
from portbench.reference import vit as ref_vit

ASSIGN_CHOICES = 3  # a row's leaf is one of its three nearest centroids
GROUP = 8  # images a reference forward takes at once


class Judge:
    """The reference's side of the comparison for one run's results."""

    def __init__(self, ctx, res: dict) -> None:
        self.ctx, self.res = ctx, res
        self.cfg, self.tr = ctx.config, ctx.traffic
        self.dev = ctx.device
        self.engine = res["engine"]
        self.weights = make_weights(self.cfg, ctx.seed, self.dev)
        self.grid = self.cfg["input_size"] // self.cfg["patch_size"]
        n_img = self.tr["train_images"] * self.cfg["augmentation_epoch"]
        self.k_rows = min(max(1, self.tr["memory_size"] // n_img), self.grid * self.grid)
        self.bank = self.engine.feature_memory
        self.labels = self.engine.label_memory
        self.tree = res.get("tree")
        if self.tree is not None:
            self.perm = self.engine.NN_algorithm.perm
        self._ref_feats: Dict[int, torch.Tensor] = {}
        self._ref_rows: Dict[int, tuple] = {}
        self._ref_val: Dict[tuple, torch.Tensor] = {}

    # -- inputs ---------------------------------------------------------
    def train_image(self, j: int):
        return split(self.ctx, "train").image(j)

    def val_image(self, b: int, o: int):
        vid = self.val_id(b, o)
        val = self.res["val"]
        c, at = divmod(vid, self.tr["batch"])
        dev = self.dev
        return (torch.from_numpy(val.images[c][at:at + 1]).to(dev),
                torch.from_numpy(val.masks[c][at:at + 1]).to(dev))

    def val_id(self, b: int, o: int) -> int:
        idx = self.res["val_indices"]
        return int(idx[b][o]) if idx is not None else b * self.tr["batch"] + o

    def forward(self, images, precision="f32"):
        norm = self.tr["device_norm"]
        return ref_vit.forward(self.weights, self.cfg, images, norm[0], norm[1], precision)

    # -- the reference ----------------------------------------------------
    def ref_rows(self, js) -> None:
        """The reference's bank rows (normalised features, soft labels, kept
        patches) of train images `js`, and the features of those the sample
        judges; the forwards `GROUP` images at a time."""
        b, p, c = self.tr["batch"], self.cfg["patch_size"], self.tr["classes"]
        need = sorted(set(js) - set(self._ref_rows))
        noise = ref.engine_noise(engine_seed(self.ctx.seed), {j // b for j in need},
                                 (b, self.grid * self.grid), self.dev)
        keep = set(self.res["sample"].train)
        for lo in range(0, len(need), GROUP):
            group = need[lo:lo + GROUP]
            xs, ys = zip(*(self.train_image(j) for j in group))
            feats = self.forward(torch.cat(xs))
            pix = ref.patch_pixels(torch.cat(ys), p)
            u = torch.stack([noise[j // b][j % b] for j in group])
            idx = ref.sampled_patches(pix, c, self.k_rows, u)
            soft = ref.soft_labels(pix, c)
            for i, j in enumerate(group):
                self._ref_rows[j] = ref.memory_rows(feats[i], soft[i], idx[i]) + (idx[i],)
                if j in keep:
                    self._ref_feats[j] = feats[i]

    def ref_val(self, b: int, o: int) -> torch.Tensor:
        if (b, o) not in self._ref_val:
            self._ref_val[(b, o)] = self.forward(self.val_image(b, o)[0])[0]
        return self._ref_val[(b, o)]

    def exact(self, q: torch.Tensor, batch_q: Optional[torch.Tensor], rows_at, precision="f32",
              probe_precision="bf16"):
        """Top-k over what the method searches: the bank, or the probed
        leaves of the tree (tiles formed from the whole batch's queries,
        whose rows `rows_at` the sampled image's are)."""
        k = self.tr["n_neighbours"]
        if self.tree is None:
            return ref.exact_topk(q, self.bank, k, precision=precision)
        t = self.tree
        probes = ref.tile_probes(batch_q, t["centroids"], t["n_probe"], t["block_q"], probe_precision)[rows_at]
        return ref.probed_topk(q, probes, self.bank, self.perm, t["leaf_valid"], t["cap"], k, precision)

    # -- numbers ----------------------------------------------------------
    def numbers(self, side: dict) -> Dict[str, float]:
        """feat, bank, knn and pred of one side's outputs."""
        feat, bank, knn, pred = [], [], [], []
        self.ref_rows(list(side["train_feats"]) + list(side["bank"]))
        for j, f in side["train_feats"].items():
            feat.append(_rel(f, self._ref_feats[j]))
        for j, (srows, slabs) in side["bank"].items():
            rows, labs, _ = self._ref_rows[j]
            bank.append(_rel(srows, rows) + float((slabs - labs).abs().max()))
        n = self.grid * self.grid
        for (b, o), out in side["val"].items():
            q = out["q"].float()
            feat.append(_rel(q, self.ref_val(b, o)))
            batch_q = side.get("batch_q", {}).get(b)
            rows_at = slice(o * n, (o + 1) * n)
            rv, _ = self.exact(q, batch_q, rows_at, probe_precision=side.get("probe_precision", "bf16"))
            qn = torch.linalg.vector_norm(q, dim=1)
            s_side = ref.scores_of(q, self.bank, out["ids"])
            gap = (rv[:, -1] - s_side.min(dim=1).values) / qn
            err = (out["vals"].float() - s_side).abs().max(dim=1).values / qn
            knn.append(float(torch.maximum(gap, err).max()))
            hat = ref.label_transfer(out["vals"].float(), qn, self.labels[out["ids"]])
            rp = ref.predict(hat, self.grid, self.cfg["input_size"])
            pred.append(float((out["pred"].long() != rp).float().mean()))
        return {"feat": max(feat), "bank": max(bank), "knn": max(knn), "pred": max(pred)}

    def exact_numbers(self) -> Dict[str, float]:
        res, rec, c = self.res, self.res["recorder"], self.tr["classes"]
        conf = 0
        b_size = self.tr["batch"]
        for b, batch in rec.batches.items():
            if "pred" not in batch:
                continue
            gt = np.full((b_size, 1) + batch["pred"].shape[1:], MASK_IGNORE, np.uint8)
            for o in range(b_size):
                vid = self.val_id(b, o)
                if res["val_indices"] is None and vid >= self.tr["val_images"]:
                    continue  # the engine pads a ragged batch with ignored pixels
                c_i, at = divmod(vid, b_size)
                gt[o] = res["val"].masks[c_i][at]
            want = ref.confusion(gt, batch["pred"].cpu().numpy(), c)
            conf += int(np.abs(want - batch["conf"].cpu().numpy()).sum())
        mat = np.asarray(res["conf_mat"], np.int64)
        out = {
            "conf": float(conf),
            "gt_hist": float(np.abs(mat.sum(axis=1) - np.asarray(res["gt_histogram"])).sum()),
            "miou": abs(res["miou"] - ref.hungarian_miou(mat)),
        }
        if self.tree is not None:
            out["tree"] = float(self.tree_faults())
            out["leaf"], out["centroid"] = self.leaf_numbers()
        return out

    def tree_faults(self) -> int:
        """Rows misplaced, slab rows or labels unequal to the bank's, and
        fill counts unequal to the rows placed."""
        nn, t = self.engine.NN_algorithm, self.tree
        cap, lv = t["cap"], t["leaf_valid"].long()
        m = self.bank.shape[0]
        slot = torch.arange(self.perm.shape[0], device=self.dev)
        valid = (slot % cap) < lv[slot // cap]
        placed = self.perm[valid]
        faults = int((self.perm[~valid] != -1).sum()) + int((placed < 0).sum())
        faults += int(m - torch.unique(placed[placed >= 0]).numel()) + abs(int(lv.sum()) - m)
        where = valid.nonzero()[:, 0]
        for lo in range(0, where.shape[0], 1 << 18):
            s = where[lo:lo + (1 << 18)]
            rows = self.perm[s].clamp(min=0)
            faults += int((nn.bank[s] != self.bank[rows].to(nn.bank.dtype)).any(dim=1).sum())
            faults += int((nn.labels[s] != self.labels[rows]).any(dim=1).sum())
        return faults

    def leaf_numbers(self):
        """(share of bank rows whose leaf is none of their ASSIGN_CHOICES
        nearest centroids by exact f32 scores of the f32 rows, median over
        the leaves of 1 - cos(centroid, sum of its rows))."""
        t, cap = self.tree, self.tree["cap"]
        m = self.bank.shape[0]
        slot = torch.arange(self.perm.shape[0], device=self.dev)
        valid = (slot % cap) < t["leaf_valid"].long()[slot // cap]
        rows = self.perm[valid]
        ok = (rows >= 0) & (rows < m)
        leaf_of = torch.full((m,), -1, dtype=torch.int64, device=self.dev)
        leaf_of[rows[ok]] = (slot[valid] // cap)[ok]
        c = t["centroids"].float()
        a = min(ASSIGN_CHOICES, c.shape[0])
        sums = torch.zeros_like(c)
        miss, block = 0, 1 << 18
        for lo in range(0, m, block):
            rows, leaf = self.bank[lo:lo + block].float(), leaf_of[lo:lo + block]
            near = torch.topk(rows @ c.t(), a, dim=1).indices
            miss += int((near != leaf[:, None]).all(dim=1).sum())
            placed = leaf >= 0
            sums.index_add_(0, leaf[placed], rows[placed])
        held = t["leaf_valid"].long() > 0
        cos = torch.nn.functional.cosine_similarity(c[held], sums[held], dim=1)
        return miss / m, float((1.0 - cos).median())

    def program_side(self) -> dict:
        rec, eng = self.res["recorder"], self.engine
        b = self.tr["batch"]
        side = {"train_feats": {}, "bank": {}, "val": dict(rec.val), "batch_q": {}}
        for j in self.res["sample"].train:
            f = rec.train_feats.get((j // b, j % b))
            if f is None:
                raise RuntimeError(f"train image {j}'s features were never recorded")
            side["train_feats"][j] = f.float()
        for j in self.res["sample"].bank:
            rows = slice(j * self.k_rows, (j + 1) * self.k_rows)
            side["bank"][j] = (eng.feature_memory[rows], eng.label_memory[rows])
        for key in self.res["sample"].val:
            if key not in rec.val or "pred" not in rec.val[key]:
                raise RuntimeError(f"val image {key} was never answered")
        for bi, batch in rec.batches.items():
            if "q" in batch:
                side["batch_q"][bi] = batch["q"]
        return side

    def control(self) -> dict:
        """The reference a step below the program's precision, in its
        place: its forward in float8 e4m3 (the model's bfloat16 less one
        step), its memory rows, its search over the bank's rows rounded to
        float8 (on a tree, over the leaves its own queries' tiles probe),
        and its label transfer and upsampling in bfloat16 (the program's
        float32 less one step)."""
        side = {"train_feats": {}, "bank": {}, "val": {}, "batch_q": {}, "probe_precision": "fp8"}
        for j in self.res["sample"].train:
            x, _ = self.train_image(j)
            f = self.forward(x, "fp8")[0]
            self.ref_rows([j])
            _, labs, idx = self._ref_rows[j]
            side["train_feats"][j] = f
            side["bank"][j] = (f[idx] / torch.linalg.vector_norm(f[idx], dim=1, keepdim=True), labs)
        n = self.grid * self.grid
        rec = self.res["recorder"]
        for (b, o) in self.res["sample"].val:
            q = self.forward(self.val_image(b, o)[0], "fp8")[0]
            batch_q = None
            if self.tree is not None:
                batch_q = side["batch_q"].get(b)
                if batch_q is None:
                    batch_q = rec.batches[b]["q"].clone()
                batch_q[o * n:(o + 1) * n] = q
                side["batch_q"][b] = batch_q
            v, i = self.exact(q, batch_q, slice(o * n, (o + 1) * n), precision="fp8", probe_precision="fp8")
            bf16 = torch.bfloat16
            hat = ref.label_transfer(v, torch.linalg.vector_norm(q, dim=1), self.labels[i], dtype=bf16)
            side["val"][(b, o)] = {"q": q, "vals": v, "ids": i,
                                   "pred": ref.predict(hat, self.grid, self.cfg["input_size"], dtype=bf16)}
        return side


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a.float() - b.float()) / torch.linalg.vector_norm(b.float()))


def launch_faults(ctx, res: dict) -> float:
    """Launches of the window that the traffic does not name, or named
    launches of another count (card runs only: the CPU has no kernels)."""
    if ctx.device.type != "cuda":
        return 0.0
    want = {}
    for key, unit in ctx.traffic["launches"].items():
        n = res[unit.split("*")[0]]
        want[key] = n * (ctx.config["depth"] if unit.endswith("*depth") else 1)
    got = {k: v for k, v in res["launches"].items() if v}
    return float(sum(abs(got.get(k, 0) - want.get(k, 0)) for k in set(got) | set(want)))


def judge(ctx, res: dict, with_control: bool = False):
    """(numbers, control numbers or None) of a finished run."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the reference is plain f32
    torch.backends.cudnn.allow_tf32 = False
    j = Judge(ctx, res)
    numbers = j.numbers(j.program_side())
    numbers.update(j.exact_numbers())
    numbers["launches"] = launch_faults(ctx, res)
    control = j.numbers(j.control()) if with_control else None
    return numbers, control


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[name] <= limits[name] for name in limits)
