"""The whole step's share of the card's bf16 peak: the forward's matmul and
attention operations for every image, plus the search's products, over the
step's time × 989 TFLOP/s.

- `mfu.eval` (a flat bank): every image of the window's batches, K1's
  2·Q·M·D per batch, over the evaluate call's time.
- `mfu.job` (a tree): every train and val image of each job, K2's
  2·block_q·D per scanned row, over the jobs' time. The tree build's
  k-means products are not counted.
"""

from portbench import work
from portbench.reference.hbird import tile_leaves


def read(res, ctx):
    if res["trace"] is None or not res["trace"].activities:
        return None
    cfg = ctx.config
    tree = res.get("tree")
    if tree is None:
        if not res.get("eval_s"):
            return None
        ops = work.vit_flops(cfg, cfg["input_size"], res["images"])
        ops += res["eval_batches"] * work.k1_flops(res["queries_per_batch"], res["bank_rows"], cfg["width"])
        return 100.0 * ops / (res["eval_s"] * work.PEAK_BF16_FLOPS)
    images = res["train_images_per_job"] * cfg["augmentation_epoch"] + res["val_images_per_job"]
    ops = work.vit_flops(cfg, cfg["input_size"], images)
    lv = tree["leaf_valid"].long()
    for b in res["recorder"].batches.values():
        if "q" in b:
            lids, _ = tile_leaves(b["q"], tree["centroids"], tree["n_probe"], tree["block_q"])
            ops += work.k2_flops(tree["block_q"], int(lv[lids].sum()), b["q"].shape[1])
    return 100.0 * ops * len(res["jobs"]) / (sum(res["jobs"]) * work.PEAK_BF16_FLOPS)
