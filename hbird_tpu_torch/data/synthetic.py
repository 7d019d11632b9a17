"""Synthetic dataset fixtures (VOC/ADE20K/Cityscapes/COCO layouts).

The reference ships curated mini-filesets and downloadable "Tiny VOC"
archives for smoke tests (reference file_sets/, DATASET.md:49-52). This
module generates equivalent tiny fixtures locally: random images whose
segmentation masks are deterministic functions of simple geometry, in the
exact on-disk layouts the loaders expect — folder or tar.
"""

from __future__ import annotations

import io
import json
import os
import tarfile
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image


def _random_image(rng: np.random.Generator, size: Tuple[int, int]) -> Image.Image:
    arr = rng.integers(0, 256, size=(size[1], size[0], 3), dtype=np.uint8)
    return Image.fromarray(arr, "RGB")


def _blob_mask(
    rng: np.random.Generator,
    size: Tuple[int, int],
    class_ids: List[int],
    ignore_id: Optional[int] = None,
) -> Image.Image:
    """Mask of random axis-aligned rectangles over a background of class_ids[0]."""
    w, h = size
    mask = np.full((h, w), class_ids[0], dtype=np.uint8)
    for cid in class_ids[1:]:
        x0, y0 = int(rng.integers(0, w // 2)), int(rng.integers(0, h // 2))
        x1 = int(rng.integers(x0 + max(1, w // 8), w))
        y1 = int(rng.integers(y0 + max(1, h // 8), h))
        mask[y0:y1, x0:x1] = cid
    if ignore_id is not None and rng.random() < 0.5:
        x0 = int(rng.integers(0, w - 2))
        y0 = int(rng.integers(0, h - 2))
        mask[y0 : y0 + 2, x0 : x0 + 2] = ignore_id
    return Image.fromarray(mask, "L")


def _save(img: Image.Image, path: str, fmt: str):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if fmt == "JPEG":
        # High quality + no chroma subsampling: keeps the class-coded colors
        # of colorized fixtures intact for oracle tests.
        img.save(path, format=fmt, quality=95, subsampling=0)
    else:
        img.save(path, format=fmt)


def colorize_mask(mask: np.ndarray, num_classes: int) -> Image.Image:
    """Image whose pixel color is a deterministic function of the class id —
    lets tests use an 'oracle' feature extractor where patch color == class."""
    cid = mask.astype(np.int64) % max(num_classes, 1)
    r = (cid * 11 % 256).astype(np.uint8)
    g = (cid * 47 % 256).astype(np.uint8)
    b = (cid * 83 % 256).astype(np.uint8)
    return Image.fromarray(np.stack([r, g, b], axis=-1), "RGB")


def make_voc_fixture(
    root: str,
    n_train: int = 8,
    n_val: int = 4,
    size: Tuple[int, int] = (64, 48),
    num_classes: int = 21,
    seed: int = 0,
    colorize: bool = False,
    class_pool: Optional[List[int]] = None,
) -> None:
    """VOC-layout fixture: images/, SegmentationClass[Aug]/, sets/.

    With colorize=True, images are deterministic colorizations of their
    masks (class-coded colors) so retrieval pipelines can be validated
    end-to-end without a pretrained backbone. `class_pool` restricts the
    drawn foreground classes (so a small train split can cover every val
    class).
    """
    rng = np.random.default_rng(seed)
    pool = np.asarray(
        class_pool if class_pool is not None else list(range(1, num_classes))
    )
    train_ids = [f"train_{i:04d}" for i in range(n_train)]
    val_ids = [f"val_{i:04d}" for i in range(n_val)]
    for ids, seg_dir in ((train_ids, "SegmentationClassAug"), (val_ids, "SegmentationClass")):
        for s in ids:
            classes = [0] + list(rng.choice(pool, size=min(3, len(pool)), replace=False))
            mask_img = _blob_mask(
                rng, size, [int(c) for c in classes],
                ignore_id=None if colorize else 255,
            )
            if colorize:
                img = colorize_mask(np.asarray(mask_img), num_classes)
            else:
                img = _random_image(rng, size)
            _save(img, os.path.join(root, "images", f"{s}.jpg"), "JPEG")
            _save(mask_img, os.path.join(root, seg_dir, f"{s}.png"), "PNG")
    os.makedirs(os.path.join(root, "sets"), exist_ok=True)
    with open(os.path.join(root, "sets", "trainaug.txt"), "w") as f:
        f.write("\n".join(train_ids))
    with open(os.path.join(root, "sets", "val.txt"), "w") as f:
        f.write("\n".join(val_ids))


def make_ade20k_fixture(
    root: str, n_train: int = 6, n_val: int = 3, size=(64, 48), seed: int = 0
) -> None:
    rng = np.random.default_rng(seed)
    for split, n in (("training", n_train), ("validation", n_val)):
        for i in range(n):
            s = f"ADE_{split[:5]}_{i:08d}"
            classes = [0] + list(rng.choice(np.arange(1, 151), size=3, replace=False))
            _save(_random_image(rng, size), os.path.join(root, "images", split, f"{s}.jpg"), "JPEG")
            _save(
                _blob_mask(rng, size, [int(c) for c in classes]),
                os.path.join(root, "annotations", split, f"{s}.png"),
                "PNG",
            )


def make_cityscapes_fixture(
    root: str, n_train: int = 4, n_val: int = 2, size=(64, 48), seed: int = 0
) -> None:
    from hbird_tpu_torch.data.cityscapes import VALID_CLASSES

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        for i in range(n):
            city = "fixcity"
            s = f"{city}_{i:06d}_000019"
            classes = [int(rng.choice(VALID_CLASSES))] + [
                int(c) for c in rng.choice(VALID_CLASSES, size=2, replace=False)
            ] + [0]  # raw id 0 -> remapped to 255
            _save(
                _random_image(rng, size),
                os.path.join(root, "leftImg8bit", split, city, f"{s}_leftImg8bit.png"),
                "PNG",
            )
            _save(
                _blob_mask(rng, size, classes),
                os.path.join(root, "gtFine", split, city, f"{s}_gtFine_labelIds.png"),
                "PNG",
            )


def make_coco_fixture(
    root: str, n_train: int = 4, n_val: int = 2, size=(64, 48), seed: int = 0
) -> None:
    """COCO fixture covering both stuff and thing annotation trees."""
    rng = np.random.default_rng(seed)
    # Minimal category JSONs.
    stuff_cats = [
        {"id": cid, "supercategory": sup}
        for cid, sup in [
            (92, "textile"), (93, "textile"), (100, "plant"), (120, "ground"),
            (150, "sky"), (160, "water"), (170, "wall"), (183, "other"),
        ]
    ]
    # Pad supercategories to reach 15 stuff coarse labels + "other".
    # 6 sups above (excl. "other") + 9 here = the 15 coarse stuff classes.
    extra_sups = ["building", "ceiling", "floor", "food", "furniture",
                  "raw-material", "solid", "structural", "window"]
    nxt = 95
    for sup in extra_sups:
        while any(c["id"] == nxt for c in stuff_cats):
            nxt += 1
        stuff_cats.append({"id": nxt, "supercategory": sup})
        nxt += 1
    pano_cats = [
        {"id": cid, "supercategory": sup, "isthing": 1}
        for cid, sup in [
            (1, "person"), (2, "vehicle"), (3, "vehicle"), (16, "animal"),
            (17, "animal"), (27, "accessory"), (44, "kitchen"), (47, "kitchen"),
            (62, "furniture"), (67, "furniture"), (72, "electronic"),
            (84, "indoor"), (85, "outdoor"), (90, "appliance"), (33, "sports"),
            (52, "food"),
        ]
    ] + [{"id": 200, "supercategory": "stuffarea", "isthing": 0}]
    os.makedirs(os.path.join(root, "annotations", "stuff_annotations"), exist_ok=True)
    os.makedirs(os.path.join(root, "annotations", "panoptic_annotations"), exist_ok=True)
    with open(os.path.join(root, "annotations", "stuff_annotations", "stuff_val2017.json"), "w") as f:
        json.dump({"categories": stuff_cats}, f)
    with open(
        os.path.join(root, "annotations", "panoptic_annotations", "panoptic_val2017.json"), "w"
    ) as f:
        json.dump({"categories": pano_cats}, f)

    stuff_ids = [c["id"] for c in stuff_cats]
    thing_ids = [c["id"] for c in pano_cats if c["isthing"] == 1]
    for split, n in (("train", n_train), ("val", n_val)):
        for i in range(n):
            s = f"{i:012d}"
            _save(
                _random_image(rng, size),
                os.path.join(root, "images", f"{split}2017", f"{s}.jpg"),
                "JPEG",
            )
            sids = [int(c) for c in rng.choice(stuff_ids, size=3, replace=False)]
            _save(
                _blob_mask(rng, size, [92] + sids),
                os.path.join(
                    root, "annotations", "stuff_annotations",
                    f"stuff_{split}2017_pixelmaps", f"{s}.png",
                ),
                "PNG",
            )
            tids = [int(c) for c in rng.choice(thing_ids, size=3, replace=False)]
            _save(
                _blob_mask(rng, size, [0] + tids),
                os.path.join(root, "annotations", f"{split}2017", f"{s}.png"),
                "PNG",
            )


def folder_to_tar(folder: str, tar_path: str, inner_prefix: str) -> None:
    """Pack a fixture folder into a tar with the given inner prefix
    ('VOCSegmentation', 'ade20k', 'cityscapes', 'coco')."""
    with tarfile.open(tar_path, "w") as tar:
        for root_dir, _, files in os.walk(folder):
            for fname in sorted(files):
                full = os.path.join(root_dir, fname)
                rel = os.path.relpath(full, folder)
                tar.add(full, arcname=os.path.join(inner_prefix, rel))
