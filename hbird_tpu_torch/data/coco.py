"""COCO-Stuff / COCO-Things coarse semantic segmentation (folder and tar).

Layout (reference hbird/data/coco/coco_data.py:98-144):
    root/images/{train,val}2017/<id>.jpg
    thing: root/annotations/{split}2017/<id>.png
           + root/annotations/panoptic_annotations/panoptic_val2017.json
    stuff: root/annotations/stuff_annotations/stuff_{split}2017_pixelmaps/<id>.png
           + root/annotations/stuff_annotations/stuff_val2017.json

Category ids are merged to coarse supercategories from the JSON:
- stuff: {0} U [92,183] -> [0,14] U {255} ("other"->255, things(0)->183->...)
  (reference coco_data.py:122-127, 156-169)
- thing: panoptic categories, isthing==1 -> supercategory index [0,11],
  stuff -> 255, unlabeled(0) -> 200 -> mapped (reference coco_data.py:113-121,
  170-185)

The remap runs AFTER the paired transforms (on nearest-resized ids), same
order as the reference.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from hbird_tpu_torch.data.backend import TarBackend, make_backend, stem
from hbird_tpu_torch.data.common import SegDataModule, apply_pair_transform, resolve_pipeline

_TAR_PREFIX = "coco/"


def _build_cat_id_map(categories: List[dict], mask_type: str) -> Dict[int, int]:
    if mask_type == "thing":
        thing_sups = sorted(
            {c["supercategory"] for c in categories if c.get("isthing") == 1}
        )
        sup_to_id = {s: i for i, s in enumerate(thing_sups)}
        cat_map = {}
        for c in categories:
            if c.get("isthing") == 1:
                cat_map[c["id"]] = sup_to_id[c["supercategory"]]
            elif c.get("isthing") == 0:
                cat_map[c["id"]] = 255
        return cat_map
    sups = {c["supercategory"] for c in categories}
    sups.discard("other")
    sup_to_id = {s: i for i, s in enumerate(sorted(sups))}
    sup_to_id["other"] = 255
    return {c["id"]: sup_to_id[c["supercategory"]] for c in categories}


def _stuff_lut(cat_map: Dict[int, int]) -> np.ndarray:
    lut = np.full(256, 255, dtype=np.int64)
    for cid, tgt in cat_map.items():
        lut[cid] = tgt
    lut[0] = cat_map.get(183, 255)  # things(0) -> 183 ("other") -> its target
    return lut


def _thing_lut(cat_map: Dict[int, int]) -> np.ndarray:
    lut = np.full(256, 255, dtype=np.int64)
    for cid in range(256):
        if cid in cat_map and cid <= 200:
            lut[cid] = cat_map[cid]
    lut[0] = cat_map[200] if 200 in cat_map else 255  # unlabeled -> "stuff" id 200
    return lut


class COCOSegmentation:
    def __init__(
        self,
        root: str,
        mask_type: str,
        image_set: str = "train",
        transforms=None,
        file_set: Optional[List[str]] = None,
    ):
        assert image_set in ("train", "val")
        assert mask_type in ("stuff", "thing")
        self.root = root
        self.mask_type = mask_type
        self.image_set = image_set
        self.pipeline = resolve_pipeline(transforms)
        self.backend = make_backend(root)

        if mask_type == "thing":
            seg_folder = f"annotations/{image_set}2017/"
            json_file = "annotations/panoptic_annotations/panoptic_val2017.json"
        else:
            seg_folder = f"annotations/stuff_annotations/stuff_{image_set}2017_pixelmaps/"
            json_file = "annotations/stuff_annotations/stuff_val2017.json"
        img_folder = f"images/{image_set}2017/"

        is_tar = isinstance(self.backend, TarBackend)
        if is_tar:
            raw = self.backend.read(_TAR_PREFIX + json_file)
            categories = json.loads(raw)["categories"]
        else:
            with open(os.path.join(root, json_file)) as f:
                categories = json.load(f)["categories"]
        cat_map = _build_cat_id_map(categories, mask_type)
        self.lut = _thing_lut(cat_map) if mask_type == "thing" else _stuff_lut(cat_map)
        self.cat_id_map = cat_map

        if is_tar:
            imgs = sorted(
                m
                for m in self.backend.members
                if m.startswith(_TAR_PREFIX + img_folder) and m.lower().endswith(".jpg")
            )
            masks = sorted(
                m
                for m in self.backend.members
                if m.startswith(_TAR_PREFIX + seg_folder) and m.lower().endswith(".png")
            )
            if file_set is not None:
                wanted = {stem(f) for f in file_set}
                imgs = [p for p in imgs if stem(p) in wanted]
                masks = [p for p in masks if stem(p) in wanted]
            img_map = {stem(p): p for p in imgs}
            mask_map = {stem(p): p for p in masks}
            common = sorted(set(img_map) & set(mask_map))
            self.images = [img_map[s] for s in common]
            self.masks = [mask_map[s] for s in common]
        else:
            image_dir = os.path.join(root, img_folder)
            ann_dir = os.path.join(root, seg_folder)
            if not (os.path.isdir(image_dir) and os.path.isdir(ann_dir)):
                raise RuntimeError("Dataset not found or corrupted.")
            if file_set is None:
                names = sorted(os.listdir(image_dir))
                stems = [stem(n) for n in names if n.lower().endswith(".jpg")]
            else:
                stems = sorted({stem(f) for f in file_set})
            self.images = [os.path.join(image_dir, f"{s}.jpg") for s in stems]
            self.masks = [os.path.join(ann_dir, f"{s}.png") for s in stems]

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index: int):
        img = self.backend.open_image(self.images[index]).convert("RGB")
        mask = self.backend.open_image(self.masks[index])
        img_t, mask_t = apply_pair_transform(self.pipeline, img, mask)
        ids = np.rint(mask_t * 255.0).astype(np.int64)
        ids = self.lut[np.clip(ids, 0, 255)]
        mask_t = ids.astype(np.float32) / np.float32(255.0)
        return img_t, mask_t


class CocoDataModule(SegDataModule):
    def __init__(
        self,
        num_workers: int = 8,
        batch_size: int = 64,
        data_dir: str = "",
        train_transforms=None,
        val_transforms=None,
        mask_type: str = "stuff",
        shuffle: bool = False,
        drop_last: bool = False,
        train_file_set: Optional[List[str]] = None,
        val_file_set: Optional[List[str]] = None,
        loader_mode: str = "thread",
        **_,
    ):
        self.mask_type = mask_type
        train_ds = COCOSegmentation(
            data_dir, mask_type, "train", transforms=train_transforms, file_set=train_file_set
        )
        val_ds = COCOSegmentation(
            data_dir, mask_type, "val", transforms=val_transforms, file_set=val_file_set
        )
        super().__init__(
            train_ds,
            val_ds,
            batch_size=batch_size,
            num_workers=num_workers,
            shuffle=shuffle,
            drop_last=drop_last,
            loader_mode=loader_mode,
            num_classes=12 if mask_type == "thing" else 15,
        )
