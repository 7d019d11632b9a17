"""ADE20K semantic segmentation dataset (folder and tar layouts).

Layout (reference hbird/data/ade20k/ade20k_data.py:71-85):
    root/images/{training,validation}/<id>.jpg
    root/annotations/{training,validation}/<id>.png
Tar: same under an 'ade20k/' prefix (reference ade20k_tar_data.py:128-174).
151 classes with class 0 = "other" (the dataset-local ignore index,
reference data/__init__.py:103).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from hbird_tpu_torch.data.backend import TarBackend, make_backend, pair_by_stem, stem
from hbird_tpu_torch.data.common import SegDataModule, apply_pair_transform, resolve_pipeline

_SPLIT_TO_DIR = {"train": "training", "val": "validation"}
_TAR_PREFIX = "ade20k/"


class ADE20K:
    def __init__(
        self,
        root: str,
        transforms=None,
        split: str = "train",
        skip_other_class: bool = False,
        file_set: Optional[List[str]] = None,
    ):
        assert split in _SPLIT_TO_DIR, split
        self.root = root
        self.split = split
        self.skip_other_class = skip_other_class
        self.pipeline = resolve_pipeline(transforms)
        self.backend = make_backend(root)
        sub = _SPLIT_TO_DIR[split]

        if isinstance(self.backend, TarBackend):
            img_prefix = f"{_TAR_PREFIX}images/{sub}/"
            ann_prefix = f"{_TAR_PREFIX}annotations/{sub}/"
            imgs = [
                m
                for m in self.backend.members
                if m.startswith(img_prefix) and m.lower().endswith(".jpg")
            ]
            anns = [
                m
                for m in self.backend.members
                if m.startswith(ann_prefix) and m.lower().endswith(".png")
            ]
            if file_set is None:
                self.images, self.masks = pair_by_stem(sorted(imgs), sorted(anns))
            else:
                img_map = {stem(p): p for p in imgs}
                ann_map = {stem(p): p for p in anns}
                wanted = sorted(set(file_set))
                self.images = [img_map[s] for s in wanted if s in img_map and s in ann_map]
                self.masks = [ann_map[s] for s in wanted if s in img_map and s in ann_map]
        else:
            image_dir = os.path.join(root, "images", sub)
            ann_dir = os.path.join(root, "annotations", sub)
            if file_set is None:
                imgs = [os.path.join(image_dir, f) for f in sorted(os.listdir(image_dir))]
                anns = [os.path.join(ann_dir, f) for f in sorted(os.listdir(ann_dir))]
                self.images, self.masks = pair_by_stem(imgs, anns)
            else:
                self.images = [os.path.join(image_dir, f"{f}.jpg") for f in sorted(file_set)]
                self.masks = [os.path.join(ann_dir, f"{f}.png") for f in sorted(file_set)]

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index: int):
        img = self.backend.open_image(self.images[index]).convert("RGB")
        mask = self.backend.open_image(self.masks[index])
        img_t, mask_t = apply_pair_transform(self.pipeline, img, mask)
        if self.skip_other_class:
            # class 0 ("other") -> 255 (reference ade20k_data.py:106-109).
            ids = np.rint(mask_t * 255.0).astype(np.int64)
            ids[ids == 0] = 255
            mask_t = ids.astype(np.float32) / np.float32(255.0)
        return img_t, mask_t


class Ade20kDataModule(SegDataModule):
    def __init__(
        self,
        root: str,
        train_transforms=None,
        val_transforms=None,
        shuffle: bool = False,
        num_workers: int = 8,
        batch_size: int = 64,
        drop_last: bool = False,
        train_file_set=None,
        val_file_set=None,
        loader_mode: str = "thread",
        **_,
    ):
        train_ds = ADE20K(root, train_transforms, split="train", file_set=train_file_set)
        val_ds = ADE20K(root, val_transforms, split="val", file_set=val_file_set)
        super().__init__(
            train_ds,
            val_ds,
            batch_size=batch_size,
            num_workers=num_workers,
            shuffle=shuffle,
            drop_last=drop_last,
            loader_mode=loader_mode,
            num_classes=151,
        )
