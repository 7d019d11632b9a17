"""Cityscapes dataset (folder and tar layouts) with labelId->trainId remap.

Layout (reference hbird/data/cityscapes/cityscapes_data.py:78-119):
    root/leftImg8bit/{split}/<city>/<id>_leftImg8bit.png
    root/gtFine/{split}/<city>/<id>_gtFine_labelIds.png
Tar: same under a 'cityscapes/' prefix (reference cityscapes_tar_data.py).

The 35 raw label ids are remapped to 19 train ids in the dataset itself
(reference cityscapes_data.py:28-48): valid classes
[7,8,11,12,13,17,19,20,21,22,23,24,25,26,27,28,31,32,33] -> [0..18],
everything else -> 255.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from hbird_tpu_torch.data.backend import TarBackend, make_backend
from hbird_tpu_torch.data.common import SegDataModule, apply_pair_transform, resolve_pipeline

VALID_CLASSES = [7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32, 33]
IGNORE = 255
_TAR_PREFIX = "cityscapes/"

# labelId (0..34, uint8) -> trainId lookup.
_LUT = np.full(256, IGNORE, dtype=np.uint8)
for _i, _c in enumerate(VALID_CLASSES):
    _LUT[_c] = _i
_MAX_RAW_ID = 34


def _base_from_left(name: str) -> str:
    return os.path.basename(name).split("_leftImg8bit.png")[0]


class Cityscapes:
    def __init__(
        self,
        root: str,
        transforms=None,
        split: str = "train",
        file_set: Optional[List[str]] = None,
    ):
        assert split in ("train", "val", "trainval"), split
        self.root = root
        self.split = split
        self.pipeline = resolve_pipeline(transforms)
        self.backend = make_backend(root)
        splits = ["train", "val"] if split == "trainval" else [split]
        wanted = set(file_set) if file_set is not None else None

        self.images: List[str] = []
        self.masks: List[str] = []
        if isinstance(self.backend, TarBackend):
            for sp in splits:
                img_prefix = f"{_TAR_PREFIX}leftImg8bit/{sp}/"
                members = set(self.backend.members)
                for m in sorted(members):
                    if not (m.startswith(img_prefix) and m.endswith(".png")):
                        continue
                    base = _base_from_left(m)
                    if wanted is not None and base not in wanted:
                        continue
                    mask = (
                        f"{_TAR_PREFIX}gtFine/{sp}/"
                        + m[len(img_prefix):].replace("_leftImg8bit.png", "_gtFine_labelIds.png")
                    )
                    if mask in members:
                        self.images.append(m)
                        self.masks.append(mask)
        else:
            for sp in splits:
                img_folder = os.path.join(root, "leftImg8bit", sp)
                mask_folder = os.path.join(root, "gtFine", sp)
                if not os.path.isdir(img_folder):
                    continue
                for sub_root, _, files in sorted(os.walk(img_folder)):
                    for fname in sorted(files):
                        if not fname.endswith(".png"):
                            continue
                        base = fname.split("_leftImg8bit.png")[0]
                        if wanted is not None and base not in wanted:
                            continue
                        img_path = os.path.join(sub_root, fname)
                        city = os.path.basename(os.path.dirname(img_path))
                        mask_path = os.path.join(
                            mask_folder,
                            city,
                            fname.replace("leftImg8bit", "gtFine_labelIds"),
                        )
                        if os.path.isfile(mask_path):
                            self.images.append(img_path)
                            self.masks.append(mask_path)
        if not self.images:
            raise RuntimeError(f"Found 0 images in subfolders of: {root}")

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index: int):
        img = self.backend.open_image(self.images[index]).convert("RGB")
        mask = self.backend.open_image(self.masks[index])
        raw = np.asarray(mask, dtype=np.int64)
        assert raw.max(initial=0) <= _MAX_RAW_ID, "unexpected Cityscapes label id"
        # labelId -> trainId before any geometry (reference does the remap in
        # the dataset too, cityscapes_data.py:50-56).
        train_ids = _LUT[raw]
        return apply_pair_transform(self.pipeline, img, train_ids)


class CityscapesDataModule(SegDataModule):
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
        train_ds = Cityscapes(root, train_transforms, split="train", file_set=train_file_set)
        val_ds = Cityscapes(root, val_transforms, split="val", file_set=val_file_set)
        super().__init__(
            train_ds,
            val_ds,
            batch_size=batch_size,
            num_workers=num_workers,
            shuffle=shuffle,
            drop_last=drop_last,
            loader_mode=loader_mode,
            num_classes=19,
        )
