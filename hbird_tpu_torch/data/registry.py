"""Dataset factory: name -> (datamodule, ignore_index).

Mirrors the reference's `get_dataset` (hbird/data/__init__.py:39-198):
- 'voc', 'ade20k', 'cityscapes', 'coco-thing', 'coco-stuff'
- fractional subsampling DSL 'name*fract' (random.shuffle + truncate)
- tar-vs-folder auto-selection by '.tar' in data_dir (here handled inside
  the datasets via the byte backend)
- per-dataset ignore_index: voc/cityscapes/coco=255, ade20k=0
- default VOC fileset resolution under root/sets/ (the reference's tar
  variant of this default has a malformed '!'-path bug,
  data/__init__.py:60-63 — fixed here: archive.tar!/VOCSegmentation/sets/...)
"""

from __future__ import annotations

import os
import random
from typing import Any, Optional, Tuple

from hbird_tpu_torch.data.ade20k import Ade20kDataModule
from hbird_tpu_torch.data.cityscapes import CityscapesDataModule
from hbird_tpu_torch.data.coco import CocoDataModule
from hbird_tpu_torch.data.voc import VOCDataModule
from hbird_tpu_torch.utils.io import list_files, read_file_set
from hbird_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def get_dataset(
    dataset_name: str,
    data_dir: str,
    batch_size: int,
    num_workers: int,
    train_transforms,
    val_transforms,
    train_fs_path: Optional[str] = None,
    val_fs_path: Optional[str] = None,
    loader_mode: str = "thread",
    **kwargs: Any,
) -> Tuple[Any, int]:
    train_file_set = read_file_set(train_fs_path) if train_fs_path else None
    val_file_set = read_file_set(val_fs_path) if val_fs_path else None

    sample_fract: Optional[float] = None
    if "*" in dataset_name:
        dataset_name, fract = dataset_name.split("*")
        sample_fract = float(fract)
        logger.info("Using %.3f fraction of the %s dataset.", sample_fract, dataset_name)

    is_tar = data_dir.endswith(".tar")

    if dataset_name == "voc":
        if train_file_set is None:
            p = (
                f"{data_dir}!/VOCSegmentation/sets/trainaug.txt"
                if is_tar
                else os.path.join(data_dir, "sets", "trainaug.txt")
            )
            train_file_set = read_file_set(p)
        if val_file_set is None:
            p = (
                f"{data_dir}!/VOCSegmentation/sets/val.txt"
                if is_tar
                else os.path.join(data_dir, "sets", "val.txt")
            )
            val_file_set = read_file_set(p)
        if sample_fract is not None:
            random.shuffle(train_file_set)
            train_file_set = train_file_set[: int(len(train_file_set) * sample_fract)]
        ignore_index = 255
        dataset = VOCDataModule(
            batch_size=batch_size,
            num_workers=num_workers,
            train_split="trainaug",
            val_split="val",
            data_dir=data_dir,
            train_image_transform=train_transforms,
            val_transforms=val_transforms,
            shuffle=False,
            return_masks=True,
            drop_last=False,
            train_file_set=train_file_set,
            val_file_set=val_file_set,
            loader_mode=loader_mode,
        ).setup()

    elif dataset_name == "ade20k":
        if sample_fract is not None:
            if train_file_set is None:
                search = f"{data_dir}!/ade20k" if is_tar else data_dir
                train_file_set = [
                    f.replace(".jpg", "")
                    for f in list_files(os.path.join(search, "images", "training"))
                    if f.endswith(".jpg")
                ]
            random.shuffle(train_file_set)
            train_file_set = train_file_set[: int(len(train_file_set) * sample_fract)]
        ignore_index = 0
        dataset = Ade20kDataModule(
            data_dir,
            train_transforms=train_transforms,
            val_transforms=val_transforms,
            shuffle=False,
            num_workers=num_workers,
            batch_size=batch_size,
            train_file_set=train_file_set,
            drop_last=False,
            val_file_set=val_file_set,
            loader_mode=loader_mode,
        ).setup()

    elif dataset_name == "cityscapes":
        if sample_fract is not None:
            if train_file_set is None:
                search = f"{data_dir}!/cityscapes" if is_tar else data_dir
                img_folder = os.path.join(search, "leftImg8bit", "train")
                train_file_set = [
                    os.path.basename(f).split("_leftImg8bit.png")[0]
                    for f in list_files(img_folder)
                    if f.endswith(".png")
                ]
            random.shuffle(train_file_set)
            train_file_set = train_file_set[: int(len(train_file_set) * sample_fract)]
        ignore_index = 255
        dataset = CityscapesDataModule(
            root=data_dir,
            train_transforms=train_transforms,
            val_transforms=val_transforms,
            shuffle=False,
            num_workers=num_workers,
            batch_size=batch_size,
            drop_last=False,
            train_file_set=train_file_set,
            val_file_set=val_file_set,
            loader_mode=loader_mode,
        ).setup()

    elif "coco" in dataset_name:
        parts = dataset_name.split("-")
        assert len(parts) == 2, "use 'coco-thing' or 'coco-stuff'"
        mask_type = parts[-1]
        assert mask_type in ("thing", "stuff")
        ignore_index = 255
        if sample_fract is not None:
            if train_file_set is None:
                search = (
                    f"{data_dir}!/coco/images/train2017"
                    if is_tar
                    else os.path.join(data_dir, "images", "train2017")
                )
                train_file_set = list_files(search)
            random.shuffle(train_file_set)
            train_file_set = train_file_set[: int(len(train_file_set) * sample_fract)]
        dataset = CocoDataModule(
            batch_size=batch_size,
            num_workers=num_workers,
            data_dir=data_dir,
            mask_type=mask_type,
            train_transforms=train_transforms,
            val_transforms=val_transforms,
            train_file_set=train_file_set,
            drop_last=False,
            val_file_set=val_file_set,
            loader_mode=loader_mode,
        ).setup()

    else:
        raise ValueError("Unknown dataset name")

    logger.info(
        "Dataset=%s | train=%d imgs | num_classes=%d | ignore_index=%d",
        dataset_name,
        dataset.get_train_dataset_size(),
        dataset.get_num_classes(),
        ignore_index,
    )
    return dataset, ignore_index
