"""The ADE20K, Cityscapes and COCO feeds of the port against the JAX
package's, on their synthetic fixtures, as folders and as tar archives.

Both packages' fixture generators write the same files; both feeds, with
the stdlib `random` seeded identically (the train augmentations draw from
it), give the same uint8 images and class-id masks (and, with the host
normalisation, the same float batches), exactly. Also the registry's
dataset-local ignore index, class count and the fractional-subsampling
DSL for these datasets.
"""

import filecmp
import os
import random

import numpy as np
import pytest

from hbird_tpu.data import get_dataset as jax_get_dataset
from hbird_tpu.data import synthetic as jax_synthetic
from hbird_tpu.data import transforms as jax_transforms
from hbird_tpu_torch.data import get_dataset, synthetic, transforms

INPUT = 32
# registry name, fixture maker, tar prefix, dataset-local ignore index, classes
DATASETS = {
    "ade20k": ("make_ade20k_fixture", "ade20k", 0, 151),
    "cityscapes": ("make_cityscapes_fixture", "cityscapes", 255, 19),
    "coco-stuff": ("make_coco_fixture", "coco", 255, 15),
    "coco-thing": ("make_coco_fixture", "coco", 255, 12),
}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_data")
    out = {}
    for maker, prefix in {(m, p) for m, p, _, _ in DATASETS.values()}:
        folder = str(base / prefix)
        getattr(synthetic, maker)(folder, seed=5)
        tar = str(base / f"{prefix}.tar")
        synthetic.folder_to_tar(folder, tar, prefix)
        out[prefix] = {"folder": folder, "tar": tar}
    return out


@pytest.mark.parametrize("prefix", ["ade20k", "cityscapes", "coco"])
def test_fixture_generators_write_the_same_files(tmp_path, prefix):
    maker = {"ade20k": "make_ade20k_fixture", "cityscapes": "make_cityscapes_fixture",
             "coco": "make_coco_fixture"}[prefix]
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    getattr(synthetic, maker)(a, seed=7)
    getattr(jax_synthetic, maker)(b, seed=7)
    files = sorted(os.path.relpath(os.path.join(d, f), a) for d, _, fs in os.walk(a) for f in fs)
    jfiles = sorted(os.path.relpath(os.path.join(d, f), b) for d, _, fs in os.walk(b) for f in fs)
    assert files == jfiles and files
    _, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert not mismatch and not errors
    synthetic.folder_to_tar(a, str(tmp_path / "p.tar"), prefix)
    jax_synthetic.folder_to_tar(a, str(tmp_path / "j.tar"), prefix)
    import tarfile

    with tarfile.open(tmp_path / "p.tar") as t, tarfile.open(tmp_path / "j.tar") as j:
        assert t.getnames() == j.getnames()


def _batches(loader):
    return [tuple(np.asarray(a) for a in b) for b in loader()]


@pytest.mark.parametrize("device_normalize", [True, False], ids=["uint8", "float"])
@pytest.mark.parametrize("mode", ["folder", "tar"])
@pytest.mark.parametrize("name", list(DATASETS))
def test_feed_matches_jax(roots, name, mode, device_normalize):
    _, prefix, ignore_index, n_classes = DATASETS[name]
    root = roots[prefix][mode]
    tr = transforms.get_hbird_train_transforms(INPUT, device_normalize=device_normalize)
    va = transforms.get_hbird_val_transforms(INPUT, device_normalize=device_normalize)
    jtr = jax_transforms.get_hbird_train_transforms(INPUT, device_normalize=device_normalize)
    jva = jax_transforms.get_hbird_val_transforms(INPUT, device_normalize=device_normalize)
    ds, ign = get_dataset(name, root, 2, 0, tr, va)
    jds, jign = jax_get_dataset(name, root, 2, 0, jtr, jva)
    assert ign == jign == ignore_index
    assert ds.get_num_classes() == jds.get_num_classes() == n_classes
    assert ds.get_train_dataset_size() == jds.get_train_dataset_size() > 0
    for loader, jloader in ((ds.train_dataloader, jds.train_dataloader), (ds.val_dataloader, jds.val_dataloader)):
        random.seed(11)
        batches = _batches(loader)
        random.seed(11)
        jbatches = _batches(jloader)
        assert len(batches) == len(jbatches) > 0
        for (x, y), (jx, jy) in zip(batches, jbatches):
            assert x.dtype == jx.dtype and y.dtype == jy.dtype
            assert x.shape[1:] == (3, INPUT, INPUT) and y.shape[1:] == (1, INPUT, INPUT)
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)
        ids = np.unique(y if y.dtype == np.uint8 else np.round(y * 255).astype(int))
        assert all(i < n_classes or i == ignore_index for i in ids), ids


@pytest.mark.parametrize("name", list(DATASETS))
def test_folder_and_tar_feeds_agree(roots, name):
    _, prefix, _, _ = DATASETS[name]
    va = transforms.get_hbird_val_transforms(INPUT, device_normalize=True)
    folder = _batches(get_dataset(name, roots[prefix]["folder"], 3, 0, va, va)[0].val_dataloader)
    tar = _batches(get_dataset(name, roots[prefix]["tar"], 3, 2, va, va)[0].val_dataloader)
    assert len(folder) == len(tar)
    for (x, y), (tx, ty) in zip(folder, tar):
        np.testing.assert_array_equal(x, tx)
        np.testing.assert_array_equal(y, ty)


@pytest.mark.parametrize("mode", ["folder", "tar"])
@pytest.mark.parametrize("name", list(DATASETS))
def test_fractional_subsampling_matches_jax(roots, name, mode):
    _, prefix, _, _ = DATASETS[name]
    va = transforms.get_hbird_val_transforms(INPUT)
    jva = jax_transforms.get_hbird_val_transforms(INPUT)
    random.seed(3)
    ds, _ = get_dataset(f"{name}*0.5", roots[prefix][mode], 2, 0, va, va)
    random.seed(3)
    jds, _ = jax_get_dataset(f"{name}*0.5", roots[prefix][mode], 2, 0, jva, jva)
    assert ds.get_train_dataset_size() == jds.get_train_dataset_size() >= 1
    random.seed(4)
    x = _batches(ds.train_dataloader)
    random.seed(4)
    jx = _batches(jds.train_dataloader)
    for (a, b), (ja, jb) in zip(x, jx):
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(b, jb)


def test_unknown_and_malformed_names_raise(roots):
    va = transforms.get_hbird_val_transforms(INPUT)
    with pytest.raises(ValueError, match="Unknown dataset"):
        get_dataset("nope", roots["ade20k"]["folder"], 2, 0, va, va)
    with pytest.raises(AssertionError):
        get_dataset("coco-panoptic", roots["coco"]["folder"], 2, 0, va, va)
