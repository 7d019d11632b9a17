"""The port's engine end to end against the JAX engine on a small VOC fixture.

Both packages read the same synthetic fixture with the stdlib `random`
seeded identically, so their data feeds give identical batches. The
colour-oracle extractor (per-patch mean colour) and a tiny random ViT
(weights carried across with `params_from_jax`) then go through
`hbird_evaluation` in both.

Tolerances: mIoU within 1e-4; each query's neighbours, scored against
the query and sorted, agree within 1e-5·||q|| for an f32 bank and
4e-3·||q|| for a bf16 bank (one bf16 ulp of a unit row), so the neighbour
sets differ at most where scores tie (flat-colour fixture patches give
exact ties for both extractors); the transferred soft labels agree within
1e-4.
"""

import random

import numpy as np
import pytest
import torch

import jax

import hbird_tpu
import hbird_tpu_torch
from hbird_tpu.data import get_dataset as jax_get_dataset
from hbird_tpu.data import transforms as jax_transforms
from hbird_tpu.data.synthetic import make_voc_fixture as jax_make_voc_fixture
from hbird_tpu.models.vit import ViT as JViT, ViTConfig as JConfig
from hbird_tpu_torch.data import get_dataset
from hbird_tpu_torch.data import transforms
from hbird_tpu_torch.data.synthetic import make_voc_fixture
from hbird_tpu_torch.hbird_eval import HbirdEvaluation, _pad_batch
from hbird_tpu_torch.models.convert import params_from_jax
from hbird_tpu_torch.models.extractor import FeatureExtractor
from hbird_tpu_torch.models.vit import ViT, ViTConfig
from hbird_tpu_torch.parallel import make_mesh

INPUT = 32
PATCH = 4
K = 5


def oracle_t(model, imgs):
    b, c, h, w = imgs.shape
    s = h // PATCH
    x = imgs.reshape(b, c, s, PATCH, s, PATCH).mean(dim=(3, 5))
    return x.permute(0, 2, 3, 1).reshape(b, s * s, c), None


def oracle_j(model, imgs):
    b, c, h, w = imgs.shape
    s = h // PATCH
    x = imgs.reshape(b, c, s, PATCH, s, PATCH).mean(axis=(3, 5))
    return x.transpose(0, 2, 3, 1).reshape(b, s * s, c), None


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc_torch") / "voc")
    make_voc_fixture(
        root, n_train=12, n_val=6, size=(64, 48), colorize=True, seed=3,
        class_pool=[1, 2, 3, 4, 5],
    )
    return root


@pytest.fixture(scope="module")
def tiny_vit():
    jcfg = JConfig(PATCH, 32, 2, 4, img_size=INPUT, layerscale=True)
    params = JViT(jcfg).init(jax.random.PRNGKey(0))
    tvit = ViT(ViTConfig(PATCH, 32, 2, 4, img_size=INPUT, layerscale=True))
    tvit.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return (JViT(jcfg), params), tvit


def _val_images(root):
    """The val feed's images, normalised as the engine does on the device."""
    va = transforms.get_hbird_val_transforms(INPUT, device_normalize=True)
    ds, _ = get_dataset("voc", root, 4, 0, va, va)
    x = np.concatenate([np.asarray(b[0]) for b in ds.val_dataloader()])
    mean = np.asarray(transforms.IMAGENET_MEAN, np.float32).reshape(1, -1, 1, 1)
    std = np.asarray(transforms.IMAGENET_STD, np.float32).reshape(1, -1, 1, 1)
    return torch.from_numpy((x.astype(np.float32) / np.float32(255.0) - mean) / std)


def _assert_neighbours_agree(q, knn_t, knn_j, bf16_bank):
    """Per query, the neighbours' scores agree: the sets differ at most
    where scores tie."""
    d = q.shape[-1]
    q = q.reshape(-1, d).astype(np.float64)
    kt = knn_t.reshape(q.shape[0], K, d).astype(np.float64)
    kj = knn_j.reshape(q.shape[0], K, d).astype(np.float64)
    st = -np.sort(-np.einsum("qd,qkd->qk", q, kt), axis=1)
    sj = -np.sort(-np.einsum("qd,qkd->qk", q, kj), axis=1)
    tol = (4e-3 if bf16_bank else 1e-5) * np.linalg.norm(q, axis=1, keepdims=True)
    assert (np.abs(st - sj) <= tol).all(), np.abs(st - sj).max()


def _run_both(root, nn_method, d_model, port, jax_side):
    """hbird_evaluation in both packages; `port`/`jax_side` hold each
    side's `model` and `ftr_extr_fn`."""
    common = dict(
        batch_size=4, input_size=INPUT, n_neighbours=K, num_workers=0,
        nn_method=nn_method, return_knn_details=True,
    )
    random.seed(1234)
    t = hbird_tpu_torch.hbird_evaluation(
        d_model=d_model, patch_size=PATCH, dataset_name="voc", data_dir=root,
        device="cpu", **port, **common,
    )
    random.seed(1234)
    j = hbird_tpu.hbird_evaluation(
        d_model=d_model, patch_size=PATCH, dataset_name="voc", data_dir=root,
        **jax_side, **common,
    )
    return t, j


@pytest.mark.parametrize("device_normalize", [True, False])
def test_data_batches_identical(voc, device_normalize):
    tr = transforms.get_hbird_train_transforms(INPUT, device_normalize=device_normalize)
    va = transforms.get_hbird_val_transforms(INPUT, device_normalize=device_normalize)
    jtr = jax_transforms.get_hbird_train_transforms(INPUT, device_normalize=device_normalize)
    jva = jax_transforms.get_hbird_val_transforms(INPUT, device_normalize=device_normalize)
    ds, ign = get_dataset("voc", voc, 5, 0, tr, va)
    jds, jign = jax_get_dataset("voc", voc, 5, 0, jtr, jva)
    assert ign == jign and ds.get_num_classes() == jds.get_num_classes()
    for loader, jloader in (
        (ds.train_dataloader, jds.train_dataloader),
        (ds.val_dataloader, jds.val_dataloader),
    ):
        random.seed(99)
        batches = [tuple(np.asarray(a) for a in b) for b in loader()]
        random.seed(99)
        jbatches = [tuple(np.asarray(a) for a in b) for b in jloader()]
        assert len(batches) == len(jbatches) > 1
        for (x, y), (jx, jy) in zip(batches, jbatches):
            assert x.dtype == jx.dtype and y.dtype == jy.dtype
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)


def test_tar_archive_feed_identical(voc, tmp_path):
    """The VOC feed read from a tar archive (the copied tarfile backend)
    gives the JAX package's batches, and the folder's."""
    from hbird_tpu.data.synthetic import folder_to_tar

    tar = str(tmp_path / "voc.tar")
    folder_to_tar(voc, tar, "VOCSegmentation")
    va = transforms.get_hbird_val_transforms(INPUT, device_normalize=True)
    jva = jax_transforms.get_hbird_val_transforms(INPUT, device_normalize=True)
    feeds = [
        get_dataset("voc", tar, 4, 2, va, va)[0],
        get_dataset("voc", voc, 4, 0, va, va)[0],
        jax_get_dataset("voc", tar, 4, 0, jva, jva)[0],
    ]
    assert feeds[0].get_train_dataset_size() == 12
    batches = [[tuple(np.asarray(a) for a in b) for b in f.val_dataloader()] for f in feeds]
    for other in batches[1:]:
        assert len(other) == len(batches[0])
        for (x, y), (ox, oy) in zip(batches[0], other):
            np.testing.assert_array_equal(x, ox)
            np.testing.assert_array_equal(y, oy)


def test_profile_dir_writes_phase_traces(voc, tmp_path, monkeypatch):
    monkeypatch.setenv("HBIRD_PROFILE_DIR", str(tmp_path / "prof"))
    from hbird_tpu_torch.utils.profiling import PhaseTimer

    timer = PhaseTimer()
    hbird_tpu_torch.hbird_evaluation(
        None, 3, PATCH, "voc", voc, batch_size=4, input_size=INPUT,
        n_neighbours=K, ftr_extr_fn=oracle_t, num_workers=0, device="cpu", timer=timer,
    )
    assert sorted(p.name for p in (tmp_path / "prof").iterdir()) == [
        "evaluate.json", "index_build.json", "memory_build.json"
    ]
    assert '"hbird.eval.consume"' in (tmp_path / "prof" / "evaluate.json").read_text()  # the program's spans
    summary = timer.summary()
    assert summary["memory_build"]["items"] == 12 and summary["evaluate"]["items"] == 6


def test_fixture_generator_is_identical(tmp_path):
    make_voc_fixture(str(tmp_path / "t"), n_train=2, n_val=1, seed=5)
    jax_make_voc_fixture(str(tmp_path / "j"), n_train=2, n_val=1, seed=5)
    for rel in ("images/train_0001.jpg", "SegmentationClassAug/train_0001.png", "sets/val.txt"):
        assert (tmp_path / "t" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes()


@pytest.mark.parametrize("nn_method", ["scann", "faiss"])
def test_oracle_engine_matches_jax(voc, nn_method):
    (jt, dt), (jj, dj) = _run_both(
        voc, nn_method, 3,
        {"model": None, "ftr_extr_fn": oracle_t},
        {"model": None, "ftr_extr_fn": oracle_j},
    )
    assert abs(jt - jj) <= 1e-4, (jt, jj)
    q, _ = oracle_t(None, _val_images(voc))
    _assert_neighbours_agree(q.numpy(), dt["knns"], dj["knns"], nn_method == "scann")
    np.testing.assert_allclose(dt["knns_ca_labels"], dj["knns_ca_labels"], atol=1e-4)


@pytest.mark.parametrize("nn_method", ["scann", "faiss"])
def test_vit_engine_matches_jax(voc, tiny_vit, nn_method):
    (jvit, params), tvit = tiny_vit
    (jt, dt), (jj, dj) = _run_both(
        voc, nn_method, 32, {"model": tvit}, {"model": (jvit, params)}
    )
    assert abs(jt - jj) <= 1e-4, (jt, jj)
    with torch.no_grad():
        q, _ = FeatureExtractor(tvit).forward_features(_val_images(voc))
    bf16 = nn_method == "scann"
    _assert_neighbours_agree(q.numpy(), dt["knns"], dj["knns"], bf16)
    np.testing.assert_allclose(dt["knns_ca_labels"], dj["knns_ca_labels"], atol=1e-4)


def test_flash_vit_engine_matches_jax(voc, tiny_vit):
    """attention_impl='flash' (K3's plain version on the CPU) against the
    JAX engine's 'flash', which runs the XLA math off a TPU."""
    import dataclasses

    (jvit, params), tvit = tiny_vit
    flash = ViT(dataclasses.replace(tvit.config, attention_impl="flash"))
    flash.load_state_dict(tvit.state_dict())
    jflash = JViT(dataclasses.replace(jvit.config, attention_impl="flash"))
    (jt, dt), (jj, dj) = _run_both(voc, "scann", 32, {"model": flash}, {"model": (jflash, params)})
    assert abs(jt - jj) <= 1e-4, (jt, jj)
    np.testing.assert_allclose(dt["knns_ca_labels"], dj["knns_ca_labels"], atol=1e-4)


def _run_ivf(root, d_model, port, jax_side, nn_params, hand_over, monkeypatch):
    """hbird_evaluation with nn_method='ivf' in both packages. With
    `hand_over`, the port's tree gets the centroids the JAX engine trained
    (its k-means init draws jax.random, which the port cannot repeat)."""
    from hbird_tpu.nn.search_approx import NearestNeighborSearchApprox as JApprox

    trained = {}
    build = JApprox._build_tree

    def spy(self, *args, **kwargs):
        build(self, *args, **kwargs)
        trained["centroids"] = np.asarray(self.centroids)

    monkeypatch.setattr(JApprox, "_build_tree", spy)
    common = dict(
        batch_size=4, input_size=INPUT, n_neighbours=K, num_workers=0,
        nn_method="ivf", return_knn_details=True,
    )
    random.seed(1234)
    j = hbird_tpu.hbird_evaluation(
        d_model=d_model, patch_size=PATCH, dataset_name="voc", data_dir=root,
        nn_params=dict(nn_params), **jax_side, **common,
    )
    params = nn_params
    if hand_over:
        from hbird_tpu_torch.ops import ivf as tivf

        centroids = torch.from_numpy(trained["centroids"])
        monkeypatch.setattr(tivf, "train_centroids", lambda sample, n_leaves, **kw: centroids)
        params = dict(nn_params, tree_refine_rounds=0)
    random.seed(1234)
    t = hbird_tpu_torch.hbird_evaluation(
        d_model=d_model, patch_size=PATCH, dataset_name="voc", data_dir=root,
        device="cpu", nn_params=params, **port, **common,
    )
    return t, j


IVF_CASES = {
    # every leaf probed: exact search, whatever the centroids
    "full_probe": ({"num_leaves": 32, "num_leaves_to_search": 32}, False),
    # 2 of 8 leaves probed, through the JAX engine's centroids
    "probe_2_of_8": ({"num_leaves": 8, "num_leaves_to_search": 2}, True),
}


@pytest.mark.parametrize("case", list(IVF_CASES))
@pytest.mark.parametrize("fixture", ["oracle", "vit"])
def test_ivf_engine_matches_jax(voc, tiny_vit, monkeypatch, fixture, case):
    nn_params, hand_over = IVF_CASES[case]
    if fixture == "oracle":
        d_model = 3
        port, jax_side = {"model": None, "ftr_extr_fn": oracle_t}, {"model": None, "ftr_extr_fn": oracle_j}
        q, _ = oracle_t(None, _val_images(voc))
    else:
        (jvit, params), tvit = tiny_vit
        d_model = 32
        port, jax_side = {"model": tvit}, {"model": (jvit, params)}
        with torch.no_grad():
            q, _ = FeatureExtractor(tvit).forward_features(_val_images(voc))
    (jt, dt), (jj, dj) = _run_ivf(voc, d_model, port, jax_side, nn_params, hand_over, monkeypatch)
    assert abs(jt - jj) <= 1e-4, (jt, jj)
    _assert_neighbours_agree(q.numpy(), dt["knns"], dj["knns"], True)
    np.testing.assert_allclose(dt["knns_ca_labels"], dj["knns_ca_labels"], atol=1e-4)


def test_ivf_engine_probes_per_tile_and_calibrates(voc, monkeypatch):
    """The eval step passes 'tile' for the backend's 'auto' (the JAX
    engine's jitted step sees tracers); a recall_target without a probe
    count calibrates it after the build."""
    from hbird_tpu_torch.models.extractor import FeatureExtractorSimple
    from hbird_tpu_torch.ops import ivf as tivf

    modes = []
    search = tivf.ivf_search

    def spy(*args, **kwargs):
        modes.append(kwargs.get("probe_mode"))
        return search(*args, **kwargs)

    monkeypatch.setattr(tivf, "ivf_search", spy)
    tr = transforms.get_hbird_train_transforms(INPUT, device_normalize=True)
    ds, _ = get_dataset("voc", voc, 4, 0, tr, tr)
    fe = FeatureExtractorSimple(None, oracle_t, eval_spatial_resolution=INPUT // PATCH, d_model=3)
    random.seed(1234)
    ev = HbirdEvaluation(
        fe, ds.train_dataloader(), num_classes=21, n_neighbours=K, device="cpu",
        nn_method="tree", nn_params={"num_leaves": 8, "recall_target": 0.9},
        device_norm=tr["device_norm"],
    )
    nn = ev.NN_algorithm
    assert nn.use_tree and nn.probe_mode == "auto"
    assert 1 <= nn.num_leaves_to_search <= 8 and set(modes) == {"tile"}  # calibration
    modes.clear()
    miou = ev.evaluate(ds.val_dataloader(), INPUT // PATCH)
    assert np.isfinite(miou) and modes == ["tile"] * 2


def test_bounded_memory_completes(voc):
    random.seed(1234)
    miou = hbird_tpu_torch.hbird_evaluation(
        None, 3, PATCH, "voc", voc, batch_size=4, input_size=INPUT,
        augmentation_epoch=2, n_neighbours=K, ftr_extr_fn=oracle_t,
        memory_size=12 * 2 * 16, num_workers=0, device="cpu",
    )
    assert np.isfinite(miou) and 0.0 <= miou <= 1.0


def test_bounded_memory_bank_size_and_labels(voc):
    from hbird_tpu_torch.models.extractor import FeatureExtractorSimple

    tr = transforms.get_hbird_train_transforms(INPUT, device_normalize=True)
    ds, _ = get_dataset("voc", voc, 4, 0, tr, tr)
    fe = FeatureExtractorSimple(None, oracle_t, eval_spatial_resolution=INPUT // PATCH, d_model=3)
    ev = HbirdEvaluation(
        fe, ds.train_dataloader(), num_classes=21, n_neighbours=K, device="cpu",
        memory_size=100, dataset_size=12, device_norm=tr["device_norm"],
    )
    assert ev.num_sampled_features == 8
    assert ev.feature_memory.shape == (96, 3)  # 12 images x 8 patches
    np.testing.assert_allclose(ev.feature_memory.norm(dim=1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(ev.label_memory.sum(dim=1).numpy(), 1.0, atol=1e-6)
    assert ev.NN_algorithm.bank.dtype == torch.bfloat16


def test_default_device_needs_cuda(voc):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device resolves to it")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            hbird_tpu_torch.hbird_evaluation(
                None, 3, PATCH, "voc", voc, batch_size=4, input_size=INPUT,
                ftr_extr_fn=oracle_t, num_workers=0, device=device,
            )


# The engine runs of the quantized and L2 paths (chip_smoke.py runs them at
# full width): method, nn_params, the engine's bf16_bank flag.
QUANT_RUNS = {
    "int8_rows": ("scann", {"quantization": "int8_rows"}, False),
    "scann_literal": ("ivf", {"quantization": "int8_asym", "dimensions_per_block": 4,
                              "anisotropic_quantization_threshold": 0.2,
                              "num_reordering_candidates": 120,
                              "num_leaves": 32, "num_leaves_to_search": 32}, False),
    "int8_rerank": ("faiss", {"use_int8": True, "num_reordering_candidates": 120}, False),
    "l2": ("faiss", {"distance_measure": "l2"}, True),
}


@pytest.mark.parametrize("run", list(QUANT_RUNS))
@pytest.mark.parametrize("fixture", ["oracle", "vit"])
def test_quantized_and_l2_engine_matches_jax(voc, tiny_vit, fixture, run):
    """hbird_evaluation with each quantized or L2 run against the JAX
    engine: mIoU within 1e-4, the transferred soft labels within 1e-4, and
    `return_knn_details` features dequantized on both sides (scored against
    the query, sorted, within one int8 step of a unit row, 1/127 of ||q||,
    where quantized scores tie)."""
    nn_method, nn_params, bf16_bank = QUANT_RUNS[run]
    if fixture == "oracle":
        d_model = 3
        port, jax_side = {"model": None, "ftr_extr_fn": oracle_t}, {"model": None, "ftr_extr_fn": oracle_j}
        q, _ = oracle_t(None, _val_images(voc))
    else:
        (jvit, params), tvit = tiny_vit
        d_model = 32
        port, jax_side = {"model": tvit}, {"model": (jvit, params)}
        with torch.no_grad():
            q, _ = FeatureExtractor(tvit).forward_features(_val_images(voc))
    common = dict(
        batch_size=4, input_size=INPUT, n_neighbours=K, num_workers=0, nn_method=nn_method,
        return_knn_details=True, bf16_bank=bf16_bank,
    )
    random.seed(1234)
    jt, dt = hbird_tpu_torch.hbird_evaluation(
        d_model=d_model, patch_size=PATCH, dataset_name="voc", data_dir=voc, device="cpu",
        nn_params=dict(nn_params), **port, **common,
    )
    random.seed(1234)
    jj, dj = hbird_tpu.hbird_evaluation(
        d_model=d_model, patch_size=PATCH, dataset_name="voc", data_dir=voc,
        nn_params=dict(nn_params), **jax_side, **common,
    )
    assert abs(jt - jj) <= 1e-4, (jt, jj)
    if fixture == "oracle" or run == "l2":
        # On the tiny ViT, int8 rounding turns the packages' ulp-level
        # feature differences into code flips that move a near-tied
        # neighbour: its quantized runs are held to the mIoU and the
        # dequantized features alone.
        np.testing.assert_allclose(dt["knns_ca_labels"], dj["knns_ca_labels"], atol=1e-4)
    q = q.numpy().reshape(-1, d_model).astype(np.float64)
    kt = dt["knns"].reshape(q.shape[0], K, d_model).astype(np.float64)
    kj = dj["knns"].reshape(q.shape[0], K, d_model).astype(np.float64)
    # dequantized features: unit-norm rows, not codes of magnitude ~127
    assert np.abs(kt).max() < 1.5 and np.abs(kj).max() < 1.5
    st = -np.sort(-np.einsum("qd,qkd->qk", q, kt), axis=1)
    sj = -np.sort(-np.einsum("qd,qkd->qk", q, kj), axis=1)
    tol = (1e-5 if run == "l2" and not bf16_bank else 1 / 127) * np.linalg.norm(q, axis=1, keepdims=True)
    assert (np.abs(st - sj) <= tol).all(), np.abs(st - sj).max()


@pytest.mark.parametrize(
    "kwargs",
    [{"mesh": make_mesh((2,), ("bank",), ["cpu", "cpu"]), "nn_method": "ivf"}],
    ids=["mesh"],
)
def test_later_slices_raise(voc, kwargs):
    """The tree on a bank mesh, which raised here until its slice was
    ported, now runs: with every leaf probed its mIoU is the unmeshed run's
    (parity with the JAX engine: tests/test_torch_sharded_ivf_engine.py)."""
    common = dict(batch_size=4, input_size=INPUT, ftr_extr_fn=oracle_t, num_workers=0, device="cpu",
                  nn_params={"num_leaves": 8, "num_leaves_to_search": 8})
    runs = []
    for extra in ({}, kwargs):
        random.seed(7)
        runs.append(hbird_tpu_torch.hbird_evaluation(None, 3, PATCH, "voc", voc, **common,
                                                     **{"nn_method": "ivf", **extra}))
    assert abs(runs[0] - runs[1]) <= 1e-6, runs


def test_pad_batch_keeps_the_known_crash():
    """A later batch larger than the first fails, as in the JAX engine."""
    from hbird_tpu.hbird_eval import _pad_batch as jax_pad_batch

    x = np.ones((3, 2), np.float32)
    padded, valid = _pad_batch(x, 5)
    jpadded, jvalid = jax_pad_batch(x, 5)
    assert valid == jvalid == 3
    np.testing.assert_array_equal(padded, jpadded)
    for fn in (_pad_batch, jax_pad_batch):
        with pytest.raises(ValueError):
            fn(np.ones((6, 2), np.float32), 5)
