"""The engine and the command line on a device mesh (parallel/), on the CPU.

A port mesh may repeat a device, so 4 and 8 CPU "devices" hold 4 and 8
bank shards here. The JAX engine's own mesh tests
(tests/test_engine.py::test_sharded_bank_matches_single, :253
test_2d_mesh_data_and_bank and :277 test_mesh_ring_strategy_matches_single)
hold its meshed runs within 1e-6 of its unmeshed run and sit in the slow
tier; the port is held the same way, and its meshed runs are held to the
JAX engine's unmeshed run within 1e-4:

- `hbird_evaluation(..., mesh=...)` on ('bank',) 4 shards, ('data', 'bank')
  2 x 4 and the ring over 8: mIoU within 1e-6 of the port's unmeshed run
  (colour oracle and a tiny random ViT), within 1e-4 of the JAX engine's;
  a bounded bank too;
- the meshed bank is accumulated padded to equal shards with its real rows
  as valid_rows, and saved without the padding;
- a .bankdir loads straight into padded shards (`load_memory_sharded(...,
  mesh=)`), and a reload onto the mesh gives the run's mIoU exactly;
- `eval_cli --mesh-bank 4 --mesh-devices cpu,cpu,cpu,cpu` equals the
  unmeshed command within 1e-6 and the JAX command within 1e-4.
"""

import json
import random

import numpy as np
import pytest
import torch

import jax

import hbird_tpu
import hbird_tpu_torch
from hbird_tpu.models.vit import ViT as JViT, ViTConfig as JConfig
from hbird_tpu_torch import eval_cli
from hbird_tpu_torch.bank import io as tio
from hbird_tpu_torch.data.synthetic import make_voc_fixture
from hbird_tpu_torch.hbird_eval import HbirdEvaluation
from hbird_tpu_torch.models.convert import params_from_jax
from hbird_tpu_torch.models.extractor import FeatureExtractorSimple
from hbird_tpu_torch.models.vit import ViT, ViTConfig
from hbird_tpu_torch.parallel import make_mesh, pad_rows_for_mesh

INPUT, PATCH, K = 32, 4, 5
S = INPUT // PATCH


def oracle_t(model, imgs):
    b, c, h, w = imgs.shape
    x = imgs.reshape(b, c, S, PATCH, S, PATCH).mean(dim=(3, 5))
    return x.permute(0, 2, 3, 1).reshape(b, S * S, c), None


def oracle_j(model, imgs):
    b, c, h, w = imgs.shape
    x = imgs.reshape(b, c, S, PATCH, S, PATCH).mean(axis=(3, 5))
    return x.transpose(0, 2, 3, 1).reshape(b, S * S, c), None


def cpu_mesh(shape, axes):
    return make_mesh(shape, axes, ["cpu"] * int(np.prod(shape)))


MESHES = {
    "bank4": (lambda: cpu_mesh((4,), ("bank",)), {}),
    "data2_bank4": (lambda: cpu_mesh((2, 4), ("data", "bank")), {}),
    "ring8": (lambda: cpu_mesh((8,), ("bank",)), {"shard_strategy": "ring"}),
}


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc_mesh") / "voc")
    make_voc_fixture(root, n_train=12, n_val=6, size=(64, 48), colorize=True, seed=3, class_pool=[1, 2, 3, 4, 5])
    return root


@pytest.fixture(scope="module")
def tiny_vit():
    jcfg = JConfig(PATCH, 32, 2, 4, img_size=INPUT, layerscale=True)
    params = JViT(jcfg).init(jax.random.PRNGKey(0))
    tvit = ViT(ViTConfig(PATCH, 32, 2, 4, img_size=INPUT, layerscale=True))
    tvit.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return (JViT(jcfg), params), tvit


def _port(root, mesh=None, nn_params=None, model=None, d_model=3, **kw):
    random.seed(1234)
    extra = {"ftr_extr_fn": oracle_t} if model is None else {}
    return hbird_tpu_torch.hbird_evaluation(
        model, d_model=d_model, patch_size=PATCH, dataset_name="voc", data_dir=root, batch_size=4,
        input_size=INPUT, n_neighbours=K, num_workers=0, device="cpu", mesh=mesh, nn_params=nn_params,
        **extra, **kw,
    )


def _jax(root, model=None, d_model=3, **kw):
    random.seed(1234)
    extra = {"ftr_extr_fn": oracle_j} if model is None else {}
    return hbird_tpu.hbird_evaluation(
        model, d_model=d_model, patch_size=PATCH, dataset_name="voc", data_dir=root, batch_size=4,
        input_size=INPUT, n_neighbours=K, num_workers=0, **extra, **kw,
    )


@pytest.mark.parametrize("nn_method", ["scann", "faiss"])
def test_meshed_oracle_runs_match_unmeshed_and_jax(voc, nn_method):
    single = _port(voc, nn_method=nn_method)
    want = _jax(voc, nn_method=nn_method)
    assert abs(single - want) <= 1e-4
    for name, (mesh, params) in MESHES.items():
        got = _port(voc, mesh(), params, nn_method=nn_method)
        assert got == pytest.approx(single, abs=1e-6), name
        assert abs(got - want) <= 1e-4, name


def test_meshed_vit_runs_match_unmeshed_and_jax(voc, tiny_vit):
    (jvit, params), tvit = tiny_vit
    single = _port(voc, model=tvit, d_model=32)
    want = _jax(voc, model=(jvit, params), d_model=32)
    assert abs(single - want) <= 1e-4
    for name in ("data2_bank4", "ring8"):
        mesh, params_ = MESHES[name]
        got = _port(voc, mesh(), params_, model=tvit, d_model=32)
        assert got == pytest.approx(single, abs=1e-6), name
        assert abs(got - want) <= 1e-4, name


def test_bounded_meshed_bank(voc):
    single = _port(voc, memory_size=300)
    got = _port(voc, cpu_mesh((4,), ("bank",)), memory_size=300)
    assert got == pytest.approx(single, abs=1e-6)


def _engine(root, mesh, **kw):
    from hbird_tpu_torch.data import get_dataset
    from hbird_tpu_torch.data.transforms import get_hbird_val_transforms

    random.seed(1234)
    va = get_hbird_val_transforms(INPUT)
    ds, _ = get_dataset("voc", root, 5, 0, va, va)  # 12 images: batches of 5, 5, 2
    fe = FeatureExtractorSimple(None, oracle_t, eval_spatial_resolution=S, d_model=3)
    ev = HbirdEvaluation(fe, ds.train_dataloader(), num_classes=21, n_neighbours=K, device="cpu", mesh=mesh,
                         dataset_size=ds.get_train_dataset_size(), **kw)
    return ev, ev.evaluate(ds.val_dataloader(), S, ignore_index=255)


def test_meshed_bank_is_padded_and_saved_without_padding(voc, tmp_path):
    ev0, single = _engine(voc, None)
    f_p, l_p = str(tmp_path / "f.bankdir"), str(tmp_path / "l.bankdir")
    ev, got = _engine(voc, cpu_mesh((2, 4), ("data", "bank")), f_mem_p=f_p, l_mem_p=l_p)
    assert got == pytest.approx(single, abs=1e-6)
    rows = 12 * S * S
    assert ev._bank_valid_rows == rows and ev.NN_algorithm.valid_rows == rows
    assert ev.feature_memory.shape[0] == pad_rows_for_mesh(rows, 4)
    # the data axis changes the forward's batch shape: reductions may round
    # in another order
    np.testing.assert_allclose(ev.feature_memory[:rows].numpy(), ev0.feature_memory.numpy(), rtol=0, atol=1e-6)
    assert not ev.feature_memory[rows:].any()
    assert len(ev.NN_algorithm.bank) == 4
    np.testing.assert_array_equal(tio.load_memory(f_p, device="cpu").numpy(), ev.feature_memory[:rows].numpy())
    # batches of 5 on a 2-row data axis are padded to 6
    assert ev._pad_target(5) == 6 and ev0._pad_target(5) == 5


def test_bankdir_loads_onto_the_mesh(voc, tmp_path):
    x = np.random.default_rng(0).normal(size=(1003, 8)).astype(np.float32)
    p = tio.save_memory_sharded(torch.from_numpy(x), str(tmp_path / "x.bankdir"), chunk_rows=300)
    shards, rows = tio.load_memory_sharded(p, mesh=cpu_mesh((8,), ("bank",)))
    assert rows == 1003 and [s.shape for s in shards] == [(128, 8)] * 8
    full = torch.cat(shards)
    assert torch.equal(full[:rows], torch.from_numpy(x)) and not full[rows:].any()
    shards16, _ = tio.load_memory_sharded(p, mesh=cpu_mesh((2,), ("bank",)), dtype=torch.bfloat16)
    assert shards16[0].dtype == torch.bfloat16

    f_p, l_p = str(tmp_path / "f.bankdir"), str(tmp_path / "l.bankdir")
    mesh = cpu_mesh((4,), ("bank",))
    _, built = _engine(voc, mesh, f_mem_p=f_p, l_mem_p=l_p)
    ev, loaded = _engine(voc, mesh, f_mem_p=f_p, l_mem_p=l_p, load_memory=True)
    assert loaded == built
    assert isinstance(ev.feature_memory, list) and ev._bank_valid_rows == 12 * S * S
    assert ev.timer.summary()["memory_build"].get("items", 0) == 0


def _argv(root, ckpt, out, *extra):
    return ["--dataset-name", "voc", "--data-dir", root, "--model", "dino_vits16", "--checkpoint", ckpt,
            "--d-model", "384", "--patch-size", "16", "--input-size", "32", "--batch-size", "4",
            "--num-workers", "0", "--n-neighbours", "5", "--out", out, "--log-level", "WARNING", *extra]


def test_cli_mesh_bank(voc, tmp_path):
    from hbird_tpu.eval_cli import main as jax_main

    from test_torch_cli import _timm_state_dict

    # dino_vits16's width and patch, two blocks (as tests/test_torch_cli.py)
    ckpt = str(tmp_path / "tiny_dino_vits16.pth")
    torch.save(_timm_state_dict(384, 2, 16, 14 * 14, np.random.default_rng(0)), ckpt)
    outs = {name: str(tmp_path / f"{name}.json") for name in ("single", "mesh", "jax")}
    eval_cli.main(_argv(voc, ckpt, outs["single"], "--device", "cpu"))
    eval_cli.main(_argv(voc, ckpt, outs["mesh"], "--device", "cpu", "--mesh-bank", "4", "--mesh-devices",
                        "cpu,cpu,cpu,cpu"))
    jax_main(_argv(voc, ckpt, outs["jax"], "--platform", "cpu", "--compilation-cache", ""))
    single, mesh, want = (json.load(open(outs[n]))["miou"] for n in ("single", "mesh", "jax"))
    assert mesh == pytest.approx(single, abs=1e-6)
    assert abs(mesh - want) <= 1e-4
