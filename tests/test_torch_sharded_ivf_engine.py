"""The leaf-sharded tree behind the backend, the persistence paths, the
engine and the command line (nn/search_approx.py over
parallel/sharded_ivf.py), on CPU meshes of repeated devices.

- The backend on 4 shards against `hbird_tpu`'s meshed backend
  (tests/test_ivf.py:354, :379), with the JAX backend's centroids handed
  over (its k-means init draws jax.random): 12 leaves, 6 probed, f32
  under 'split' and int8_rows under 'full'; ids equal on these tie-free
  queries, values within 1e-5·||q||·max||b|| (int8_rows equal), labels
  within 1e-6. The 'device' layout answers as the 'host' one with every
  leaf probed.
- `from_bankdir(mesh=)` on 8 shards, windows of 700 rows (larger than a
  shard's share): the unmeshed streamed build bit for bit, layout and
  every-leaf search (tests/test_ivf.py:639).
- `load_tree(mesh=)`: a saved tree loaded onto 4 shards answers as the
  unmeshed tree with every leaf probed; 6 leaves on 4 shards raise
  (tests/test_tree_persistence.py:113, :143); a meshed tree saved and
  loaded back onto its mesh answers bit for bit, in both layouts, and the
  JAX package reads its .treedir.
- The engine's 'ivf' on a ('bank',) mesh of 4, every leaf probed: mIoU
  within 1e-6 of its unmeshed run, in both layouts, unbounded and bounded,
  and unbounded within 1e-4 of the JAX engine's meshed run
  (tests/test_mesh_build.py:140; a bounded bank samples its rows with each
  package's own generator).
- `eval_cli --nn-method ivf --mesh-bank 4 --mesh-devices cpu,cpu,cpu,cpu`
  with shard_probe=full and tree_build_layout=device against
  `hbird_tpu.eval_cli.main` on 4 of its virtual devices: within 1e-4.
"""

import json
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hbird_tpu
from hbird_tpu.bank.io import load_tree_state as j_load_tree_state
from hbird_tpu.nn.search_approx import NearestNeighborSearchApprox as JApprox
from hbird_tpu.parallel import make_mesh as j_make_mesh
from hbird_tpu_torch import eval_cli
from hbird_tpu_torch.bank.io import save_memory_sharded
from hbird_tpu_torch.nn import NearestNeighborSearchApprox
from hbird_tpu_torch.ops import ivf
from test_torch_parallel_engine import _argv, _port, cpu_mesh, oracle_j, voc  # noqa: F401 (module fixture)
from test_torch_sharded_ivf import _clustered

RTOL = 1e-5


def _bank(m=3000, seed=7):
    x = _clustered(m, 32, 10, seed=seed)
    rng = np.random.default_rng(seed + 1)
    labels = rng.random((m, 5)).astype(np.float32)
    q = (x[rng.integers(0, m, 200)] + 0.02 * rng.normal(size=(200, 32))).astype(np.float32)
    return x, labels, q


BACKENDS = {"f32 split": ({"use_fp16": False}, "split"), "int8_rows full": ({"quantization": "int8_rows"}, "full")}


@pytest.mark.parametrize("case", list(BACKENDS))
def test_backend_on_a_mesh_matches_jax(case, monkeypatch):
    kw, shard_probe = BACKENDS[case]
    x, labels, q = _bank()
    common = dict(n_neighbors=10, use_tree=True, num_leaves=12, num_leaves_to_search=6, query_block=64,
                  shard_probe=shard_probe, **kw)
    jnn = JApprox(x, label_memory=jnp.asarray(labels), mesh=j_make_mesh((4,), ("bank",)), **common)
    c = torch.from_numpy(np.asarray(jnn.centroids))
    monkeypatch.setattr(ivf, "train_centroids", lambda sample, n_leaves, **_: c)
    tnn = NearestNeighborSearchApprox(x, label_memory=labels, mesh=cpu_mesh((4,), ("bank",)), tree_refine_rounds=0,
                                      device="cpu", **common)
    assert torch.equal(tnn.centroids, c) and tnn._n_leaves == jnn._n_leaves == 12 and len(tnn.bank) == 4
    jv, ji, jl = jnn.search_with_labels(jnp.asarray(q), 10)
    tv, ti, tl = tnn.search_with_labels(torch.from_numpy(q), 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    tol = 0.0 if "quantization" in kw else RTOL * float(np.linalg.norm(q, axis=1).max())
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=tol)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tl.numpy(), labels[ti.numpy()])
    # the features of the winners, dequantized, from their shards
    feats = tnn.gather_features_pure(tnn.device_state, ti)
    tv2 = torch.einsum("qd,qkd->qk", torch.from_numpy(q), feats)
    assert (tv2 - tv).abs().max().item() <= (2e-2 if "quantization" in kw else 1e-5)


def test_device_layout_backend_answers_as_the_host_layout():
    x, labels, q = _bank(2998, seed=3)
    common = dict(n_neighbors=10, label_memory=labels, use_tree=True, num_leaves=12, num_leaves_to_search=12,
                  query_block=64, mesh=cpu_mesh((4,), ("bank",)), device="cpu")
    host = NearestNeighborSearchApprox(x, **common)
    dev = NearestNeighborSearchApprox(x, tree_build_layout="device", **common)
    assert isinstance(dev.slots, list) and isinstance(dev.perm, list)
    assert set(dev.build_seconds) == {"kmeans", "refine", "assign", "layout", "scatter"}
    vh, ih, lh = host.search_with_labels(torch.from_numpy(q))
    vd, idd, ld = dev.search_with_labels(torch.from_numpy(q))
    assert torch.equal(vh, vd) and torch.equal(ih, idd) and torch.equal(lh, ld)
    assert torch.equal(host.gather_features_pure(host.device_state, ih),
                       dev.gather_features_pure(dev.device_state, idd))


def test_from_bankdir_on_a_mesh_is_the_unmeshed_streamed_build(tmp_path):
    x, labels, q = _bank(3000, seed=41)
    f_dir, l_dir = str(tmp_path / "f.bankdir"), str(tmp_path / "l.bankdir")
    save_memory_sharded(x, f_dir, chunk_rows=650)
    save_memory_sharded(labels, l_dir, chunk_rows=800)
    kwargs = dict(n_neighbors=10, window_rows=700, num_leaves=8, num_leaves_to_search=8, query_block=64,
                  use_fp16=False, device="cpu")
    meshed = NearestNeighborSearchApprox.from_bankdir(f_dir, l_dir, mesh=cpu_mesh((8,), ("bank",)), **kwargs)
    single = NearestNeighborSearchApprox.from_bankdir(f_dir, l_dir, **kwargs)
    assert len(meshed.bank) == 8 and {s.shape[0] for s in meshed.bank} == {single.bank.shape[0] // 8}
    assert (meshed._cap, meshed._n_leaves) == (single._cap, single._n_leaves)
    for name in ("slots", "perm", "centroids", "leaf_valid"):
        assert torch.equal(getattr(meshed, name), getattr(single, name)), name
    assert torch.equal(torch.cat(meshed.bank), single.bank) and torch.equal(torch.cat(meshed.labels), single.labels)
    for a, b in zip(meshed.search_with_labels(torch.from_numpy(q)), single.search_with_labels(torch.from_numpy(q))):
        assert torch.equal(a, b)


def test_load_tree_onto_a_mesh(tmp_path):
    x, labels, q = _bank(2000, seed=11)
    qt = torch.from_numpy(q)
    common = dict(n_neighbors=10, label_memory=labels, use_tree=True, num_leaves=8, query_block=64, device="cpu")
    nn = NearestNeighborSearchApprox(x, num_leaves_to_search=8, **common)
    path = nn.save_tree(str(tmp_path / "idx.treedir"))
    mesh = cpu_mesh((4,), ("bank",))
    meshed = NearestNeighborSearchApprox.load_tree(path, n_neighbors=10, mesh=mesh, num_leaves_to_search=8,
                                                   query_block=64, device="cpu")
    assert len(meshed.bank) == 4
    v1, i1, _ = nn.search_with_labels(qt)
    vm, im, lm = meshed.search_with_labels(qt)
    assert torch.equal(im, i1) and (vm - v1).abs().max().item() <= RTOL * qt.norm(dim=1).max().item()
    np.testing.assert_array_equal(lm.numpy(), labels[im.numpy()])
    six = NearestNeighborSearchApprox(x, num_leaves=6, **{k: v for k, v in common.items() if k != "num_leaves"})
    p6 = six.save_tree(str(tmp_path / "idx6.treedir"))
    with pytest.raises(ValueError, match="straddle"):
        NearestNeighborSearchApprox.load_tree(p6, mesh=mesh, device="cpu")
    # a meshed tree saved and loaded back onto its mesh, in both layouts
    for layout, kw in (("host", {}), ("device", {"quantization": "int8_rows"})):
        built = NearestNeighborSearchApprox(x, num_leaves_to_search=3, mesh=mesh, tree_build_layout=layout, **kw,
                                            **common)
        p = built.save_tree(str(tmp_path / f"{layout}.treedir"), chunk_rows=300)
        back = NearestNeighborSearchApprox.load_tree(p, n_neighbors=10, mesh=mesh, num_leaves_to_search=3,
                                                     query_block=64, device="cpu")
        for a, b in zip(built.search_with_labels(qt), back.search_with_labels(qt)):
            assert torch.equal(a, b), layout
        st = j_load_tree_state(p)  # the JAX package reads it
        np.testing.assert_array_equal(np.asarray(st["ivf_labels"]), torch.cat(built.labels).numpy())
        perm = torch.cat(built.perm) if layout == "device" else built.perm
        np.testing.assert_array_equal(st["perm"], perm.numpy())


IVF_PARAMS = {"num_leaves": 8, "num_leaves_to_search": 8, "shard_probe": "full"}


@pytest.mark.parametrize("memory_size", [None, 12 * 9], ids=["unbounded", "bounded"])
def test_engine_ivf_on_a_mesh(voc, memory_size):
    single = _port(voc, nn_method="ivf", nn_params=dict(IVF_PARAMS), memory_size=memory_size)
    want = None
    if memory_size is None:
        random.seed(1234)
        want = hbird_tpu.hbird_evaluation(
            None, d_model=3, patch_size=4, dataset_name="voc", data_dir=voc, batch_size=4, input_size=32,
            n_neighbours=5, num_workers=0, ftr_extr_fn=oracle_j, nn_method="ivf", nn_params=dict(IVF_PARAMS),
            mesh=j_make_mesh((4,), ("bank",)),
        )
    for layout in ("host", "device"):
        got = _port(voc, cpu_mesh((4,), ("bank",)), {**IVF_PARAMS, "tree_build_layout": layout}, nn_method="ivf",
                    memory_size=memory_size)
        assert got == pytest.approx(single, abs=1e-6), layout
        assert want is None or abs(got - want) <= 1e-4, layout


def test_cli_ivf_on_a_mesh(voc, tmp_path):
    from hbird_tpu.eval_cli import main as jax_main

    from test_torch_cli import _timm_state_dict

    ckpt = str(tmp_path / "tiny_dino_vits16.pth")
    torch.save(_timm_state_dict(384, 2, 16, 14 * 14, np.random.default_rng(0)), ckpt)
    ivf_flags = ["--nn-method", "ivf", "--nn-param", "num_leaves_to_search=512", "--nn-param", "shard_probe=full"]
    outs = {name: str(tmp_path / f"{name}.json") for name in ("single", "mesh", "device", "jax")}
    eval_cli.main(_argv(voc, ckpt, outs["single"], "--device", "cpu", *ivf_flags))
    mesh_flags = ["--device", "cpu", "--mesh-bank", "4", "--mesh-devices", "cpu,cpu,cpu,cpu", *ivf_flags]
    eval_cli.main(_argv(voc, ckpt, outs["mesh"], *mesh_flags))
    eval_cli.main(_argv(voc, ckpt, outs["device"], *mesh_flags, "--nn-param", "tree_build_layout=device"))
    jax_main(_argv(voc, ckpt, outs["jax"], "--platform", "cpu", "--compilation-cache", "", "--mesh-bank", "4",
                   *ivf_flags))
    single, mesh, dev, want = (json.load(open(outs[n]))["miou"] for n in ("single", "mesh", "device", "jax"))
    assert mesh == pytest.approx(single, abs=1e-6) and dev == pytest.approx(single, abs=1e-6)
    assert abs(mesh - want) <= 1e-4
