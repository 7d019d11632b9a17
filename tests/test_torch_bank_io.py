"""Bank persistence (bank/io.py): the port against the JAX package.

Every format is written by one package and read by the other: flat files
(.npy, .npz, .pt, extension-less), .bankdirs in f32 and bf16, and
.treedirs of bf16, int8_rows and int8_asym (with score_ah column scales)
trees. Arrays must come back identical, bf16 bit for bit. The JAX package
stores bf16 .bankdir chunks as raw 2-byte void data, the port as uint16
bits, both under the manifest dtype "bfloat16"; the port never imports
ml_dtypes. Also the mesh-free cases of tests/test_bank_sharded.py, on the
port.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hbird_tpu.bank import io as jio
from hbird_tpu.nn.search_approx import NearestNeighborSearchApprox as JApprox
from hbird_tpu_torch.bank import io as tio
from hbird_tpu_torch.nn import NearestNeighborSearchApprox


def _bits(x):
    """uint16 bit patterns of a bf16 array of either package."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


@pytest.fixture(scope="module")
def rows():
    return np.random.default_rng(0).normal(size=(1000, 16)).astype(np.float32)


# ----------------------------------------------------------------------
# Flat files
# ----------------------------------------------------------------------
@pytest.mark.parametrize("ext", [".npy", ".npz", ".pt", ".pth", ".bin", ""])
def test_flat_files_cross_read(tmp_path, rows, ext):
    written = tio.save_memory(torch.from_numpy(rows), str(tmp_path / f"port{ext}"))
    assert written.endswith(ext or ".npy")
    np.testing.assert_array_equal(jio.load_memory(written), rows)
    jwritten = jio.save_memory(rows, str(tmp_path / f"jax{ext}"))
    back = tio.load_memory(jwritten, device="cpu")
    assert back.dtype == torch.float32 and back.device.type == "cpu"
    np.testing.assert_array_equal(back.numpy(), rows)
    # the extension-less path is found under its '.npy' spelling
    assert tio.memory_path_on_disk(str(tmp_path / f"jax{ext}")) == jwritten


def test_flat_save_widens_bf16_and_takes_views(tmp_path, rows):
    x = torch.from_numpy(rows).to(torch.bfloat16)
    p = tio.save_memory(x, str(tmp_path / "m.npy"))
    np.testing.assert_array_equal(np.load(p), x.float().numpy())
    strided = torch.from_numpy(rows)[::2]
    p = tio.save_memory(strided, str(tmp_path / "s.npy"))
    np.testing.assert_array_equal(jio.load_memory(p), rows[::2])


# ----------------------------------------------------------------------
# .bankdir
# ----------------------------------------------------------------------
@pytest.mark.parametrize("chunk_rows", [300, 1000, 4096])
def test_bankdir_f32_cross_read(tmp_path, rows, chunk_rows):
    p = str(tmp_path / "port.bankdir")
    assert tio.save_memory(torch.from_numpy(rows), p) == p  # .bankdir dispatch
    tio.save_memory_sharded(torch.from_numpy(rows), p, chunk_rows=chunk_rows)
    assert jio.sharded_memory_info(p) == tio.sharded_memory_info(p)
    np.testing.assert_array_equal(jio.load_memory_sharded(p), rows)
    j = str(tmp_path / "jax.bankdir")
    jio.save_memory_sharded(rows, j, chunk_rows=chunk_rows)
    np.testing.assert_array_equal(tio.load_memory_sharded(j, device="cpu").numpy(), rows)
    # the same manifest, and the same chunk files byte for byte
    assert open(os.path.join(p, "manifest.json")).read() == open(os.path.join(j, "manifest.json")).read()
    for c in tio.sharded_memory_info(p)["chunks"]:
        with open(os.path.join(p, c["file"]), "rb") as a, open(os.path.join(j, c["file"]), "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("chunk_rows", [300, 1000])
def test_bankdir_bf16_bits_cross_read(tmp_path, rows, chunk_rows):
    xj = jnp.asarray(rows, jnp.bfloat16)
    xt = torch.from_numpy(rows).to(torch.bfloat16)
    np.testing.assert_array_equal(_bits(xj), _bits(xt))
    j = str(tmp_path / "jax.bankdir")
    jio.save_memory_sharded(xj, j, chunk_rows=chunk_rows)
    back = tio.load_memory_sharded(j, device="cpu")
    assert back.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(back), _bits(xt))
    p = str(tmp_path / "port.bankdir")
    tio.save_memory_sharded(xt, p, chunk_rows=chunk_rows)
    info = json.load(open(os.path.join(p, "manifest.json")))
    assert info["dtype"] == "bfloat16"
    assert np.load(os.path.join(p, "chunk_00000.npy")).dtype == np.uint16
    jback = jio.load_memory_sharded(p)
    assert jback.dtype.name == "bfloat16"
    np.testing.assert_array_equal(_bits(jback), _bits(xt))
    # load_memory widens to f32 in both packages
    np.testing.assert_array_equal(tio.load_memory(j, device="cpu").numpy(), jio.load_memory(p))


def test_bankdir_int8_cross_read(tmp_path):
    codes = np.random.default_rng(1).integers(-127, 128, (777, 24)).astype(np.int8)
    p = str(tmp_path / "c.bankdir")
    tio.save_memory_sharded(torch.from_numpy(codes), p, chunk_rows=200)
    np.testing.assert_array_equal(jio.load_memory_sharded(p), codes)
    assert tio.load_memory_sharded(p, device="cpu").dtype == torch.int8


@pytest.mark.parametrize("window_rows", [1, 137, 600, 1000, 5000])
def test_iter_bankdir_windows_agree_across_chunkings(tmp_path, rows, window_rows):
    labels = np.random.default_rng(2).random((1000, 5)).astype(np.float32)
    f = str(tmp_path / "f.bankdir")
    lab = str(tmp_path / "l.bankdir")
    tio.save_memory_sharded(torch.from_numpy(rows), f, chunk_rows=300)
    jio.save_memory_sharded(labels, lab, chunk_rows=420)  # chunked differently, by the JAX package
    got = list(tio.iter_bankdir_windows(f, lab, window_rows=window_rows))
    want = list(jio.iter_bankdir_windows(f, lab, window_rows=window_rows))
    assert len(got) == len(want) == -(-1000 // window_rows)
    for (tf, tl), (jf, jl) in zip(got, want):
        np.testing.assert_array_equal(tf.numpy(), jf)
        np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(torch.cat([w[0] for w in got]).numpy(), rows)
    assert all(w[1] is None for w in tio.iter_bankdir_windows(f, window_rows=window_rows))


def test_iter_bankdir_windows_rejects_unequal_banks(tmp_path, rows):
    f = str(tmp_path / "f.bankdir")
    lab = str(tmp_path / "l.bankdir")
    tio.save_memory_sharded(torch.from_numpy(rows), f)
    tio.save_memory_sharded(torch.zeros(999, 2), lab)
    with pytest.raises(ValueError, match="differ in rows"):
        next(tio.iter_bankdir_windows(f, lab))


# The mesh-free cases of tests/test_bank_sharded.py, on the port.
def test_streaming_generator_roundtrip(tmp_path):
    n, dim, blk_rows = 10_000, 16, 1_337
    rng = np.random.default_rng(0)
    blocks = [rng.normal(size=(min(blk_rows, n - s), dim)).astype(np.float32) for s in range(0, n, blk_rows)]
    d = str(tmp_path / "bank.bankdir")
    tio.save_memory_sharded((torch.from_numpy(b) for b in blocks), d, chunk_rows=2048)
    info = tio.sharded_memory_info(d)
    assert info["rows"] == n and info["dim"] == dim and len(info["chunks"]) == len(blocks)
    full = np.concatenate(blocks)
    pos = 0
    for start, chunk in tio.iter_memory_chunks(d):
        np.testing.assert_array_equal(chunk.numpy(), full[start : start + chunk.shape[0]])
        pos = start + chunk.shape[0]
    assert pos == n


def test_sliceable_source_and_chunking(tmp_path):
    mem = np.random.default_rng(1).normal(size=(5000, 8)).astype(np.float32)
    d = str(tmp_path / "b.bankdir")
    tio.save_memory_sharded(mem, d, chunk_rows=640)
    assert len(tio.sharded_memory_info(d)["chunks"]) == -(-5000 // 640)
    np.testing.assert_array_equal(tio.load_memory_sharded(d, device="cpu").numpy(), mem)
    mm = np.lib.format.open_memmap(str(tmp_path / "m.npy"), mode="w+", dtype=np.float32, shape=mem.shape)
    mm[:] = mem
    tio.save_memory_sharded(mm, str(tmp_path / "mm.bankdir"), chunk_rows=999)
    np.testing.assert_array_equal(tio.load_memory(str(tmp_path / "mm.bankdir"), device="cpu").numpy(), mem)


def test_save_memory_dispatch(tmp_path):
    mem = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    p = str(tmp_path / "x.bankdir")
    assert tio.save_memory(mem, p) == p and tio.is_sharded_path(p)
    assert tio.memory_path_on_disk(p) == p
    assert torch.equal(tio.load_memory(p, device="cpu"), mem)
    assert tio.memory_path_on_disk(str(tmp_path / "absent")) is None


@pytest.mark.parametrize("ext", [".npy", ".npz", ".pt", ".bankdir"])
def test_loaders_default_to_cuda(tmp_path, monkeypatch, ext):
    """device=None means CUDA, as for every entry point of the port: on a
    host without a card the loaders raise rather than hand back CPU rows."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = tio.save_memory(torch.zeros(4, 2), str(tmp_path / f"x{ext}"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tio.load_memory(p)
    if ext == ".bankdir":
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tio.load_memory_sharded(p)


def test_mesh_placement_raises(tmp_path):
    """A .treedir placed on a mesh and the multi-process .bankdir writer are
    the next slice and raise. (A .bankdir loads onto a mesh since the
    parallel/ slice: tests/test_torch_parallel_engine.py.)"""
    p = tio.save_memory(torch.zeros(4, 2), str(tmp_path / "x.bankdir"))
    with pytest.raises(NotImplementedError, match="parallel/"):
        tio.load_tree_state(p, mesh=object())
    with pytest.raises(NotImplementedError, match="parallel/"):
        tio._save_rows_distributed(torch.zeros(4, 2), str(tmp_path / "d.bankdir"))


# ----------------------------------------------------------------------
# .treedir
# ----------------------------------------------------------------------
def _clustered(m, d, n_clusters, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * 3
    x = centers[rng.integers(0, n_clusters, m)] + rng.normal(size=(m, d)).astype(np.float32) * 0.3
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


TREE_KINDS = {
    "bf16": {},
    "f32": {"use_fp16": False},
    "int8": {"use_int8": True},
    "int8_rows": {"quantization": "int8_rows"},
    "int8_asym_col_scale": {"quantization": "int8_asym", "dimensions_per_block": 4},
}


@pytest.fixture(scope="module")
def tree_data():
    x = _clustered(1500, 32, 6, seed=11)
    labels = np.random.default_rng(12).random((1500, 5)).astype(np.float32)
    return x, labels


def _jax_tree(x, labels, kind):
    return JApprox(x, n_neighbors=10, label_memory=jnp.asarray(labels), use_tree=True, num_leaves=6,
                   num_leaves_to_search=3, query_block=64, **TREE_KINDS[kind])


def _assert_tree_files_equal(a, b):
    """Two .treedirs hold the same arrays (bf16 slabs as equal bits)."""
    assert json.load(open(os.path.join(a, "tree_meta.json"))) == json.load(open(os.path.join(b, "tree_meta.json")))
    za, zb = np.load(os.path.join(a, "meta.npz")), np.load(os.path.join(b, "meta.npz"))
    assert sorted(za.files) == sorted(zb.files)
    for name in za.files:
        assert za[name].dtype == zb[name].dtype, name
        np.testing.assert_array_equal(za[name], zb[name], err_msg=name)
    for sub in ("slabs.bankdir", "labels.bankdir"):
        ia, ib = jio.sharded_memory_info(os.path.join(a, sub)), jio.sharded_memory_info(os.path.join(b, sub))
        assert (ia["rows"], ia["dim"], ia["dtype"]) == (ib["rows"], ib["dim"], ib["dtype"]), sub
        np.testing.assert_array_equal(jio.load_memory_sharded(os.path.join(a, sub)),
                                      jio.load_memory_sharded(os.path.join(b, sub)), err_msg=sub)


@pytest.mark.parametrize("kind", list(TREE_KINDS))
def test_treedir_written_by_jax_is_read_by_the_port(tmp_path, tree_data, kind):
    x, labels = tree_data
    jnn = _jax_tree(x, labels, kind)
    path = str(tmp_path / "jax.treedir")
    jnn.save_tree(path, chunk_rows=700)
    st = tio.load_tree_state(path, device="cpu")
    jst = jio.load_tree_state(path)
    for name in ("centroids", "leaf_valid", "perm", "slots"):
        np.testing.assert_array_equal(st[name].numpy(), np.asarray(jst[name]), err_msg=name)
    if kind == "bf16":
        assert st["ivf_bank"].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(st["ivf_bank"]), _bits(jnn.bank))
    else:
        np.testing.assert_array_equal(st["ivf_bank"].numpy(), np.asarray(jnn.bank))
    np.testing.assert_array_equal(st["ivf_labels"].numpy(), np.asarray(jst["ivf_labels"]))
    for name in ("bank_row_scale", "bank_col_scale"):
        assert (st[name] is None) == (jst[name] is None), name
        if st[name] is not None:
            np.testing.assert_array_equal(st[name].numpy(), np.asarray(jst[name]), err_msg=name)
    assert {k: st[k] for k in ("cap", "valid_rows", "bank_scale", "n_leaves", "asym")} == {
        k: jst[k] for k in ("cap", "valid_rows", "bank_scale", "n_leaves", "asym")}
    # the port writes back the very same tree
    tnn = NearestNeighborSearchApprox.load_tree(path, n_neighbors=10, device="cpu")
    again = str(tmp_path / "port.treedir")
    tnn.save_tree(again, chunk_rows=500)
    _assert_tree_files_equal(path, again)
    slab_info = tio.sharded_memory_info(os.path.join(again, "slabs.bankdir"))
    assert slab_info["dtype"] == {"bf16": "uint16", "f32": "float32"}.get(kind, "int8")


@pytest.mark.parametrize("kind", list(TREE_KINDS))
def test_treedir_written_by_the_port_is_read_by_jax(tmp_path, tree_data, kind):
    x, labels = tree_data
    tnn = NearestNeighborSearchApprox(x, n_neighbors=10, label_memory=labels, use_tree=True, num_leaves=6,
                                      num_leaves_to_search=3, query_block=64, device="cpu",
                                      **TREE_KINDS[kind])
    path = str(tmp_path / "port.treedir")
    tnn.save_tree(path, chunk_rows=333)
    jnn = JApprox.load_tree(path, n_neighbors=10, num_leaves_to_search=3, query_block=64)
    assert jnn.use_tree and jnn._cap == tnn._cap and jnn.valid_rows == tnn.valid_rows
    assert jnn.int8_asym == tnn.int8_asym and jnn.int8_rows == (tnn.bank_row_scale is not None)
    if kind == "bf16":
        np.testing.assert_array_equal(_bits(jnn.bank), _bits(tnn.bank))
    else:
        np.testing.assert_array_equal(np.asarray(jnn.bank), tnn.bank.numpy())
    np.testing.assert_array_equal(np.asarray(jnn.labels), tnn.labels.numpy())
    np.testing.assert_array_equal(np.asarray(jnn.perm), tnn.perm.numpy())
    np.testing.assert_array_equal(np.asarray(jnn.slots), tnn.slots.numpy())
    np.testing.assert_array_equal(np.asarray(jnn.leaf_valid), tnn.leaf_valid.numpy())
    np.testing.assert_array_equal(np.asarray(jnn.centroids), tnn.centroids.numpy())
    for name in ("_bank_row_scale", "_bank_col_scale"):
        t = getattr(tnn, name[1:])
        j = getattr(jnn, name)
        assert (t is None) == (j is None), name
        if t is not None:
            np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)
    if kind == "int8":
        assert float(np.asarray(jnn._bank_scale)) == float(tnn.bank_scale)


def test_port_imports_no_ml_dtypes():
    """bf16 goes to and from disk through uint16 bits: reading and writing
    a bf16 .bankdir and .treedir leaves ml_dtypes unimported."""
    code = """
import sys, tempfile, torch
from hbird_tpu_torch.bank import io
from hbird_tpu_torch.nn import NearestNeighborSearchApprox
d = tempfile.mkdtemp()
x = torch.nn.functional.normalize(torch.randn(600, 8, generator=torch.Generator().manual_seed(0)), dim=1)
io.save_memory_sharded(x.to(torch.bfloat16), d + '/b.bankdir', chunk_rows=100)
assert io.load_memory_sharded(d + '/b.bankdir', device='cpu').dtype == torch.bfloat16
nn = NearestNeighborSearchApprox(x, n_neighbors=4, use_tree=True, num_leaves=4, device='cpu')
nn.save_tree(d + '/t.treedir')
NearestNeighborSearchApprox.load_tree(d + '/t.treedir', device='cpu')
sys.exit(1 if 'ml_dtypes' in sys.modules else 0)
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    src = open(tio.__file__).read()
    assert "import ml_dtypes" not in src and "from ml_dtypes" not in src
