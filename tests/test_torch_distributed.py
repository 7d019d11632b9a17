"""parallel/distributed.py across two gloo processes (torch.multiprocessing).

Counterpart of tests/test_distributed_smoke.py (the JAX package's
two-process run): `initialize` over tcp://127.0.0.1 with explicit
arguments (and idempotent), `is_global_zero`, `global_mesh` over given
devices, `sync_conf_mat` summing exactly across processes, and
`PredsmIoU.compute(sync_distributed=True)` equal to one process scoring
the union of both processes' data, with each local matrix left as it was.
In one process: no coordinator and no launcher environment skips quietly;
an explicit coordinator without its world size raises.

The leaf-sharded tree on a bank axis over the two processes
(`process_mesh`, 2 CPU shards each, 4 in all), in both layouts: each
process holds its own shards; the build, the search (values, ids,
labels) and the gathered features equal one process building the same
tree on 4 shards of its own, bit for bit, and so does the flat search on
the same mesh (tests/test_torch_distributed_flat.py holds the flat search
and the engine there in every form). The multi-process .treedir writer: each process writes its shards,
process 0 the manifests and meta; the slab and label files and tree_meta.json
are byte for byte those of the one-process writer (meta.npz, a zip whose
entries carry their write time, holds equal arrays), and
`hbird_tpu.bank.io.load_tree_state` reads the directory back.
"""

import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from hbird_tpu.bank.io import load_tree_state as j_load_tree_state
from hbird_tpu_torch.nn import NearestNeighborSearchApprox, NearestNeighborSearchExact
from hbird_tpu_torch.parallel import distributed as D
from hbird_tpu_torch.parallel import make_mesh
from hbird_tpu_torch.utils.eval_metrics import PredsmIoU

N_PROC = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _shard_of_data(rank):
    rng = np.random.default_rng(100 + rank)
    gt = rng.integers(0, 4, 500)
    pred = np.where(rng.random(500) < 0.7, (gt + 1) % 4, rng.integers(0, 4, 500))
    return gt, pred


def _worker(rank, port, out_dir):
    D.initialize(f"tcp://127.0.0.1:{port}", num_processes=N_PROC, process_id=rank, backend="gloo")
    D.initialize(f"tcp://127.0.0.1:{port}", num_processes=N_PROC, process_id=rank)  # idempotent
    assert D.process_count() == N_PROC and D.process_index() == rank
    assert D.is_global_zero() == (rank == 0)
    assert D.global_mesh(devices=["cpu", "cpu"]).shape == {"bank": 2}
    total = D.sync_conf_mat(np.full((3, 3), rank + 1, np.int64))
    assert total.dtype == np.int64 and (total == 3).all(), total
    m = PredsmIoU(4, 4)
    m.update(*_shard_of_data(rank))
    local = m._conf_mat.copy()
    synced = m.compute(is_global_zero=True, sync_distributed=True, return_reordered=False)
    np.testing.assert_array_equal(m._conf_mat, local)  # the local matrix is kept
    np.save(os.path.join(out_dir, f"rank{rank}.npy"), np.array([synced[0], *synced[1]], np.float64))
    D.shutdown()


def test_two_gloo_processes_sum_the_confusion_matrix(tmp_path):
    mp.spawn(_worker, args=(_free_port(), str(tmp_path)), nprocs=N_PROC, join=True)
    union = PredsmIoU(4, 4)
    for rank in range(N_PROC):
        union.update(*_shard_of_data(rank))
    miou, tp, *_ = union.compute(is_global_zero=True, return_reordered=False)
    for rank in range(N_PROC):
        got = np.load(tmp_path / f"rank{rank}.npy")
        assert got[0] == miou and got[1:].tolist() == list(tp)


def test_single_process_behaviour(monkeypatch):
    for name in ("WORLD_SIZE", "MASTER_ADDR", "RANK"):
        monkeypatch.delenv(name, raising=False)
    D.initialize()  # nothing to join: skips
    assert D.process_count() == 1 and D.is_global_zero()
    conf = np.arange(9).reshape(3, 3)
    assert D.sync_conf_mat(conf) is conf
    with pytest.raises(ValueError, match="num_processes"):
        D.initialize("127.0.0.1:1")


# ----------------------------------------------------------------------
# The leaf-sharded tree over the two processes
# ----------------------------------------------------------------------
TREE_KW = dict(n_neighbors=8, use_tree=True, num_leaves=8, num_leaves_to_search=3, query_block=64, device="cpu")
LAYOUTS = {"host": {}, "device": {"quantization": "int8_rows"}}


def _tree_data():
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(6, 16)).astype(np.float32) * 3
    x = centers[rng.integers(0, 6, 1998)] + rng.normal(size=(1998, 16)).astype(np.float32) * 0.3
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    labels = rng.random((1998, 4)).astype(np.float32)
    q = torch.from_numpy((x[rng.integers(0, 1998, 150)] + 0.02 * rng.normal(size=(150, 16))).astype(np.float32))
    return x, labels, q


def _tree_answers(nn, q):
    v, i, lab = nn.search_with_labels(q)
    return {"vals": v.numpy(), "ids": i.numpy(), "labels": lab.numpy(),
            "feats": nn.gather_features_pure(nn.device_state, i).float().numpy()}


def _tree_worker(rank, port, out_dir):
    D.initialize(f"tcp://127.0.0.1:{port}", num_processes=N_PROC, process_id=rank, backend="gloo")
    mesh = D.process_mesh(["cpu", "cpu"])
    assert mesh.shape == {"bank": 4} and mesh.spans_processes and mesh.ranks.tolist() == [0, 0, 1, 1]
    x, labels, q = _tree_data()
    flat = NearestNeighborSearchExact(x, n_neighbors=8, label_memory=labels, device="cpu", mesh=mesh)
    assert [b is None for b in flat.bank] == [rank == 1, rank == 1, rank == 0, rank == 0]
    np.savez(os.path.join(out_dir, f"flat_rank{rank}.npz"), **_tree_answers(flat, q))
    for layout, kw in LAYOUTS.items():
        nn = NearestNeighborSearchApprox(x, label_memory=labels, mesh=mesh, tree_build_layout=layout, **TREE_KW, **kw)
        assert [b is None for b in nn.bank] == [rank == 1, rank == 1, rank == 0, rank == 0]
        out = _tree_answers(nn, q)
        for j in (2 * rank, 2 * rank + 1):
            out[f"slab{j}"] = nn.bank[j].float().numpy()
        np.savez(os.path.join(out_dir, f"{layout}_rank{rank}.npz"), **out)
        nn.save_tree(os.path.join(out_dir, f"{layout}.treedir"), chunk_rows=150)
    D.shutdown()


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def test_tree_over_two_processes(tmp_path):
    mp.spawn(_tree_worker, args=(_free_port(), str(tmp_path)), nprocs=N_PROC, join=True)
    x, labels, q = _tree_data()
    mesh = make_mesh((4,), ("bank",), ["cpu"] * 4)
    flat = _tree_answers(NearestNeighborSearchExact(x, n_neighbors=8, label_memory=labels, device="cpu", mesh=mesh), q)
    for rank in range(N_PROC):
        got = np.load(tmp_path / f"flat_rank{rank}.npz")
        for name, v in flat.items():
            np.testing.assert_array_equal(got[name], v, err_msg=f"flat rank {rank} {name}")
    for layout, kw in LAYOUTS.items():
        one = NearestNeighborSearchApprox(x, label_memory=labels, mesh=mesh, tree_build_layout=layout, **TREE_KW,
                                          **kw)
        want = _tree_answers(one, q)
        for rank in range(N_PROC):
            got = np.load(tmp_path / f"{layout}_rank{rank}.npz")
            for name, v in want.items():
                np.testing.assert_array_equal(got[name], v, err_msg=f"{layout} rank {rank} {name}")
            for j in (2 * rank, 2 * rank + 1):
                np.testing.assert_array_equal(got[f"slab{j}"], one.bank[j].float().numpy())
        mp_dir, one_dir = str(tmp_path / f"{layout}.treedir"), one.save_tree(str(tmp_path / f"{layout}_one.treedir"),
                                                                              chunk_rows=150)
        assert _files(mp_dir) == _files(one_dir)
        for name in _files(one_dir):
            if name == "meta.npz":
                with np.load(os.path.join(mp_dir, name)) as a, np.load(os.path.join(one_dir, name)) as b:
                    assert a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)
            else:
                with open(os.path.join(mp_dir, name), "rb") as a, open(os.path.join(one_dir, name), "rb") as b:
                    assert a.read() == b.read(), name
        st = j_load_tree_state(mp_dir)
        np.testing.assert_array_equal(np.asarray(st["ivf_labels"]), torch.cat(one.labels).numpy())
        if layout == "device":
            np.testing.assert_array_equal(np.asarray(st["bank_row_scale"]).reshape(-1),
                                          torch.cat(one.bank_row_scale).reshape(-1).numpy())
            np.testing.assert_array_equal(np.asarray(st["ivf_bank"]), torch.cat(one.bank).numpy())
