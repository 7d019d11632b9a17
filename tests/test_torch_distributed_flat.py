"""The flat search and the engine over two gloo processes (torch.multiprocessing).

Counterpart of tests/test_distributed_smoke.py's multi-process runs (the
JAX package's ring over 4 processes, RING4_WORKER, and its two-process
engine, test_two_process_engine_e2e). Every worker joins a gloo group over
tcp://127.0.0.1; a bank axis over the group is `process_mesh(['cpu'] * 2)`
in each of the two processes (4 shards, rank r holding shards 2r and 2r+1).

- The flat search on that mesh: `sharded_knn_with_labels` ('gather') and
  `ring_knn_with_labels` ('ring') on explicit shards, and the backends
  (`NearestNeighborSearchExact` gather and ring, the flat
  `NearestNeighborSearchApprox`) given the whole bank or only this
  process's shards, in bf16, f32, int8_rows and int8 + reorder (and, from
  shards, int8_asym with column scales). 1003 rows padded to 4 shards of
  256 with 700 real: the third shard is partial, the last has no real row
  (and, on explicit shards, with 400 real: both of the second process's
  shards have none, and it still joins every collective).
  Values, ids, labels, the gathered feature rows and each process's codes
  equal one process searching the same 4 shards of its own, bit for bit.
  A `.bankdir` loads onto the mesh as this process's shards only.
- In the parent, that one-process answer against the JAX package's
  sharded search (gather and ring) on tie-free inputs, as
  tests/test_torch_parallel.py holds it: ids equal, values within
  1e-5·||q|| (int8_rows equal), labels within 1e-6.
- The engine (`hbird_evaluation`, colour oracle features, the VOC fixture
  of 12 train and 6 val images), two ways:
  - data parallel, no mesh: each process scores its half of the val split
    (`val_fs_path`); both report the one-process mIoU over the whole split
    (abs 1e-9), and their summed confusion matrix is the one-process matrix;
  - on the process mesh, every process scoring the whole split ('scann',
    'faiss' by ring, 'ivf' with every leaf probed): the mIoU and the
    confusion matrix of one process on a process-local 4-shard mesh, the
    matrix not summed over the processes; 'scann' within 1e-4 of the JAX
    engine's one-process mIoU.
"""

import os
import random
import socket
from unittest import mock

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax.numpy as jnp

import hbird_tpu
from hbird_tpu.ops.quantize import quantize_bank_int8 as j_quantize_bank, quantize_queries_int8 as j_quantize_q
from hbird_tpu.parallel.mesh import make_mesh as j_make_mesh
from hbird_tpu.parallel.sharded_knn import (
    ring_knn_with_labels as j_ring,
    shard_bank as j_shard_bank,
    sharded_knn_with_labels as j_gather,
)
from hbird_tpu_torch import hbird_evaluation
from hbird_tpu_torch.bank.io import load_memory_sharded, save_memory_sharded
from hbird_tpu_torch.data.synthetic import make_voc_fixture
from hbird_tpu_torch.hbird_eval import HbirdEvaluation
from hbird_tpu_torch.nn import NearestNeighborSearchApprox, NearestNeighborSearchExact
from hbird_tpu_torch.ops.quantize import quantize_bank_int8, quantize_queries_int8
from hbird_tpu_torch.parallel import distributed as D
from hbird_tpu_torch.parallel import make_mesh, pad_rows_for_mesh, ring_knn_with_labels, sharded_knn_with_labels
from hbird_tpu_torch.parallel.sharded_knn import shard_rows

N_PROC, LOCAL = 2, 2
M, DIM, N_Q, VALID, K, REORDER = 1003, 32, 64, 700, 10, 40
LOW_VALIDS = (VALID, 400)  # 400: the second process holds no real row
RTOL = 1e-5
STRATEGIES = {"gather": sharded_knn_with_labels, "ring": ring_knn_with_labels}
LOW_FORMS = ("bf16", "f32", "int8_rows", "int8_reorder")
FORMS = {
    "bf16": {"use_fp16": True},
    "f32": {"use_fp16": False},
    "int8_rows": {"quantization": "int8_rows"},
    "int8_reorder": {"use_int8": True, "num_reordering_candidates": REORDER},
    "asym_ah": {"quantization": "int8_asym", "dimensions_per_block": 4},
}
ROUTES = {  # backend, shard_strategy
    "exact_gather": (NearestNeighborSearchExact, "gather"),
    "exact_ring": (NearestNeighborSearchExact, "ring"),
    "scann": (NearestNeighborSearchApprox, None),
}
# (route, input, form): a whole bank in every process, or its shards
BACKEND_CASES = [(route, given, form) for route in ROUTES for given in ("whole", "shards") for form in FORMS
                 if given == "shards" or form != "asym_ah"]
JAX_FORMS = {"f32": ("xla", 0), "int8_rows": ("pallas", 0), "int8_reorder": ("xla", REORDER)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _data():
    """tests/test_torch_parallel.py's tie-free data."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(M, DIM)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.normal(size=(N_Q, DIM)).astype(np.float32)
    return x, rng.random((M, 5)).astype(np.float32), q


def _cpu_mesh():
    return make_mesh((N_PROC * LOCAL,), ("bank",), ["cpu"] * (N_PROC * LOCAL))


# ----------------------------------------------------------------------
# The flat search
# ----------------------------------------------------------------------
def _low_level(mesh, strategy, form, valid=VALID):
    """The sharded search on explicit shards over `mesh`: (values, ids, labels)."""
    x, labels, q = _data()
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    kw = {}
    if form == "f32":
        tq, tb = qt, xt
    elif form == "bf16":
        tq, tb = qt.to(torch.bfloat16), xt.to(torch.bfloat16)
    else:
        per_row = form == "int8_rows"
        tb, scale = quantize_bank_int8(xt, per_row=per_row)
        tq, _ = quantize_queries_int8(qt)
        if per_row:
            kw["row_scale"] = shard_rows(scale, mesh)
        else:
            kw.update(rerank_bank=shard_rows(xt.to(torch.bfloat16), mesh), rerank_queries=qt.to(torch.bfloat16),
                      rerank_candidates=REORDER)
    v, i, lab = STRATEGIES[strategy](tq, shard_rows(tb, mesh), shard_rows(torch.from_numpy(labels), mesh), K,
                                     mesh=mesh, valid_rows=valid, **kw)
    return {"vals": v.numpy(), "ids": i.numpy(), "labels": lab.numpy()}


def _backend(mesh, route, given, form):
    """A backend on `mesh`: its answers, gathered features and its shards' codes."""
    x, labels, q = _data()
    cls, strategy = ROUTES[route]
    kw = dict(FORMS[form])
    if strategy is not None:
        kw["shard_strategy"] = strategy
    if given == "whole":
        bank, lab = x, labels
    else:
        bank, lab = shard_rows(torch.from_numpy(x), mesh), shard_rows(torch.from_numpy(labels), mesh)
    nn = cls(bank, n_neighbors=K, label_memory=lab, valid_rows=VALID, mesh=mesh, device="cpu", **kw)
    v, i, out_lab = nn.search_with_labels(torch.from_numpy(q))
    out = {"vals": v.numpy(), "ids": i.numpy(), "labels": out_lab.numpy(),
           "feats": nn.gather_features_pure(nn.device_state, i).float().numpy()}
    for j, part in enumerate(nn.bank):
        if part is not None:
            out[f"codes{j}"] = part.float().numpy()
    return out


def _flat_worker(rank, port, out_dir):
    D.initialize(f"tcp://127.0.0.1:{port}", num_processes=N_PROC, process_id=rank, backend="gloo")
    mesh = D.process_mesh(["cpu"] * LOCAL)
    shards, rows = load_memory_sharded(os.path.join(out_dir, "bank.bankdir"), mesh=mesh)
    mine = shard_rows(torch.from_numpy(_data()[0]), mesh)
    assert rows == M and [s is None for s in shards] == [m is None for m in mine] == [rank == 1] * 2 + [rank == 0] * 2
    assert all(torch.equal(a, b) for a, b in zip(shards, mine) if a is not None)
    for strategy in STRATEGIES:
        for form in LOW_FORMS:
            for valid in LOW_VALIDS:
                np.savez(os.path.join(out_dir, f"low_{strategy}_{form}_{valid}_rank{rank}.npz"),
                         **_low_level(mesh, strategy, form, valid))
    for route, given, form in BACKEND_CASES:
        out = _backend(mesh, route, given, form)
        assert sorted(k for k in out if k.startswith("codes")) == [f"codes{2 * rank}", f"codes{2 * rank + 1}"]
        np.savez(os.path.join(out_dir, f"{route}_{given}_{form}_rank{rank}.npz"), **out)
    D.shutdown()


@pytest.fixture(scope="module")
def flat_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("flat_group")
    save_memory_sharded(torch.from_numpy(_data()[0]), str(out / "bank.bankdir"), chunk_rows=300)
    mp.spawn(_flat_worker, args=(_free_port(), str(out)), nprocs=N_PROC, join=True)
    return out


def _assert_same(got, want, name):
    for key, v in want.items():
        if key in got.files:
            np.testing.assert_array_equal(got[key], v, err_msg=f"{name}: {key}")


@pytest.mark.parametrize("valid", LOW_VALIDS)
@pytest.mark.parametrize("form", LOW_FORMS)
@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_sharded_search_over_two_processes(flat_runs, strategy, form, valid):
    want = _low_level(_cpu_mesh(), strategy, form, valid)
    assert np.isneginf(want["vals"]).sum() == 0 and (want["ids"] < valid).all()
    for rank in range(N_PROC):
        got = np.load(flat_runs / f"low_{strategy}_{form}_{valid}_rank{rank}.npz")
        _assert_same(got, want, f"{strategy} {form} {valid}")


@pytest.mark.parametrize("route,given,form", BACKEND_CASES)
def test_backend_over_two_processes(flat_runs, route, given, form):
    want = _backend(_cpu_mesh(), route, given, form)
    assert (want["ids"] < VALID).all()  # the last shard's rows are masked out
    for rank in range(N_PROC):
        got = np.load(flat_runs / f"{route}_{given}_{form}_rank{rank}.npz")
        assert {f"codes{2 * rank}", f"codes{2 * rank + 1}"} <= set(got.files)
        _assert_same(got, want, f"{route} {given} {form} rank {rank}")


@pytest.mark.parametrize("form", list(JAX_FORMS))
@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_one_process_answer_matches_jax(strategy, form):
    """The answer the processes are held to, against the JAX package's
    sharded search on its virtual devices (tie-free inputs)."""
    kernel, reorder = JAX_FORMS[form]
    x, labels, q = _data()
    n = N_PROC * LOCAL
    jmesh = j_make_mesh((n,), ("bank",))
    j_extra = {}
    if form == "f32":
        jq, jb = jnp.asarray(q), x
    else:
        per_row = form == "int8_rows"
        codes, scale = j_quantize_bank(jnp.asarray(x), per_row=per_row)
        jq, _ = j_quantize_q(jnp.asarray(q))
        jb = np.asarray(codes)
        if per_row:
            pad = np.zeros((pad_rows_for_mesh(M, n) - M, 1), np.float32)
            j_extra["row_scale"] = jnp.asarray(np.concatenate([np.asarray(scale), pad]))
    if reorder:
        rb = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
        j_rb, _, _ = j_shard_bank(rb, labels, jmesh)
        j_extra.update(rerank_bank=j_rb.astype(jnp.bfloat16), rerank_queries=jnp.asarray(q, jnp.bfloat16),
                       rerank_candidates=reorder)
    j_bank, j_lab, _ = j_shard_bank(jb, labels, jmesh)
    jfn = j_gather if strategy == "gather" else j_ring
    jv, ji, jl = jfn(jq, j_bank, j_lab, K, mesh=jmesh, valid_rows=VALID, kernel=kernel, **j_extra)
    want = _low_level(_cpu_mesh(), strategy, form)
    tol = 0.0 if form == "int8_rows" else RTOL * float(np.linalg.norm(q, axis=1).max())
    np.testing.assert_array_equal(want["ids"], np.asarray(ji))
    np.testing.assert_allclose(want["vals"], np.asarray(jv), rtol=0, atol=tol)
    np.testing.assert_allclose(want["labels"], np.asarray(jl), rtol=0, atol=1e-6)


# ----------------------------------------------------------------------
# The engine
# ----------------------------------------------------------------------
INPUT, PATCH, N_VAL = 32, 4, 6
S = INPUT // PATCH
ENGINE_CASES = {  # nn_method, nn_params
    "scann": ("scann", None),
    "faiss_ring": ("faiss", {"shard_strategy": "ring"}),
    "ivf_every_leaf": ("ivf", {"num_leaves": 8, "num_leaves_to_search": 8}),
}


def oracle_t(model, imgs):
    b, c, h, w = imgs.shape
    x = imgs.reshape(b, c, S, PATCH, S, PATCH).mean(dim=(3, 5))
    return x.permute(0, 2, 3, 1).reshape(b, S * S, c), None


def oracle_j(model, imgs):
    b, c, h, w = imgs.shape
    x = imgs.reshape(b, c, S, PATCH, S, PATCH).mean(axis=(3, 5))
    return x.transpose(0, 2, 3, 1).reshape(b, S * S, c), None


def _val_split(root, part=None):
    """The file set of the val split (written by `_write_val_splits`): the
    whole of it, or process `part`'s half."""
    return os.path.join(root, f"val_{'all' if part is None else part}.txt")


def _write_val_splits(root):
    """Every split's file, written once before the processes start (two
    processes writing one file would race its readers)."""
    ids = [f"val_{i:04d}" for i in range(N_VAL)]
    for part in (None, *range(N_PROC)):
        with open(_val_split(root, part), "w") as f:
            f.write("\n".join(ids if part is None else ids[part::N_PROC]))


def _engine(root, val_fs, mesh=None, nn_method="scann", nn_params=None):
    """`hbird_evaluation` as a user calls it, seeded alike in every process:
    (mIoU, the confusion matrix it scored)."""
    random.seed(1234)
    np.random.seed(1234)
    seen = {}
    evaluate = HbirdEvaluation.evaluate

    def keep_matrix(self, *args, **kwargs):
        out = evaluate(self, *args, **kwargs)
        seen["conf"] = self.conf_mat
        return out

    with mock.patch.object(HbirdEvaluation, "evaluate", keep_matrix):
        miou = hbird_evaluation(
            None, d_model=3, patch_size=PATCH, dataset_name="voc", data_dir=root, batch_size=2, input_size=INPUT,
            n_neighbours=5, num_workers=0, device="cpu", ftr_extr_fn=oracle_t, val_fs_path=val_fs, mesh=mesh,
            nn_method=nn_method, nn_params=nn_params, seed=123,
        )
    return miou, seen["conf"]


def _engine_worker(rank, port, root, out_dir):
    D.initialize(f"tcp://127.0.0.1:{port}", num_processes=N_PROC, process_id=rank, backend="gloo")
    miou, conf = _engine(root, _val_split(out_dir, rank))
    np.savez(os.path.join(out_dir, f"data_parallel_rank{rank}.npz"), miou=miou, conf=conf)
    mesh = D.process_mesh(["cpu"] * LOCAL)
    for name, (method, params) in ENGINE_CASES.items():
        miou, conf = _engine(root, _val_split(out_dir), mesh, method, params)
        np.savez(os.path.join(out_dir, f"{name}_rank{rank}.npz"), miou=miou, conf=conf)
    D.shutdown()


@pytest.fixture(scope="module")
def engine_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc_group") / "voc")
    make_voc_fixture(root, n_train=12, n_val=N_VAL, size=(64, 48), colorize=True, seed=3, class_pool=[1, 2, 3, 4, 5])
    out = tmp_path_factory.mktemp("engine_group")
    _write_val_splits(str(out))
    mp.spawn(_engine_worker, args=(_free_port(), root, str(out)), nprocs=N_PROC, join=True)
    return root, out


def test_two_data_parallel_processes_give_the_one_process_result(engine_runs):
    root, out = engine_runs
    miou, conf = _engine(root, _val_split(str(out)))
    halves = [np.load(out / f"data_parallel_rank{rank}.npz") for rank in range(N_PROC)]
    for got in halves:
        assert float(got["miou"]) == pytest.approx(miou, abs=1e-9)
        np.testing.assert_array_equal(got["conf"], conf)  # each rank scored the summed matrix


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_on_a_process_mesh(engine_runs, case):
    root, out = engine_runs
    method, params = ENGINE_CASES[case]
    miou, conf = _engine(root, _val_split(str(out)), _cpu_mesh(), method, params)
    for rank in range(N_PROC):
        got = np.load(out / f"{case}_rank{rank}.npz")
        assert float(got["miou"]) == pytest.approx(miou, abs=1e-9)
        np.testing.assert_array_equal(got["conf"], conf)
    if case == "scann":
        random.seed(1234)
        want = hbird_tpu.hbird_evaluation(
            None, d_model=3, patch_size=PATCH, dataset_name="voc", data_dir=root, batch_size=2, input_size=INPUT,
            n_neighbours=5, num_workers=0, ftr_extr_fn=oracle_j, val_fs_path=_val_split(str(out)),
        )
        assert abs(float(got["miou"]) - want) <= 1e-4
