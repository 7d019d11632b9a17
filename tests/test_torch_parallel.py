"""The bank-sharded flat search (parallel/) against the port's unsharded
search and against the JAX package's sharded search.

- Meshes of 2, 4 and 8 shards over the CPU (a device may repeat in a port
  mesh; the JAX side runs on the 8 virtual CPU devices of conftest.py).
- Without reorder, 'gather' and 'ring' equal the port's unsharded search
  bit for bit (values, ids, labels), for f32, bf16, l2, int8 and int8_rows,
  with padding, a shard with fewer real rows than k and an all-padding
  shard. With duplicated rows the lowest global id wins, exactly.
- Against hbird_tpu.parallel.sharded_knn (gather and ring, with and
  without reorder, l2 and int8_rows) on tie-free inputs: ids equal, values
  within 1e-5·||q||·max||b|| (int8_rows: equal), labels within 1e-6. The
  JAX side runs its XLA path for float banks and its Pallas kernel in
  interpret mode for row scales, which only the kernel takes.
- The backends: `mesh=`, `idx_shard` with `devices`, `shard_strategy`; the
  features of the winners come back from their shards; the meshed tree
  still raises and names its slice.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hbird_tpu.ops.quantize import quantize_bank_int8 as j_quantize_bank, quantize_queries_int8 as j_quantize_q
from hbird_tpu.parallel.mesh import make_mesh as j_make_mesh
from hbird_tpu.parallel.sharded_knn import (
    ring_knn_with_labels as j_ring,
    shard_bank as j_shard_bank,
    sharded_knn_with_labels as j_gather,
)
from hbird_tpu_torch.nn import NearestNeighborSearchApprox, NearestNeighborSearchExact
from hbird_tpu_torch.ops.knn import knn_with_labels
from hbird_tpu_torch.ops.quantize import quantize_bank_int8, quantize_queries_int8
from hbird_tpu_torch.parallel import (
    default_mesh,
    make_mesh,
    pad_rows_for_mesh,
    ring_knn_with_labels,
    shard_bank,
    sharded_knn_with_labels,
)
from hbird_tpu_torch.parallel.mesh import canonical_device
from hbird_tpu_torch.parallel.sharded_knn import local_valid_rows, merge_topk, shard_rows

RTOL = 1e-5
STRATEGIES = {"gather": sharded_knn_with_labels, "ring": ring_knn_with_labels}


def cpu_mesh(n, axes=("bank",), shape=None):
    return make_mesh(shape or (n,), axes, ["cpu"] * n)


def _data(m, d, n_q, seed, c=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.normal(size=(n_q, d)).astype(np.float32)
    return x, rng.random((m, c)).astype(np.float32), q


def _form(name, x, q):
    """(queries, bank, row_scale, distance) of a K1 form, as tensors."""
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    if name in ("f32", "l2"):
        return qt, xt, None, "l2" if name == "l2" else "dot_product"
    if name == "bf16":
        return qt.to(torch.bfloat16), xt.to(torch.bfloat16), None, "dot_product"
    codes, scale = quantize_bank_int8(xt, per_row=name == "int8_rows")
    qc, _ = quantize_queries_int8(qt)
    return qc, codes, scale if name == "int8_rows" else None, "dot_product"


# (rows, valid rows, k): padded rows and a short last shard; a tiny bank
# whose 8-way split leaves a shard with 4 real rows (< k) and one with none.
CASES = {"padded": (1003, 990, 30), "tiny": (100, 100, 30), "k5": (301, 301, 5)}


@pytest.mark.parametrize("strategy", list(STRATEGIES))
@pytest.mark.parametrize("form", ["f32", "bf16", "l2", "int8", "int8_rows"])
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_equals_unsharded_bit_for_bit(case, n, form, strategy):
    m, valid, k = CASES[case]
    x, labels, q = _data(m, 32, 45, seed=m + n)
    qt, bank, rs, distance = _form(form, x, q)
    lab = torch.from_numpy(labels)
    v0, i0, l0 = knn_with_labels(qt, bank, lab, k, valid_rows=valid, distance=distance, row_scale=rs)
    mesh = cpu_mesh(n)
    bs, ls, _ = shard_bank(bank, lab, mesh)
    rss = shard_rows(rs, mesh) if rs is not None else None
    v, i, lv = STRATEGIES[strategy](qt, bs, ls, k, mesh=mesh, valid_rows=valid, distance=distance, row_scale=rss)
    assert torch.equal(v, v0) and torch.equal(i, i0) and torch.equal(lv, l0)
    if case == "tiny" and n == 8:
        rows = bs[0].shape[0]
        assert [local_valid_rows(valid, j, rows) for j in range(8)][-2:] == [4, 0]


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_duplicated_rows_lowest_global_id_wins(strategy):
    rng = np.random.default_rng(5)
    base = rng.normal(size=(40, 16)).astype(np.float32)
    x = np.tile(base, (10, 1))  # row r repeats at r + 40, r + 80, ... across shards
    q = torch.from_numpy(rng.normal(size=(30, 16)).astype(np.float32))
    lab = torch.arange(400, dtype=torch.float32)[:, None]
    mesh = cpu_mesh(4)
    bs, ls, valid = shard_bank(torch.from_numpy(x), lab, mesh)
    v, i, lv = STRATEGIES[strategy](q, bs, ls, 12, mesh=mesh, valid_rows=valid)
    best = torch.from_numpy(np.argmax(q.numpy() @ base.T, axis=1))
    # the ten copies of the best row are the top ten, in ascending id order
    expected = best[:, None] + 40 * torch.arange(10)
    assert torch.equal(i[:, :10], expected)
    assert torch.equal(lv[..., 0], i.float())
    v0, i0, _ = knn_with_labels(q, torch.from_numpy(x), lab, 12)
    assert torch.equal(v, v0) and torch.equal(i, i0)


def test_merge_rule_and_unfilled_slots():
    vals = torch.tensor([[1.0, 2.0, 2.0, float("-inf")]])
    idx = torch.tensor([[3, 9, 4, 7]])
    v, i = merge_topk(vals, idx, 4)
    assert v.tolist() == [[2.0, 2.0, 1.0, float("-inf")]] and i.tolist() == [[4, 9, 3, 0]]
    x, labels, q = _data(20, 8, 6, seed=1)
    mesh = cpu_mesh(4)
    bs, ls, _ = shard_bank(torch.from_numpy(x), torch.from_numpy(labels), mesh)
    v, i, _ = sharded_knn_with_labels(torch.from_numpy(q), bs, ls, 10, mesh=mesh, valid_rows=7)
    assert torch.isinf(v[:, 7:]).all() and (i[:, 7:] == 0).all() and (i[:, :7] < 7).all()


def test_padding_and_shards():
    assert pad_rows_for_mesh(1003, 8) == 1024 and pad_rows_for_mesh(100, 8) == 128
    assert pad_rows_for_mesh(87616, 4) == 87616
    x = torch.arange(30, dtype=torch.float32).reshape(10, 3)
    mesh = cpu_mesh(4)
    parts = shard_rows(x, mesh)
    assert [p.shape[0] for p in parts] == [8] * 4
    assert torch.equal(torch.cat(parts)[:10], x) and not torch.cat(parts)[10:].any()
    assert mesh.shape == {"bank": 4} and mesh.axis_devices("bank") == [torch.device("cpu")] * 4
    two_d = cpu_mesh(8, ("data", "bank"), (2, 4))
    assert dict(two_d.shape) == {"data": 2, "bank": 4} and len(two_d.axis_devices("data")) == 2
    with pytest.raises(ValueError, match="needs 9 devices"):
        make_mesh((9,), ("bank",), ["cpu"] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA devices"):
            make_mesh((2,), ("bank",))
        with pytest.raises(ValueError, match="at least one device"):
            default_mesh()
    assert canonical_device("cpu") == torch.device("cpu")


# ----------------------------------------------------------------------
# Against the JAX package's sharded search, on its 8 virtual devices
# ----------------------------------------------------------------------
JAX_CASES = {
    # name: (form, kernel on the JAX side, reorder candidates)
    "dot": ("f32", "xla", 0),
    "l2": ("l2", "xla", 0),
    "int8_reorder": ("int8", "xla", 40),
    "int8_rows": ("int8_rows", "pallas", 0),
}


@pytest.mark.parametrize("strategy", list(STRATEGIES))
@pytest.mark.parametrize("case", list(JAX_CASES))
def test_matches_jax_sharded_search(case, strategy):
    form, kernel, reorder = JAX_CASES[case]
    m, valid, k = 1003, 990, 10
    x, labels, q = _data(m, 32, 64, seed=11)
    n = 8
    jmesh = j_make_mesh((n,), ("bank",))
    mesh = cpu_mesh(n)
    xt, qt, lab = torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(labels)
    distance = "l2" if form == "l2" else "dot_product"
    j_extra, t_extra = {}, {}
    if form in ("f32", "l2"):
        jq, jb, tq, tb = jnp.asarray(q), x, qt, xt
    else:
        per_row = form == "int8_rows"
        codes, scale = j_quantize_bank(jnp.asarray(x), per_row=per_row)
        jq, _ = j_quantize_q(jnp.asarray(q))
        jb = np.asarray(codes)
        tb, tscale = quantize_bank_int8(xt, per_row=per_row)
        tq, _ = quantize_queries_int8(qt)
        np.testing.assert_array_equal(tb.numpy(), jb)  # the same codes
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        if per_row:
            rs = np.asarray(scale)
            j_extra["row_scale"] = jnp.asarray(np.concatenate([rs, np.zeros((pad_rows_for_mesh(m, n) - m, 1), np.float32)]))
            t_extra["row_scale"] = shard_rows(tscale, mesh)
    if reorder:
        rb = torch.from_numpy(x).to(torch.bfloat16)
        j_rb, _, _ = j_shard_bank(np.asarray(rb.float().numpy()), labels, jmesh)
        j_extra.update(rerank_bank=j_rb.astype(jnp.bfloat16), rerank_queries=jnp.asarray(q, jnp.bfloat16),
                       rerank_candidates=reorder)
        t_extra.update(rerank_bank=shard_rows(rb, mesh), rerank_queries=qt.to(torch.bfloat16),
                       rerank_candidates=reorder)
    j_bank, j_lab, _ = j_shard_bank(jb, labels, jmesh)
    jfn = j_gather if strategy == "gather" else j_ring
    jv, ji, jl = jfn(jq, j_bank, j_lab, k, mesh=jmesh, valid_rows=valid, distance=distance, kernel=kernel, **j_extra)
    bs, ls, _ = shard_bank(tb, lab, mesh)
    tv, ti, tl = STRATEGIES[strategy](tq, bs, ls, k, mesh=mesh, valid_rows=valid, distance=distance, **t_extra)
    # Row-scaled int8 scores are exact integers times one f32 scale in both
    # packages; float scores are f32 sums of the same products (||b|| = 1).
    tol = 0.0 if form == "int8_rows" else RTOL * float(np.linalg.norm(q, axis=1).max())
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=tol)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-6)


# ----------------------------------------------------------------------
# The backends
# ----------------------------------------------------------------------
BACKEND_KW = {
    "f32": {},
    "bf16": {"use_fp16": True},
    "int8_reorder": {"use_int8": True, "num_reordering_candidates": 40},
    "int8_rows": {"quantization": "int8_rows"},
    "asym_ah": {"quantization": "int8_asym", "dimensions_per_block": 4},
    "l2": {"distance_measure": "l2"},
}


@pytest.mark.parametrize("strategy", ["gather", "ring"])
@pytest.mark.parametrize("kw", list(BACKEND_KW))
def test_exact_backend_on_a_mesh_equals_unmeshed(kw, strategy):
    x, labels, q = _data(1003, 32, 50, seed=3)
    qt = torch.from_numpy(q)
    base = NearestNeighborSearchExact(x, n_neighbors=10, label_memory=labels, device="cpu", **BACKEND_KW[kw])
    mesh = cpu_mesh(4)
    nn = NearestNeighborSearchExact(x, n_neighbors=10, label_memory=labels, device="cpu", mesh=mesh,
                                    shard_strategy=strategy, **BACKEND_KW[kw])
    assert isinstance(nn.bank, list) and len(nn.bank) == 4 and nn.valid_rows == 1003
    for a, b in zip(base.search_with_labels(qt), nn.search_with_labels(qt)):
        assert torch.equal(a, b)
    _, idx, _ = nn.search_with_labels(qt)
    assert torch.equal(nn.gather_features_pure(nn.device_state, idx),
                       base.gather_features_pure(base.device_state, idx))
    i0, d0 = base.find_nearest_neighbors(q, 7)
    i1, d1 = nn.find_nearest_neighbors(q, 7)
    np.testing.assert_array_equal(i0, i1) and np.testing.assert_array_equal(d0, d1)


def test_idx_shard_devices_and_the_approx_flat_path():
    x, labels, q = _data(500, 16, 20, seed=4)
    qt = torch.from_numpy(q)
    base = NearestNeighborSearchExact(x, n_neighbors=5, label_memory=labels, device="cpu")
    nn = NearestNeighborSearchExact(x, n_neighbors=5, label_memory=labels, device="cpu", idx_shard=True,
                                    devices=["cpu"] * 3)
    assert nn.mesh.shape == {"bank": 3}
    unsharded = NearestNeighborSearchExact(x, n_neighbors=5, label_memory=labels, device="cpu", devices=["cpu"] * 3)
    assert unsharded.mesh is None  # devices without idx_shard: one device
    a0 = NearestNeighborSearchApprox(x, n_neighbors=5, label_memory=labels, device="cpu")
    a1 = NearestNeighborSearchApprox(x, n_neighbors=5, label_memory=labels, device="cpu", mesh=cpu_mesh(8))
    for ref, other in ((base, nn), (a0, a1)):
        for a, b in zip(ref.search_with_labels(qt), other.search_with_labels(qt)):
            assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="next slice"):
        NearestNeighborSearchApprox(x, n_neighbors=5, use_tree=True, num_leaves=4, device="cpu", mesh=cpu_mesh(2))
    with pytest.raises(ValueError, match="shard_strategy"):
        NearestNeighborSearchExact(x, device="cpu", mesh=cpu_mesh(2), shard_strategy="tree")


def test_backend_takes_a_bank_given_as_shards():
    x, labels, q = _data(300, 16, 20, seed=6)
    mesh = cpu_mesh(4)
    shards = shard_rows(torch.from_numpy(x), mesh)
    lshards = shard_rows(torch.from_numpy(labels), mesh)
    qt = torch.from_numpy(q)
    for kw in ({}, {"use_int8": True, "num_reordering_candidates": 20}):
        base = NearestNeighborSearchExact(x, n_neighbors=5, label_memory=labels, device="cpu", **kw)
        nn = NearestNeighborSearchExact(shards, n_neighbors=5, label_memory=lshards, device="cpu", mesh=mesh,
                                        valid_rows=300, **kw)
        for a, b in zip(base.search_with_labels(qt), nn.search_with_labels(qt)):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="needs a mesh"):
        NearestNeighborSearchExact(shards, device="cpu")
