"""K1 and the flat search backends: the port against the JAX package.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs `hbird_tpu.ops.knn.exact_knn` and the Pallas kernel
`pallas_knn` in interpret mode; the port runs its plain version
(`ops/knn.py::exact_knn`), which is what its K1 wrapper takes for CPU
tensors.

Tolerance: values within 1e-5 · ||q|| · max||b|| (f32 sums of the same
exact products in another order; bf16 inputs are widened first, so their
products are exact too). Index sets are compared on tie-free inputs; the
duplicate-row case checks the port's tie rule (lowest index) exactly and
the kernel's values as a multiset.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hbird_tpu.ops.knn import exact_knn as jax_exact_knn
from hbird_tpu.ops.knn_pallas import pallas_knn
from hbird_tpu.parallel.sharded_knn import sharded_knn_with_labels
from hbird_tpu_torch.ops import knn_cuda
from hbird_tpu_torch.ops.knn import exact_knn, knn_with_labels

RTOL = 1e-5


def _inputs(n_q, m, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n_q, d)).astype(np.float32)
    b = rng.normal(size=(m, d)).astype(np.float32)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    return q, b


def _tol(q, b):
    return RTOL * float(np.linalg.norm(q, axis=1).max() * np.linalg.norm(b, axis=1).max())


def _to_dtype(x, dtype):
    """numpy f32 -> (jax array, torch tensor) in `dtype`, identical values."""
    t = torch.from_numpy(x).to(dtype)
    j = jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    )
    return j, t


def _assert_same_topk(tv, ti, jv, ji, tol):
    tv, ti = tv.numpy(), ti.numpy()
    jv, ji = np.asarray(jv), np.asarray(ji)
    finite = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv), finite)
    np.testing.assert_allclose(tv[finite], jv[finite], rtol=0, atol=tol)
    # unfilled slots: -inf with index 0 on both sides
    assert (ti[~finite] == 0).all() and (ji[~finite] == 0).all()
    np.testing.assert_array_equal(np.sort(ti, axis=1), np.sort(ji, axis=1))


CASES = [
    # (n_q, m, d, valid_rows)
    (37, 301, 32, 290),  # ragged M, valid_rows < M
    (20, 20, 16, 7),  # valid_rows < k for k >= 8
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 5, 30, 128])
@pytest.mark.parametrize("case", CASES, ids=["ragged", "few_valid"])
def test_exact_knn_matches_jax(case, k, dtype):
    n_q, m, d, valid = case
    q, b = _inputs(n_q, m, d, seed=k)
    qj, qt = _to_dtype(q, dtype)
    bj, bt = _to_dtype(b, dtype)
    tv, ti = exact_knn(qt, bt, k, valid_rows=valid, bank_block=64)
    tol = _tol(q, b)
    jv, ji = jax_exact_knn(qj, bj, k, valid_rows=valid)
    _assert_same_topk(tv, ti, jv, ji, tol)
    pv, pi = pallas_knn(qj, bj, k, valid_rows=valid, interpret=True)
    _assert_same_topk(tv, ti, pv, pi, tol)
    # sorted by value descending
    tv = tv.numpy()
    assert (tv[:, :-1] >= tv[:, 1:]).all()


@pytest.mark.parametrize("bank_block", [8, 64, 8192])
def test_duplicate_rows_lowest_index_wins(bank_block):
    """4 copies of each row: every score is 4-way tied. The port keeps the
    lowest copies (the JAX plain path's rule); the Pallas kernel's tied
    entries may be other copies, so only its values are compared."""
    rng = np.random.default_rng(0)
    base = rng.normal(size=(8, 16)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    bank = np.tile(base, (4, 1))
    q = base[:3]
    tv, ti = exact_knn(torch.from_numpy(q), torch.from_numpy(bank), 6, bank_block=bank_block)
    jv, ji = jax_exact_knn(jnp.asarray(q), jnp.asarray(bank), 6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    assert (ti.numpy()[:, :4] % 8 == np.arange(3)[:, None]).all()
    np.testing.assert_array_equal(ti.numpy()[:, :4] // 8, np.tile(np.arange(4), (3, 1)))
    pv, _ = pallas_knn(jnp.asarray(q), jnp.asarray(bank), 6, interpret=True)
    np.testing.assert_allclose(tv.numpy(), np.sort(np.asarray(pv), axis=1)[:, ::-1], atol=1e-6)


def test_wrapper_routes_cpu_tensors_to_plain_version():
    q, b = _inputs(9, 100, 16, seed=3)
    qt, bt = torch.from_numpy(q), torch.from_numpy(b)
    before = knn_cuda.knn_topk.launches
    kv, ki = knn_cuda.knn_topk(qt, bt, 5, valid_rows=90)
    pv, pi = exact_knn(qt, bt, 5, valid_rows=90)
    assert knn_cuda.knn_topk.launches == before == 0
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


@pytest.mark.parametrize(
    "kwargs, error",
    [
        ({"distance": "l2"}, NotImplementedError),
        ({"row_scale": torch.ones(10)}, NotImplementedError),
        ({"int8": True}, NotImplementedError),
        ({"k": 129}, ValueError),
        ({"valid_rows": 11}, ValueError),
        ({"mixed": True}, ValueError),
    ],
    ids=["l2", "row_scale", "int8", "k_too_large", "valid_rows_too_large", "mixed_dtype"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(kwargs, error):
    kwargs = dict(kwargs)
    q = torch.zeros(4, 8)
    b = torch.zeros(10, 8)
    if kwargs.pop("int8", False):
        q, b = q.to(torch.int8), b.to(torch.int8)
    if kwargs.pop("mixed", False):
        b = b.to(torch.bfloat16)
    k = kwargs.pop("k", 3)
    with pytest.raises(error):
        knn_cuda.knn_topk(q, b, k, **kwargs)


def test_knn_with_labels_matches_sharded_single_device():
    q, b = _inputs(33, 200, 32, seed=7)
    labels = np.random.default_rng(1).random((200, 5)).astype(np.float32)
    qj, qt = _to_dtype(q, torch.bfloat16)
    bj, bt = _to_dtype(b, torch.bfloat16)
    jv, ji, jl = sharded_knn_with_labels(
        qj, bj, jnp.asarray(labels), 30, valid_rows=180, kernel="pallas"
    )
    tv, ti, tl = knn_with_labels(qt, bt, torch.from_numpy(labels), 30, valid_rows=180)
    _assert_same_topk(tv, ti, jv, ji, _tol(q, b))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("backend", ["exact", "approx"])
@pytest.mark.parametrize("use_fp16", [False, True], ids=["f32", "bf16"])
def test_flat_backends_match_jax(backend, use_fp16):
    from hbird_tpu.nn import search_approx as ja
    from hbird_tpu.nn import search_exact as je
    from hbird_tpu_torch.nn import search_approx as ta
    from hbird_tpu_torch.nn import search_exact as te

    q, b = _inputs(40, 260, 32, seed=11)
    labels = np.random.default_rng(2).random((260, 4)).astype(np.float32)
    jcls, tcls = (
        (je.NearestNeighborSearchExact, te.NearestNeighborSearchExact)
        if backend == "exact"
        else (ja.NearestNeighborSearchApprox, ta.NearestNeighborSearchApprox)
    )
    jnn = jcls(b, n_neighbors=30, label_memory=labels, use_fp16=use_fp16)
    tnn = tcls(b, n_neighbors=30, label_memory=labels, use_fp16=use_fp16, device="cpu")
    assert tnn.bank.dtype == (torch.bfloat16 if use_fp16 else torch.float32)
    jv, ji, jl = jnn.search_with_labels(jnp.asarray(q))
    tv, ti, tl = tnn.search_with_labels(torch.from_numpy(q))
    _assert_same_topk(tv, ti, jv, ji, _tol(q, b))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(
        tnn.find_nearest_neighbors(q, 5)[0], jnn.find_nearest_neighbors(q, 5)[0]
    )
    np.testing.assert_array_equal(
        tnn.gather_features_pure(tnn.device_state, ti).float().numpy(),
        np.asarray(jnn.gather_features_pure(jnn.device_state, ji)).astype(np.float32),
    )


@pytest.mark.parametrize(
    "backend, kwargs",
    [
        ("approx", {"use_tree": True, "use_int8": True}),
        ("approx", {"quantization": "int8_rows"}),
        ("approx", {"distance_measure": "l2"}),
        ("approx", {"mesh": object()}),
        ("exact", {"use_int8": True}),
        ("exact", {"idx_shard": True}),
        ("exact", {"distance_measure": "euclidean"}),
    ],
    ids=["tree", "int8", "l2", "mesh", "exact_int8", "exact_shard", "exact_l2"],
)
def test_backends_raise_for_later_slices(backend, kwargs):
    from hbird_tpu_torch.nn import NearestNeighborSearchApprox, NearestNeighborSearchExact

    cls = NearestNeighborSearchApprox if backend == "approx" else NearestNeighborSearchExact
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cls(np.zeros((4, 8), np.float32), n_neighbors=2, device="cpu", **kwargs)


def test_backend_without_device_needs_cuda():
    from hbird_tpu_torch.nn import NearestNeighborSearchExact

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        NearestNeighborSearchExact(np.zeros((4, 8), np.float32), n_neighbors=2)
