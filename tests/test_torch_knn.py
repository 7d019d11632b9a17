"""K1 and the flat search backends: the port against the JAX package.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs `hbird_tpu.ops.knn.exact_knn` and the Pallas kernel
`pallas_knn` in interpret mode; the port runs its plain version
(`ops/knn.py::exact_knn`), which is what its K1 wrapper takes for CPU
tensors. Every form of K1 is covered: (a) dot product, (b) l2, (c) int8 x
int8, (d) row_scale, (e) bf16 queries on int8 codes.

Tolerance: values within 1e-5 · ||q|| · max_i(||b_i|| · s_i) (f32 sums of
the same exact products in another order; bf16 and int8 inputs are widened
first, so their products are exact too; s_i is a row's scale, 1 for float
banks). int8 x int8 scores are exact integers below 2^24 and the row scale
one f32 multiply, so those values are equal bit for bit. Index sets are
compared on tie-free inputs; where scores tie (duplicate rows, integer
scores) the port's tie rule (value descending, then lowest index) is
checked exactly against a stable sort, and the kernel's results as value
multisets and as the sets strictly above the k-th value.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hbird_tpu.ops.knn import exact_knn as jax_exact_knn
from hbird_tpu.ops.knn_pallas import pallas_knn
from hbird_tpu.ops.quantize import quantize_bank_int8, quantize_queries_int8
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
        ({"distance": "l2", "int8": True}, ValueError),
        ({"row_scale": torch.ones(10)}, ValueError),
        ({"int8_queries": True}, ValueError),
        ({"k": 129}, ValueError),
        ({"valid_rows": 11}, ValueError),
        ({"mixed": True}, ValueError),
        ({"int8": True, "row_scale": torch.ones(9)}, ValueError),
        ({"int8": True, "distance": "l2", "row_scale": torch.ones(10)}, ValueError),
        ({"f32_on_int8": True}, ValueError),
        ({"int8": True, "depth": 1040}, ValueError),
        ({"distance": "cosine"}, ValueError),
    ],
    ids=["l2", "row_scale", "int8", "k_too_large", "valid_rows_too_large", "mixed_dtype",
         "row_scale_length", "l2_row_scale", "f32_on_int8", "int8_too_deep", "unknown_distance"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(kwargs, error):
    """The combinations `pallas_knn` asserts against raise ValueError: l2
    on an int8 bank or with row scales, row scales on a float bank or of
    the wrong length, a dtype pair outside f32/f32, bf16/bf16, int8/int8 and
    bf16/int8, int8 x int8 past D = 1024 (f32 would round the scores)."""
    kwargs = dict(kwargs)
    d = kwargs.pop("depth", 8)
    q = torch.zeros(4, d)
    b = torch.zeros(10, d)
    if kwargs.pop("int8", False):
        q, b = q.to(torch.int8), b.to(torch.int8)
    if kwargs.pop("int8_queries", False):
        q = q.to(torch.int8)
    if kwargs.pop("f32_on_int8", False):
        b = b.to(torch.int8)
    if kwargs.pop("mixed", False):
        b = b.to(torch.bfloat16)
    k = kwargs.pop("k", 3)
    with pytest.raises(error):
        knn_cuda.knn_topk(q, b, k, **kwargs)


def _mixed_range(m, d, seed):
    """Rows spanning two decades of norm (so row scales change the order)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, d)).astype(np.float32)
    return x * (10.0 ** rng.uniform(-2, 0, size=(m, 1))).astype(np.float32)


def _int8_inputs(form, n_q, m, d, seed):
    """(port queries, port bank, row_scale or None), the JAX arrays of the
    same values, and the value tolerance, for an int8 form of K1."""
    rng = np.random.default_rng(seed)
    b = _mixed_range(m, d, seed)
    q = rng.normal(size=(n_q, d)).astype(np.float32)
    codes, scale = quantize_bank_int8(jnp.asarray(b), per_row=form.endswith("rows"))
    codes = np.array(codes)
    rs = np.array(scale, np.float32) if form.endswith("rows") else None
    if form.startswith("int8"):
        q8 = np.asarray(quantize_queries_int8(jnp.asarray(q))[0])
        tq, jqq, tol = torch.from_numpy(q8.copy()), jnp.asarray(q8), 0.0
    else:  # asym: bf16 queries
        tq = torch.from_numpy(q).bfloat16()
        jqq = jnp.asarray(tq.float().numpy()).astype(jnp.bfloat16)
        s = rs[:, 0] if rs is not None else np.ones(m, np.float32)
        tol = RTOL * float(np.linalg.norm(tq.float().numpy(), axis=1).max()
                           * (np.linalg.norm(codes.astype(np.float32), axis=1) * s).max())
    trs = None if rs is None else torch.from_numpy(rs)
    jrs = None if rs is None else jnp.asarray(rs)
    return (tq, torch.from_numpy(codes), trs), (jqq, jnp.asarray(codes), jrs), tol


def _assert_topk_equivalent(tv, ti, jv, ji, tol):
    """Values within tol as sorted rows; the ids strictly above each row's
    k-th value (+ tol) are the same sets (ties at the boundary may differ)."""
    tv, ti, jv, ji = tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji)
    np.testing.assert_allclose(np.sort(tv, 1), np.sort(jv, 1), rtol=0, atol=tol)
    for r in range(tv.shape[0]):
        above_t = set(ti[r][tv[r] > tv[r, -1] + tol])
        above_j = set(ji[r][jv[r] > jv[r, -1] + tol])
        assert above_t == above_j, r


def _assert_port_tie_order(tv, ti, scores, k):
    """The port's result equals a stable sort of the exact scores: value
    descending, then lowest index."""
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(ti.numpy(), order)
    np.testing.assert_array_equal(tv.numpy(), np.take_along_axis(scores, order, axis=1))


@pytest.mark.parametrize("k", [1, 10, 30, 128])
@pytest.mark.parametrize("form", ["int8", "int8_rows", "asym", "asym_rows"])
def test_int8_forms_match_pallas(form, k):
    """K1 (c), (c)+(d), (e) and (e)+(d): the plain version against
    `pallas_knn(..., interpret=True)` on the same codes and scales."""
    (tq, tb, trs), (jqq, jb, jrs), tol = _int8_inputs(form, 40, 700, 32, seed=k)
    tv, ti = exact_knn(tq, tb, k, valid_rows=650, row_scale=trs, bank_block=128)
    pv, pi = pallas_knn(jqq, jb, k, valid_rows=650, row_scale=jrs, block_q=8, block_m=256,
                        interpret=True)
    assert tv.dtype == torch.float32 and (ti < 650).all()
    _assert_topk_equivalent(tv, ti, pv, pi, tol)
    if form.startswith("int8"):
        # exact integer scores times one f32 scale: bit for bit, in the
        # port's tie order
        scores = tq.numpy().astype(np.int64) @ tb.numpy().astype(np.int64)[:650].T
        scores = scores.astype(np.float32)
        if trs is not None:
            scores = scores * trs.numpy()[:650, 0]
        _assert_port_tie_order(tv, ti, scores, k)


def test_int8_ties_keep_the_lowest_index():
    """Integer scores tie often: 8 distinct code rows repeated 50 times
    make every score 50-way tied; the port keeps the lowest copies."""
    rng = np.random.default_rng(4)
    base = rng.integers(-127, 128, size=(8, 16)).astype(np.int8)
    bank = np.tile(base, (50, 1))
    q = rng.integers(-127, 128, size=(5, 16)).astype(np.int8)
    scale = np.full((400, 1), 0.01, np.float32)
    tv, ti = knn_cuda.knn_topk(torch.from_numpy(q), torch.from_numpy(bank), 30,
                               row_scale=torch.from_numpy(scale))
    scores = (q.astype(np.int64) @ bank.astype(np.int64).T).astype(np.float32) * np.float32(0.01)
    _assert_port_tie_order(tv, ti, scores, 30)
    pv, _ = pallas_knn(jnp.asarray(q), jnp.asarray(bank), 30, row_scale=jnp.asarray(scale),
                       interpret=True)
    np.testing.assert_array_equal(np.sort(tv.numpy(), 1), np.sort(np.asarray(pv), 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 9, 30])
def test_l2_matches_jax(dtype, k):
    """K1 (b): the plain version against `pallas_knn(distance='l2')` and
    JAX `exact_knn(distance='l2')`, on rows of unequal norm (the l2 order
    differs from the dot order)."""
    rng = np.random.default_rng(100 + k)
    q = rng.normal(size=(30, 24)).astype(np.float32) * 2
    b = (rng.normal(size=(500, 24)) * rng.uniform(0.2, 3.0, (500, 1))).astype(np.float32)
    qj, qt = _to_dtype(q, dtype)
    bj, bt = _to_dtype(b, dtype)
    for distance in ("l2", "euclidean"):
        tv, ti = exact_knn(qt, bt, k, distance=distance, valid_rows=480, bank_block=128)
        tol = RTOL * float(np.linalg.norm(q, axis=1).max() * np.linalg.norm(b, axis=1).max()
                           + (np.linalg.norm(b, axis=1) ** 2).max())
        jv, ji = jax_exact_knn(qj, bj, k, distance=distance, valid_rows=480)
        _assert_same_topk(tv, ti, jv, ji, tol)
        pv, pi = pallas_knn(qj, bj, k, valid_rows=480, distance=distance, block_q=8, block_m=128,
                            interpret=True)
        _assert_same_topk(tv, ti, pv, pi, tol)
    # the score is q·b - ||b||²/2 of the rows as stored
    bs = bt.float().numpy()[:480].astype(np.float64)
    ref = qt.float().numpy().astype(np.float64) @ bs.T - 0.5 * (bs * bs).sum(1)
    np.testing.assert_allclose(tv.numpy(), np.take_along_axis(ref, ti.numpy(), 1), atol=tol)
    dv, di = exact_knn(qt, bt, k, valid_rows=480)
    assert not torch.equal(di, ti)


def test_l2_never_returns_masked_rows():
    """Rows past valid_rows that would win under l2 never surface."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(8, 16)).astype(np.float32)
    b = rng.normal(size=(200, 16)).astype(np.float32)
    b[120:] = q[0]
    tv, ti = knn_cuda.knn_topk(torch.from_numpy(q), torch.from_numpy(b), 6, valid_rows=120,
                               distance="l2")
    assert ti.max().item() < 120
    ref = q @ b[:120].T - 0.5 * (b[:120] ** 2).sum(1)
    np.testing.assert_allclose(tv.numpy(), -np.sort(-ref, 1)[:, :6], atol=1e-4)


def test_wrapper_routes_every_form_to_the_plain_version_on_the_cpu():
    (tq, tb, trs), _, _ = _int8_inputs("int8_rows", 9, 100, 16, seed=3)
    before = dict(knn_cuda.knn_topk.forms)
    kv, ki = knn_cuda.knn_topk(tq, tb, 5, valid_rows=90, row_scale=trs)
    pv, pi = exact_knn(tq, tb, 5, valid_rows=90, row_scale=trs)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    q, b = _inputs(9, 100, 16, seed=3)
    kv, ki = knn_cuda.knn_topk(torch.from_numpy(q), torch.from_numpy(b), 5, distance="l2")
    pv, pi = exact_knn(torch.from_numpy(q), torch.from_numpy(b), 5, distance="l2")
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    assert knn_cuda.knn_topk.launches == 0 and dict(knn_cuda.knn_topk.forms) == before == {}


def test_form_names():
    f, bf, i8 = torch.zeros(1, 16), torch.zeros(1, 16).bfloat16(), torch.zeros(1, 16, dtype=torch.int8)
    one = torch.ones(1)
    assert knn_cuda.form_name(f, f, False, None) == "dot"
    assert knn_cuda.form_name(bf, bf, True, None) == "l2"
    assert knn_cuda.form_name(i8, i8, False, None) == "int8"
    assert knn_cuda.form_name(i8, i8, False, one) == "int8_rows"
    assert knn_cuda.form_name(bf, i8, False, None) == "asym"
    assert knn_cuda.form_name(bf, i8, False, one) == "asym_rows"


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


@pytest.mark.parametrize(
    "case",
    ["rerank", "rerank_rows", "rerank_clamped", "rows", "rerank_few_valid"],
)
def test_knn_with_labels_reranks_as_sharded_single_device(case):
    """The single-device branch of `sharded_knn_with_labels`: a quantized
    first pass for the candidates, exact bf16 re-scoring of them; the
    candidate count is clamped to the bank's rows; -inf fillers and rows
    past valid_rows never win the re-score."""
    m = {"rerank_clamped": 40, "rerank_few_valid": 300}.get(case, 300)
    valid = 20 if case == "rerank_few_valid" else m - 10
    form = "int8_rows" if case in ("rerank_rows", "rows") else "int8"
    (tq, tb, trs), (jqq, jb, jrs), _ = _int8_inputs(form, 33, m, 32, seed=8)
    q = np.random.default_rng(8).normal(size=(33, 32)).astype(np.float32)
    rb = _mixed_range(m, 32, 8)
    labels = np.random.default_rng(1).random((m, 5)).astype(np.float32)
    n_cand = 0 if case == "rows" else 60
    rbj, rbt = _to_dtype(rb, torch.bfloat16)
    qbj, qbt = _to_dtype(q, torch.bfloat16)
    jv, ji, jl = sharded_knn_with_labels(
        jqq, jb, jnp.asarray(labels), 10, valid_rows=valid, kernel="pallas",
        rerank_bank=rbj if n_cand else None, rerank_queries=qbj if n_cand else None,
        rerank_candidates=n_cand, row_scale=jrs,
    )
    tv, ti, tl = knn_with_labels(
        tq, tb, torch.from_numpy(labels), 10, valid_rows=valid,
        rerank_bank=rbt if n_cand else None, rerank_queries=qbt if n_cand else None,
        rerank_candidates=n_cand, row_scale=trs,
    )
    assert (ti < valid).all()
    if n_cand and m > 10:
        # exact bf16 dots of the re-scored candidates, tie-free
        tol = RTOL * float(np.linalg.norm(q, axis=1).max() * np.linalg.norm(rb, axis=1).max())
        _assert_same_topk(tv, ti, jv, ji, tol)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    else:
        _assert_topk_equivalent(tv, ti, jv, ji, 0.0)


def test_rerank_past_the_kernel_limit_raises():
    """More than 128 reordering candidates exceed K1's k, as the JAX
    kernel asserts; the port raises instead of clamping."""
    (tq, tb, _), _, _ = _int8_inputs("int8", 4, 300, 16, seed=2)
    with pytest.raises(ValueError, match="k must be"):
        knn_with_labels(tq, tb, torch.zeros(300, 2), 10, rerank_bank=tb.float().bfloat16(),
                        rerank_candidates=129)


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


FLAT_QUANTIZED = {
    # id: (backend, kwargs)
    "exact_int8": ("exact", {"use_int8": True}),
    "exact_int8_alias": ("exact", {"quantization": "int8"}),
    "exact_int8_rows": ("exact", {"quantization": "int8_rows"}),
    "exact_int8_asym": ("exact", {"quantization": "int8_asym"}),
    "exact_int8_rerank": ("exact", {"use_int8": True, "num_reordering_candidates": 60}),
    "exact_rows_rerank": ("exact", {"quantization": "int8_rows", "num_reordering_candidates": 60}),
    "exact_l2": ("exact", {"distance_measure": "l2"}),
    "exact_euclidean_bf16": ("exact", {"distance_measure": "euclidean", "use_fp16": True}),
    "approx_int8": ("approx", {"use_int8": True}),
    "approx_int8_rows": ("approx", {"quantization": "int8_rows"}),
    "approx_int8_asym": ("approx", {"quantization": "int8_asym"}),
    "approx_score_ah": ("approx", {"quantization": "int8_asym", "dimensions_per_block": 4,
                                   "anisotropic_quantization_threshold": 0.2}),
    "approx_rows_blocks": ("approx", {"quantization": "int8_rows", "dimensions_per_block": 4}),
    "approx_int8_rerank": ("approx", {"use_int8": True, "num_reordering_candidates": 60}),
    "approx_l2": ("approx", {"distance_measure": "l2"}),
    "approx_l2_int8_ignored": ("approx", {"distance_measure": "l2", "use_int8": True}),
}


@pytest.mark.parametrize("case", list(FLAT_QUANTIZED))
def test_flat_backends_quantized_and_l2_match_jax(case):
    """The flat backends' int8 and l2 paths against the JAX backends:
    codes and scales, search values in the JAX package's units (int8
    scores rescaled by the query and bank scales; reordered ones exact bf16
    dots), ids, labels, and the dequantized features of the neighbours."""
    from hbird_tpu.nn import search_approx as ja
    from hbird_tpu.nn import search_exact as je
    from hbird_tpu_torch.nn import search_approx as ta
    from hbird_tpu_torch.nn import search_exact as te

    backend, kw = FLAT_QUANTIZED[case]
    b = _mixed_range(300, 32, seed=11)
    q = np.random.default_rng(12).normal(size=(40, 32)).astype(np.float32)
    labels = np.random.default_rng(2).random((300, 4)).astype(np.float32)
    jcls, tcls = (
        (je.NearestNeighborSearchExact, te.NearestNeighborSearchExact)
        if backend == "exact"
        else (ja.NearestNeighborSearchApprox, ta.NearestNeighborSearchApprox)
    )
    jnn = jcls(b, n_neighbors=10, label_memory=labels, valid_rows=290, **kw)
    tnn = tcls(b, n_neighbors=10, label_memory=labels, valid_rows=290, device="cpu", **kw)
    jstate, tstate = jnn.device_state, tnn.device_state
    assert set(tstate) == set(jstate)
    for key in jstate:
        if key != "labels":
            np.testing.assert_array_equal(_np(tstate[key]), np.asarray(jstate[key], np.float32)
                                          if jstate[key].dtype == jnp.bfloat16 else np.asarray(jstate[key]))
    jv, ji, jl = jnn.search_with_labels(jnp.asarray(q))
    tv, ti, tl = tnn.search_with_labels(torch.from_numpy(q))
    scale = tstate.get("bank_row_scale")
    s = scale.numpy()[:, 0] if scale is not None else np.ones(300, np.float32)
    codes = tstate.get("rerank_bank", tstate["bank"]).float().numpy()
    col = tstate.get("bank_col_scale")
    qn = np.linalg.norm(q * (col.numpy() if col is not None else 1), axis=1).max()
    tol = RTOL * float(qn * (np.linalg.norm(codes, axis=1) * s).max())
    if "l2" in case or "euclidean" in case:
        tol += RTOL * float((np.linalg.norm(b, axis=1) ** 2).max())
    if "bank_scale" in tstate and "rerank_bank" not in tstate:
        tol = 0.0  # int8 x int8 integers times the same two scales
    _assert_topk_equivalent(tv, ti, jv, ji, tol)
    assert (ti < 290).all()
    same = (ti.numpy() == np.asarray(ji)).all(1)
    np.testing.assert_array_equal(tl.numpy()[same], np.asarray(jl)[same])
    np.testing.assert_allclose(
        tnn.gather_features_pure(tstate, ti).float().numpy(),
        np.asarray(jnn.gather_features_pure(jstate, jnp.asarray(ti.numpy()))).astype(np.float32),
        rtol=0, atol=1e-6,
    )


def _np(x):
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


@pytest.mark.parametrize(
    "backend, kwargs",
    [
        ("approx", {"mesh": "bank2", "use_tree": True}),
        ("exact", {"idx_shard": True, "devices": ["cpu", "cpu"]}),
    ],
    ids=["mesh", "exact_shard"],
)
def test_backends_raise_for_later_slices(backend, kwargs):
    """The tree on a bank mesh is the next slice and raises. Bank sharding
    of the flat backends, which raised here until parallel/ was ported, now
    shards (parity: tests/test_torch_parallel.py)."""
    from hbird_tpu_torch.nn import NearestNeighborSearchApprox, NearestNeighborSearchExact
    from hbird_tpu_torch.parallel import make_mesh

    if kwargs.get("mesh") == "bank2":
        kwargs = {**kwargs, "mesh": make_mesh((2,), ("bank",), ["cpu", "cpu"])}
    cls = NearestNeighborSearchApprox if backend == "approx" else NearestNeighborSearchExact
    if backend == "approx":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cls(np.zeros((4, 8), np.float32), n_neighbors=2, device="cpu", **kwargs)
    else:
        nn = cls(np.zeros((4, 8), np.float32), n_neighbors=2, device="cpu", **kwargs)
        assert nn.mesh.shape == {"bank": 2} and len(nn.bank) == 2


@pytest.mark.parametrize(
    "backend, kwargs",
    [
        ("exact", {"quantization": "int4"}),
        ("exact", {"use_int8": True, "distance_measure": "l2"}),
        ("approx", {"quantization": "int8_rows", "distance_measure": "l2"}),
        ("approx", {"distance_measure": "cosine"}),
        ("exact", {"distance_measure": "cosine"}),
    ],
    ids=["exact_int4", "exact_int8_l2", "approx_int8_l2", "approx_cosine", "exact_cosine"],
)
def test_backends_reject_invalid_options(backend, kwargs):
    """What the JAX backends reject: an unknown quantization, int8 with
    l2, an unknown distance."""
    from hbird_tpu_torch.nn import NearestNeighborSearchApprox, NearestNeighborSearchExact

    cls = NearestNeighborSearchApprox if backend == "approx" else NearestNeighborSearchExact
    with pytest.raises(ValueError):
        cls(np.zeros((4, 8), np.float32), n_neighbors=2, device="cpu", **kwargs)


def test_backend_without_device_needs_cuda():
    from hbird_tpu_torch.nn import NearestNeighborSearchExact

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        NearestNeighborSearchExact(np.zeros((4, 8), np.float32), n_neighbors=2)
