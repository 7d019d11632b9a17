"""Behaviour of the port's int8, score_ah and L2 search paths on the CPU.

The single-device cases of the JAX package's behaviour tests
(tests/test_int8_rows.py, tests/test_score_ah.py, and
tests/test_knn_pallas.py's int8 and L2 classes), run on the port with the
same data and the same bars: recall against the exact search, scores in
dot-product units, dequantized features, option validation, and the l2
order against a brute-force oracle. Mesh, persistence and engine-flow cases
are not mirrored here (the engine runs are in test_torch_engine.py).
numpy builds every input from a seed; no JAX is needed.
"""

import logging

import numpy as np
import pytest
import torch

from hbird_tpu_torch.nn import NearestNeighborSearchApprox, NearestNeighborSearchExact
from hbird_tpu_torch.ops.knn import exact_knn
from hbird_tpu_torch.ops.knn_cuda import knn_topk

CPU = dict(device="cpu")


def _recall(idx, ref_idx):
    k = idx.shape[1]
    return np.mean([len(set(idx[i]) & set(ref_idx[i])) / k for i in range(idx.shape[0])])


def _mixed_range_bank(rng, m, d):
    """Rows spanning 2 decades of dynamic range."""
    bank = rng.normal(size=(m, d)).astype(np.float32)
    return bank * (10.0 ** rng.uniform(-2, 0, size=(m, 1))).astype(np.float32)


def _decoy_bank(rng, m, d, n_decoys):
    """A few huge rows in one half of the dims set a global scale far too
    coarse for the unit rows in the other half, which the queries hit."""
    half = d // 2
    bank = np.zeros((m, d), np.float32)
    bank[:n_decoys, :half] = 100.0 * rng.normal(size=(n_decoys, half))
    small = rng.normal(size=(m - n_decoys, half)).astype(np.float32)
    bank[n_decoys:, half:] = small / np.linalg.norm(small, axis=1, keepdims=True)
    return bank


def _decoy_queries(rng, q_n, d):
    half = d // 2
    q = np.zeros((q_n, d), np.float32)
    qs = rng.normal(size=(q_n, half)).astype(np.float32)
    q[:, half:] = qs / np.linalg.norm(qs, axis=1, keepdims=True)
    return q


def _block_hetero_bank(rng, m, d, dpb):
    """Columns spanning 2 decades across blocks of `dpb` dims."""
    col_factor = np.repeat(10.0 ** np.linspace(-2, 0, d // dpb), dpb).astype(np.float32)
    return rng.normal(size=(m, d)).astype(np.float32) * col_factor, col_factor


def _hetero_queries(rng, q_n, d, col_factor):
    return (rng.normal(size=(q_n, d)).astype(np.float32) / col_factor).astype(np.float32)


def _brute_l2(q, bank, k):
    """score q·b - ||b||²/2 (ordering == ascending ||q - b||²)."""
    scores = q @ bank.T - 0.5 * (bank * bank).sum(-1)[None, :]
    idx = np.argsort(-scores, axis=-1, kind="stable")[:, :k]
    return np.take_along_axis(scores, idx, axis=-1), idx


# --- the kernel's row-scale form (tests/test_int8_rows.py::TestKernelRowScale)


def test_row_scale_orders_dequantized_dots():
    rng = np.random.default_rng(0)
    m, d, q_n, k = 2048, 32, 128, 8
    bank = _mixed_range_bank(rng, m, d)
    q = rng.normal(size=(q_n, d)).astype(np.float32)
    scale = (np.maximum(np.abs(bank).max(axis=1, keepdims=True), 1e-12) / 127).astype(np.float32)
    codes = np.clip(np.round(bank / scale), -127, 127).astype(np.int8)
    q8 = np.clip(np.round(q / (np.abs(q).max() / 127)), -127, 127).astype(np.int8)
    vals, idx = knn_topk(torch.from_numpy(q8), torch.from_numpy(codes), k,
                         row_scale=torch.from_numpy(scale))
    s_ref = (q8.astype(np.int32) @ codes.astype(np.int32).T).astype(np.float32) * scale[:, 0]
    ref_idx = np.argsort(-s_ref, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    np.testing.assert_array_equal(vals.numpy(), np.take_along_axis(s_ref, ref_idx, axis=1))


def test_row_scale_validation():
    rng = np.random.default_rng(1)
    bank = torch.from_numpy(rng.normal(size=(256, 16)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(32, 16)).astype(np.float32))
    with pytest.raises(ValueError, match="row_scale requires an int8 bank"):
        knn_topk(q, bank, 4, row_scale=torch.ones(256, 1))


# --- the backends' int8 schemes (tests/test_int8_rows.py)


def test_row_scales_beat_global_on_mixed_range():
    rng = np.random.default_rng(2)
    m, d, q_n, k = 8192, 64, 512, 10
    bank = _decoy_bank(rng, m, d, 64)
    q = _decoy_queries(rng, q_n, d)
    exact = NearestNeighborSearchExact(bank, n_neighbors=k, **CPU)
    glob = NearestNeighborSearchExact(bank, n_neighbors=k, use_int8=True, **CPU)
    rows = NearestNeighborSearchExact(bank, n_neighbors=k, quantization="int8_rows", **CPU)
    idx_e, vals_e = exact.find_nearest_neighbors(q, k)
    idx_g, _ = glob.find_nearest_neighbors(q, k)
    idx_r, vals_r = rows.find_nearest_neighbors(q, k)
    r_glob, r_rows = _recall(idx_g, idx_e), _recall(idx_r, idx_e)
    assert r_rows > 0.95, (r_rows, r_glob)
    assert r_rows > r_glob + 0.05, (r_rows, r_glob)
    # scores are approximate true dot products (q_scale * s_i units)
    assert np.abs(vals_r - vals_e).max() < 0.05


def test_quantization_int8_aliases_global():
    rng = np.random.default_rng(3)
    bank = rng.normal(size=(1024, 32)).astype(np.float32)
    q = rng.normal(size=(64, 32)).astype(np.float32)
    a = NearestNeighborSearchExact(bank, n_neighbors=5, use_int8=True, **CPU)
    b = NearestNeighborSearchExact(bank, n_neighbors=5, quantization="int8", **CPU)
    ia, va = a.find_nearest_neighbors(q, 5)
    ib, vb = b.find_nearest_neighbors(q, 5)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(va, vb)


@pytest.mark.parametrize("backend", [NearestNeighborSearchExact, NearestNeighborSearchApprox])
def test_invalid_quantization_rejected(backend):
    with pytest.raises(ValueError, match="quantization"):
        backend(np.zeros((8, 4), np.float32), quantization="int4", **CPU)


def test_gather_features_dequantizes_per_row():
    rng = np.random.default_rng(5)
    bank = _mixed_range_bank(rng, 512, 16)
    nn = NearestNeighborSearchExact(bank, n_neighbors=5, quantization="int8_rows", **CPU)
    idx = torch.from_numpy(rng.integers(0, 512, size=(8, 5)))
    rows = nn.gather_features_pure(nn.device_state, idx).numpy()
    ref = bank[idx.numpy()]
    assert np.abs(rows - ref).max() / np.abs(ref).max() < 0.01


@pytest.mark.parametrize("mode", ["tree", "flat"])
def test_approx_row_scales_beat_global(mode):
    """The tree (every leaf probed) and the flat 'scann' scan: per-row
    scales keep > 0.95 recall where the global scale loses it."""
    rng = np.random.default_rng(8 if mode == "tree" else 11)
    bank = _decoy_bank(rng, 4096, 32, 32)
    labels = rng.uniform(size=(4096, 4)).astype(np.float32)
    q = _decoy_queries(rng, 256, 32)
    k = 8
    common = dict(n_neighbors=k, label_memory=labels, query_block=64, **CPU)
    if mode == "tree":
        common.update(use_tree=True, num_leaves=8, num_leaves_to_search=8)
    exact = NearestNeighborSearchApprox(bank, use_fp16=False, **common)
    glob = NearestNeighborSearchApprox(bank, quantization="int8", **common)
    rows = NearestNeighborSearchApprox(bank, quantization="int8_rows", **common)
    assert rows.bank.dtype == torch.int8 and rows.bank_row_scale is not None
    idx_e = exact.find_nearest_neighbors(q, k)[0]
    r_g = _recall(glob.find_nearest_neighbors(q, k)[0], idx_e)
    r_r = _recall(rows.find_nearest_neighbors(q, k)[0], idx_e)
    assert r_r > 0.95, (r_r, r_g)
    if mode == "tree":
        assert r_r > r_g + 0.05, (r_r, r_g)


def test_asym_beats_symmetric_recall():
    """int8_asym: per-row codes under bf16 queries; the shortlist error is
    the bank's rounding alone."""
    rng = np.random.default_rng(20)
    m, d, q_n, k = 8192, 64, 512, 10
    bank = _mixed_range_bank(rng, m, d)
    q = rng.normal(size=(q_n, d)).astype(np.float32)
    exact = NearestNeighborSearchExact(bank, n_neighbors=k, **CPU)
    sym = NearestNeighborSearchExact(bank, n_neighbors=k, quantization="int8_rows", **CPU)
    asym = NearestNeighborSearchExact(bank, n_neighbors=k, quantization="int8_asym", **CPU)
    assert asym.int8_asym and asym.int8_rows and asym.bank.dtype == torch.int8
    idx_e, vals_e = exact.find_nearest_neighbors(q, k)
    idx_s = sym.find_nearest_neighbors(q, k)[0]
    idx_a, vals_a = asym.find_nearest_neighbors(q, k)
    r_sym, r_asym = _recall(idx_s, idx_e), _recall(idx_a, idx_e)
    assert r_asym >= 0.99, (r_asym, r_sym)
    assert r_asym >= r_sym, (r_asym, r_sym)
    # values are approximate true dot products directly
    assert np.abs(vals_a - vals_e).max() / np.abs(vals_e).max() < 0.02


def test_asym_decoy_bank_recall():
    rng = np.random.default_rng(21)
    bank = _decoy_bank(rng, 4096, 64, 64)
    q = _decoy_queries(rng, 256, 64)
    exact = NearestNeighborSearchExact(bank, n_neighbors=8, **CPU)
    asym = NearestNeighborSearchExact(bank, n_neighbors=8, quantization="int8_asym", **CPU)
    assert _recall(asym.find_nearest_neighbors(q, 8)[0], exact.find_nearest_neighbors(q, 8)[0]) >= 0.98


@pytest.mark.parametrize("mode", ["tree", "flat"])
def test_asym_approx_recall(mode):
    rng = np.random.default_rng(23 if mode == "tree" else 24)
    m = 4096 if mode == "tree" else 2048
    bank = _mixed_range_bank(rng, m, 32)
    labels = rng.uniform(size=(m, 4)).astype(np.float32)
    q = rng.normal(size=(256 if mode == "tree" else 128, 32)).astype(np.float32)
    k = 8
    common = dict(n_neighbors=k, label_memory=labels, query_block=64, **CPU)
    if mode == "tree":
        common.update(use_tree=True, num_leaves=8, num_leaves_to_search=8)
    exact = NearestNeighborSearchApprox(bank, use_fp16=False, **common)
    asym = NearestNeighborSearchApprox(bank, quantization="int8_asym", **common)
    assert asym.int8_asym and asym.bank.dtype == torch.int8
    # full probe budget: the recall gap is quantization error alone
    assert _recall(asym.find_nearest_neighbors(q, k)[0], exact.find_nearest_neighbors(q, k)[0]) >= 0.99


# --- the score_ah knobs (tests/test_score_ah.py)


def test_knobs_warn_without_int8_mode(caplog):
    bank = np.random.default_rng(4).normal(size=(256, 16)).astype(np.float32)
    with caplog.at_level(logging.WARNING, logger="hbird_tpu_torch.nn.search_approx"):
        nn = NearestNeighborSearchApprox(bank, n_neighbors=4, dimensions_per_block=4, **CPU)
    assert nn.dims_per_block is None and nn.bank_col_scale is None
    assert any("int8_rows" in r.message for r in caplog.records)


@pytest.mark.parametrize(
    "kwargs",
    [{"quantization": "int8_asym", "dimensions_per_block": 0},
     {"quantization": "int8_rows", "anisotropic_quantization_threshold": 1.5}],
    ids=["dims_per_block_0", "threshold_1.5"],
)
def test_knob_validation(kwargs):
    bank = np.random.default_rng(5).normal(size=(256, 16)).astype(np.float32)
    with pytest.raises(ValueError):
        NearestNeighborSearchApprox(bank, **kwargs, **CPU)


def test_flat_recall_improves_with_blocks():
    rng = np.random.default_rng(6)
    m, d, dpb, k = 8192, 64, 4, 10
    bank, col_factor = _block_hetero_bank(rng, m, d, dpb)
    q = _hetero_queries(rng, 512, d, col_factor)
    common = dict(n_neighbors=k, **CPU)
    exact = NearestNeighborSearchApprox(bank, use_fp16=False, **common)
    plain = NearestNeighborSearchApprox(bank, quantization="int8_asym", **common)
    ah = NearestNeighborSearchApprox(bank, quantization="int8_asym", dimensions_per_block=dpb, **common)
    assert ah.dims_per_block == dpb and ah.bank_col_scale is not None
    idx_e = exact.find_nearest_neighbors(q, k)[0]
    r_plain = _recall(plain.find_nearest_neighbors(q, k)[0], idx_e)
    r_ah = _recall(ah.find_nearest_neighbors(q, k)[0], idx_e)
    assert r_ah > r_plain + 0.05, (r_ah, r_plain)
    assert r_ah >= 0.95, r_ah


def test_flat_scores_are_dequantized_dots():
    rng = np.random.default_rng(7)
    bank, col_factor = _block_hetero_bank(rng, 2048, 32, 4)
    q = _hetero_queries(rng, 128, 32, col_factor)
    ah = NearestNeighborSearchApprox(bank, n_neighbors=8, quantization="int8_asym",
                                     dimensions_per_block=4, **CPU)
    idx, vals = ah.find_nearest_neighbors(q, 8)
    deq = ah.bank.float().numpy() * ah.bank_row_scale.numpy() * ah.bank_col_scale.numpy()
    ref = np.take_along_axis(q @ deq.T, idx, axis=1)
    # bf16 queries: the oracle's f32 queries differ by their cast
    np.testing.assert_allclose(vals, ref, rtol=2e-2, atol=2e-2)


def test_aniso_threshold_recall_sane():
    rng = np.random.default_rng(8)
    bank = rng.normal(size=(4096, 64)).astype(np.float32)
    bank *= (10.0 ** rng.uniform(-1.5, 0, size=(4096, 1))).astype(np.float32)
    q = rng.normal(size=(256, 64)).astype(np.float32)
    exact = NearestNeighborSearchApprox(bank, n_neighbors=10, use_fp16=False, **CPU)
    an = NearestNeighborSearchApprox(bank, n_neighbors=10, quantization="int8_asym",
                                     anisotropic_quantization_threshold=0.2, **CPU)
    assert an.aniso_threshold == 0.2
    assert _recall(an.find_nearest_neighbors(q, 10)[0], exact.find_nearest_neighbors(q, 10)[0]) >= 0.97


def test_tree_full_probe_with_blocks():
    rng = np.random.default_rng(9)
    bank, col_factor = _block_hetero_bank(rng, 4096, 32, 4)
    labels = rng.uniform(size=(4096, 4)).astype(np.float32)
    q = _hetero_queries(rng, 256, 32, col_factor)
    common = dict(n_neighbors=8, label_memory=labels, use_tree=True, num_leaves=8,
                  num_leaves_to_search=8, query_block=64, **CPU)
    exact = NearestNeighborSearchApprox(bank, use_fp16=False, **common)
    plain = NearestNeighborSearchApprox(bank, quantization="int8_asym", **common)
    ah = NearestNeighborSearchApprox(bank, quantization="int8_asym", dimensions_per_block=4,
                                     anisotropic_quantization_threshold=0.2, **common)
    idx_e = exact.find_nearest_neighbors(q, 8)[0]
    r_a = _recall(ah.find_nearest_neighbors(q, 8)[0], idx_e)
    assert r_a > _recall(plain.find_nearest_neighbors(q, 8)[0], idx_e) + 0.05
    assert r_a >= 0.95


def test_reference_literal_params():
    """tree(num_leaves, num_leaves_to_search) + score_ah(2,
    anisotropic_quantization_threshold=0.2, dimensions_per_block=4) +
    reorder(C): every knob consumed."""
    rng = np.random.default_rng(12)
    bank, col_factor = _block_hetero_bank(rng, 4096, 32, 4)
    q = _hetero_queries(rng, 256, 32, col_factor)
    nn = NearestNeighborSearchApprox(
        bank, n_neighbors=8, use_tree=True, num_leaves=8, num_leaves_to_search=8,
        anisotropic_quantization_threshold=0.2, dimensions_per_block=4,
        num_reordering_candidates=24, quantization="int8_asym", query_block=64, **CPU,
    )
    assert nn.dims_per_block == 4 and nn.aniso_threshold == 0.2
    exact = NearestNeighborSearchApprox(bank, n_neighbors=8, use_tree=True, num_leaves=8,
                                        num_leaves_to_search=8, use_fp16=False, query_block=64, **CPU)
    assert _recall(nn.find_nearest_neighbors(q, 8)[0], exact.find_nearest_neighbors(q, 8)[0]) >= 0.95


# --- the global int8 bank and reordering (tests/test_knn_pallas.py::TestInt8Bank)


def _unit_bank(rng, m, d):
    bank = rng.normal(size=(m, d)).astype(np.float32)
    return bank / np.linalg.norm(bank, axis=1, keepdims=True)


def test_int8_backend_self_retrieval():
    rng = np.random.default_rng(0)
    bank = _unit_bank(rng, 2000, 64)
    labels = rng.uniform(size=(2000, 5)).astype(np.float32)
    src = rng.integers(0, 2000, size=128)
    q = bank[src] * 2.0 + 0.005 * rng.normal(size=(128, 64)).astype(np.float32)
    nn8 = NearestNeighborSearchExact(bank, n_neighbors=10, use_int8=True, label_memory=labels, **CPU)
    assert nn8.bank.dtype == torch.int8
    vals, idx, lbls = nn8.search_with_labels(torch.from_numpy(q), 10)
    top1 = idx.numpy()[:, 0]
    assert (top1 == src).mean() >= 0.95
    np.testing.assert_array_equal(lbls.numpy(), labels[idx.numpy()])
    # scores rescaled to approximate dot products
    v, true = vals.numpy()[:, 0], (q * bank[src]).sum(-1)
    np.testing.assert_allclose(v[top1 == src], true[top1 == src], rtol=0.1)


@pytest.mark.parametrize("rerank, bar", [(0, 0.7), (60, 0.97)], ids=["int8", "int8_rerank"])
def test_int8_recall_vs_exact(rerank, bar):
    """reorder(C): an int8 scan, then the exact bf16 re-score of 60
    candidates, recovers the exact top-k."""
    rng = np.random.default_rng(1 if not rerank else 2)
    bank = _unit_bank(rng, 3000, 64)
    q = rng.normal(size=(64, 64)).astype(np.float32)
    nn8 = NearestNeighborSearchExact(bank, n_neighbors=10, use_int8=True,
                                     num_reordering_candidates=rerank, **CPU)
    assert (nn8.rerank_bank is not None) == bool(rerank)
    idx8, _ = nn8.find_nearest_neighbors(q, 10)
    _, ref = exact_knn(torch.from_numpy(q), torch.from_numpy(bank), 10)
    assert _recall(idx8, ref.numpy()) >= bar


def test_approx_float_rerank_knobs_are_inert():
    """On a float bank the flat 'scann' search is the exact kernel: the
    reordering and recall knobs change nothing."""
    rng = np.random.default_rng(4)
    bank = rng.normal(size=(4096, 32)).astype(np.float32)
    q = rng.normal(size=(32, 32)).astype(np.float32)
    nn_a = NearestNeighborSearchApprox(bank, n_neighbors=8, num_reordering_candidates=64,
                                       recall_target=0.9, use_fp16=False, **CPU)
    idx_a, _ = nn_a.find_nearest_neighbors(q, 8)
    _, ref = exact_knn(torch.from_numpy(q), torch.from_numpy(bank), 8)
    np.testing.assert_array_equal(idx_a, ref.numpy())


# --- L2 (tests/test_knn_pallas.py::TestPallasL2)


@pytest.mark.parametrize("q_n, m, d, k", [(16, 256, 32, 5), (30, 500, 16, 7)])
def test_l2_matches_brute_force(q_n, m, d, k):
    rng = np.random.default_rng(1000 + q_n)
    q = rng.normal(size=(q_n, d)).astype(np.float32) * 2
    bank = (rng.normal(size=(m, d)) * rng.uniform(0.2, 3.0, (m, 1))).astype(np.float32)
    vals, idx = knn_topk(torch.from_numpy(q), torch.from_numpy(bank), k, distance="l2")
    ref_vals, ref_idx = _brute_l2(q, bank, k)
    np.testing.assert_allclose(vals.numpy(), ref_vals, rtol=1e-4, atol=1e-4)
    assert np.all((idx.numpy() == ref_idx) | np.isclose(vals.numpy(), ref_vals))
    _, idx_dot = knn_topk(torch.from_numpy(q), torch.from_numpy(bank), k)
    assert not np.array_equal(idx_dot.numpy(), ref_idx)  # the orders differ on this data


def test_l2_valid_rows_masked():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(8, 16)).astype(np.float32)
    bank = rng.normal(size=(200, 16)).astype(np.float32)
    bank[120:] = q[0]  # unbeatable under l2 for query 0, but past valid_rows
    vals, idx = knn_topk(torch.from_numpy(q), torch.from_numpy(bank), 6, valid_rows=120,
                         distance="l2")
    assert idx.numpy().max() < 120
    np.testing.assert_allclose(vals.numpy(), _brute_l2(q, bank[:120], 6)[0], atol=1e-4)


@pytest.mark.parametrize("backend", ["exact", "approx"])
@pytest.mark.parametrize("measure", ["l2", "euclidean"])
def test_backends_l2_match_brute_force(backend, measure):
    """Faiss GpuIndexFlatL2 parity on the exact backend, and the flat
    'scann' l2 path on the same fused kernel (recall 1.0)."""
    rng = np.random.default_rng(6 if backend == "exact" else 15)
    bank = (rng.normal(size=(600, 16)) * 1.4).astype(np.float32)
    cls = NearestNeighborSearchExact if backend == "exact" else NearestNeighborSearchApprox
    nn = cls(torch.from_numpy(bank), n_neighbors=6, distance_measure=measure, use_fp16=False)
    q = rng.normal(size=(20, 16)).astype(np.float32)
    idx, vals = nn.find_nearest_neighbors(q)
    ref_vals, ref_idx = _brute_l2(q, bank, 6)
    np.testing.assert_allclose(vals, ref_vals, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(idx, ref_idx)
