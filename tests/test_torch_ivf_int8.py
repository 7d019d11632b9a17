"""K2's int8 forms and the int8 IVF tree: the port against the JAX package.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs `pallas_ivf_knn(..., interpret=True)`, `ivf_search_xla` and
`ivf_search`, and its tree backend; the port runs `ivf_search_plain`
(which its K2 wrapper takes for CPU tensors), `ivf_search` and its tree
backend, handed the JAX package's centroids (its k-means init draws
jax.random, which the port cannot repeat) and built with
tree_refine_rounds=0 so that they stay as handed over.

Tolerances: int8 x int8 scores (times a slot's row scale, one f32
multiply) equal bit for bit, and in the port's tie order (value
descending, then slot ascending) exactly; bf16 queries on int8 codes
within 1e-5 · ||q|| · max_i(||codes_i|| · s_i) (f32 sums of exact products
in another order). Against the JAX package, whose XLA path breaks ties by
probe order and whose kernel by carry slot, results compare as sorted
values and as the id sets strictly above each row's k-th value. The int8
tree: codes, per-slot scales (0 on empty slots), leaves and fills
exactly; anisotropic codes may differ on near-tied rows
(test_torch_quantize.py), so the score_ah tree compares its search
within the asym tolerance and its recall.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hbird_tpu.ops import ivf as jivf
from hbird_tpu.ops.quantize import quantize_bank_int8, quantize_queries_int8
from hbird_tpu_torch.ops import ivf

RTOL = 1e-5


def mixture_bank(m, d, n_clusters, seed=0, noise=0.08):
    """Unit-norm rows around n_clusters random directions."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    who = rng.integers(0, n_clusters, m)
    x = centers[who] + noise * rng.normal(size=(m, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _assert_port_order(tv, ti):
    """Value descending, then slot ascending."""
    tv, ti = tv.numpy(), ti.numpy()
    fin = np.isfinite(tv[:, 1:])
    ok = (tv[:, :-1] > tv[:, 1:]) | ((tv[:, :-1] == tv[:, 1:]) & (ti[:, :-1] < ti[:, 1:]))
    assert (ok | ~fin).all()


def _k2_inputs(block_q, n_probe, seed):
    """Random unit slabs (5 of cap 256, D 16) with an empty slab and one of
    9 rows, padding rows zero, and the probe lists of two query tiles."""
    rng = np.random.default_rng(seed)
    n_slabs, cap, d = 5, 256, 16
    fill = rng.integers(150, cap + 1, n_slabs)
    fill[1], fill[3] = 0, 9
    bank = rng.normal(size=(n_slabs * cap, d)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    bank[(np.arange(n_slabs * cap) % cap) >= np.repeat(fill, cap)] = 0.0
    q = rng.normal(size=(2 * block_q, d)).astype(np.float32)
    lids = np.stack([rng.permutation(n_slabs)[:n_probe] for _ in range(2)]).astype(np.int32)
    if n_probe == 1:
        lids[1, 0] = 3  # a tile that sees only the underfilled slab
    return q, bank, cap, torch.from_numpy(lids), torch.from_numpy(fill.astype(np.int32))


@pytest.fixture(scope="module")
def tree():
    """A JAX-built tree (12 leaves) on a clustered bank, and 300 queries."""
    x = mixture_bank(6000, 32, 6, seed=4)
    n_leaves, cap = jivf.tree_layout(6000, 12)
    jc = jivf.train_centroids(jnp.asarray(x[:4096]), n_leaves, iters=8, key=jax.random.PRNGKey(0))
    choices = jivf.assign_leaves(jnp.asarray(x), jc, n_choices=3)
    slots, fill = jivf.balanced_layout(choices, n_leaves, cap)
    tbank, _, _ = ivf.build_ivf_arrays(torch.from_numpy(x), None, slots, n_leaves, cap)
    rng = np.random.default_rng(3)
    q = (x[rng.integers(0, 6000, 300)] + 0.02 * rng.normal(size=(300, 32))).astype(np.float32)
    return {"tbank": tbank, "cap": cap, "jc": jc, "tc": torch.from_numpy(np.array(jc)),
            "jlv": jnp.asarray(fill, jnp.int32), "tlv": torch.from_numpy(fill.astype(np.int32)),
            "queries": (jnp.asarray(q), torch.from_numpy(q))}


def _int8_k2_inputs(form, block_q, n_probe, seed):
    """_k2_inputs quantized: int8 codes of the slabs (global or per-row
    scale, empty slots scale 0), int8 or bf16 queries; the port's and the
    JAX arrays and the value tolerance."""
    q, bank, cap, lids, lv = _k2_inputs(block_q, n_probe, seed)
    rng = np.random.default_rng(seed)
    bank = bank * (10.0 ** rng.uniform(-2, 0, size=(bank.shape[0], 1))).astype(np.float32)
    per_row = form.endswith("rows")
    codes, scale = quantize_bank_int8(jnp.asarray(bank), per_row=per_row)
    codes = np.array(codes)
    rs = None
    if per_row:
        rs = np.array(scale, np.float32)
        rs[(np.arange(len(rs)) % cap) >= np.repeat(lv.numpy(), cap)] = 0.0
    if form.startswith("int8"):
        q8 = np.array(quantize_queries_int8(jnp.asarray(q))[0])
        tq, jqq, tol = torch.from_numpy(q8.copy()), jnp.asarray(q8), 0.0
    else:
        tq = torch.from_numpy(q).bfloat16()
        jqq = jnp.asarray(tq.float().numpy()).astype(jnp.bfloat16)
        s = rs[:, 0] if rs is not None else np.ones(len(codes), np.float32)
        tol = RTOL * float(np.linalg.norm(q, axis=1).max()
                           * (np.linalg.norm(codes.astype(np.float32), axis=1) * s).max())
    trs = None if rs is None else torch.from_numpy(rs)
    jrs = None if rs is None else jnp.asarray(rs)
    targs = (tq, torch.from_numpy(codes), lids, lv)
    jargs = (jqq, jnp.asarray(codes), jnp.asarray(lids.numpy()), jnp.asarray(lv.numpy()))
    return cap, targs, trs, jargs, jrs, tol


def _assert_topk_equivalent(tv, ti, jv, ji, tol):
    """Values within tol as sorted rows (-inf where JAX has -inf); the
    finite ids strictly above each row's k-th value (+ tol) are the same
    sets (ties at the boundary may differ)."""
    tv, ti, jv, ji = tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji)
    np.testing.assert_array_equal(np.isfinite(tv), np.isfinite(jv))
    np.testing.assert_allclose(np.sort(tv, 1), np.sort(jv, 1), rtol=0, atol=tol)
    for r in range(tv.shape[0]):
        above_t = set(ti[r][tv[r] > tv[r, -1] + tol])
        above_j = set(ji[r][jv[r] > jv[r, -1] + tol])
        assert above_t == above_j, r


@pytest.mark.parametrize("form", ["int8", "int8_rows", "asym", "asym_rows"])
@pytest.mark.parametrize("k", [1, 30, 128])
@pytest.mark.parametrize("block_q, n_probe", [(64, 1), (256, 5)], ids=["probe1", "probe_all"])
def test_plain_version_int8_forms_match_jax(form, k, block_q, n_probe):
    """K2's int8 forms: the plain version against `pallas_ivf_knn`
    (interpret) and `ivf_search_xla` on the same codes and slot scales."""
    cap, targs, trs, jargs, jrs, tol = _int8_k2_inputs(form, block_q, n_probe, seed=k + n_probe)
    tv, ti = ivf.ivf_search_plain(*targs, k, cap=cap, row_scale=trs)
    _assert_port_order(tv, ti)
    xv, xi = jivf.ivf_search_xla(*jargs, k, cap=cap, row_scale=jrs)
    _assert_topk_equivalent(tv, ti, xv, xi, tol)
    pv, pi = jivf.pallas_ivf_knn(*jargs, k, cap=cap, block_q=block_q, interpret=True, row_scale=jrs)
    _assert_topk_equivalent(tv, ti, pv, pi, tol)
    if form.startswith("int8"):
        # exact: each tile's probed valid slots, stable-sorted by score
        q8, codes, lids, lv = (t.numpy() for t in targs)
        for t in range(lids.shape[0]):
            cols = np.sort(np.concatenate([s * cap + np.arange(lv[s]) for s in lids[t]]))
            sc = (q8[t * block_q:(t + 1) * block_q].astype(np.int64)
                  @ codes[cols].astype(np.int64).T).astype(np.float32)
            if trs is not None:
                sc = sc * trs.numpy()[cols, 0]
            n = min(k, len(cols))
            order = np.argsort(-sc, axis=1, kind="stable")[:, :n]
            np.testing.assert_array_equal(ti.numpy()[t * block_q:(t + 1) * block_q, :n], cols[order])
            np.testing.assert_array_equal(tv.numpy()[t * block_q:(t + 1) * block_q, :n],
                                          np.take_along_axis(sc, order, 1))


def test_int8_ties_across_slabs_order_by_slot():
    """Three slabs hold the same codes, probed in the order 2, 0, 1: every
    integer score ties across slabs, and later-probed slabs carry lower
    slots; the port orders by slot exactly, the JAX values agree as a
    multiset."""
    rng = np.random.default_rng(9)
    cap = 256
    # codes of +-127: a row's own score, 127^2 * 16, is the largest there is
    base = (127 * rng.choice([-1, 1], size=(64, 16))).astype(np.int8)
    bank = np.zeros((3 * cap, 16), np.int8)
    for s in range(3):
        bank[s * cap: s * cap + 64] = base
    q = base
    lids = np.array([[2, 0, 1]], np.int32)
    fill = np.full(3, 64, np.int32)
    rs = np.zeros((3 * cap, 1), np.float32)
    rs[(np.arange(3 * cap) % cap) < 64] = 0.5
    tv, ti = ivf.ivf_search_plain(torch.from_numpy(q), torch.from_numpy(bank), torch.from_numpy(lids),
                                  torch.from_numpy(fill), 12, cap=cap, row_scale=torch.from_numpy(rs))
    _assert_port_order(tv, ti)
    np.testing.assert_array_equal(ti.numpy()[:, :3] % cap, np.tile(np.arange(64)[:, None], (1, 3)))
    np.testing.assert_array_equal(ti.numpy()[:, :3] // cap, np.tile(np.arange(3), (64, 1)))
    jv, _ = jivf.pallas_ivf_knn(jnp.asarray(q), jnp.asarray(bank), jnp.asarray(lids), jnp.asarray(fill),
                                12, cap=cap, block_q=64, interpret=True, row_scale=jnp.asarray(rs))
    np.testing.assert_array_equal(tv.numpy(), np.sort(np.asarray(jv), axis=1)[:, ::-1])


@pytest.mark.parametrize("probe_mode", ["tile", "query"])
@pytest.mark.parametrize("form", ["int8_rows", "asym_rows"])
def test_ivf_search_int8_matches_jax(tree, probe_mode, form):
    """ivf_search end to end on int8 slabs with per-slot scales: leaves
    chosen from the queries as handed in (codes cast to f32), then K2."""
    codes, scale = quantize_bank_int8(jnp.asarray(_np(tree["tbank"])), per_row=True)
    codes, rs = np.array(codes), np.array(scale, np.float32)
    qj, qt = tree["queries"]
    if form == "int8_rows":
        q8 = np.array(quantize_queries_int8(qj)[0])
        qj, qt = jnp.asarray(q8), torch.from_numpy(q8)
        tol = 0.0
    else:
        qt = qt.bfloat16()
        qj = jnp.asarray(qt.float().numpy()).astype(jnp.bfloat16)
        tol = RTOL * float(np.linalg.norm(qt.float().numpy(), axis=1).max()
                           * (np.linalg.norm(codes.astype(np.float32), axis=1) * rs[:, 0]).max())
    args = dict(cap=tree["cap"], n_probe=3, block_q=64, probe_mode=probe_mode)
    tv, ti = ivf.ivf_search(qt, torch.from_numpy(codes), tree["tc"], tree["tlv"], 10,
                            row_scale=torch.from_numpy(rs), **args)
    jv, ji = jivf.ivf_search(qj, jnp.asarray(codes), tree["jc"], tree["jlv"], 10, kernel="xla",
                             row_scale=jnp.asarray(rs), **args)
    _assert_topk_equivalent(tv, ti, jv, ji, tol)
    _assert_port_order(tv, ti)



# ----------------------------------------------------------------------
# The int8 tree backend
# ----------------------------------------------------------------------
TREE_MODES = {
    "use_int8": {"use_int8": True},
    "int8_rows": {"quantization": "int8_rows"},
    "int8_asym": {"quantization": "int8_asym"},
    "score_ah": {"quantization": "int8_asym", "dimensions_per_block": 4,
                 "anisotropic_quantization_threshold": 0.2, "num_reordering_candidates": 24},
}


def _backends(mode, m=4000, d=32):
    """JAX's int8 tree backend and the port's, handed JAX's centroids."""
    from hbird_tpu.nn.search_approx import NearestNeighborSearchApprox as JApprox
    from hbird_tpu_torch.nn import NearestNeighborSearchApprox

    rng = np.random.default_rng(21)
    x = mixture_bank(m, d, 6, seed=21) * (10.0 ** rng.uniform(-1, 0, (m, 1))).astype(np.float32)
    labels = rng.random((m, 4)).astype(np.float32)
    kw = dict(n_neighbors=8, label_memory=labels, use_tree=True, num_leaves=16,
              num_leaves_to_search=4, tree_sample_rows=2048, kmeans_iters=6, query_block=64,
              **TREE_MODES[mode])
    jnn = JApprox(x, **kw)
    c = torch.from_numpy(np.array(jnn.centroids, np.float32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ivf, "train_centroids", lambda sample, n_leaves, **k: c)
        tnn = NearestNeighborSearchApprox(x, **kw, tree_refine_rounds=0, device="cpu")
    q = (x[rng.integers(0, m, 256)] + 0.02 * rng.normal(size=(256, d))).astype(np.float32)
    return jnn, tnn, q


@pytest.mark.parametrize("mode", list(TREE_MODES))
def test_int8_tree_matches_jax(mode):
    """The int8 tree, built on the codes (trained, assigned and probed as
    f32 codes), its per-slot scales in the slab layout, and its search
    (no reorder on int8 slabs) against the JAX tree backend."""
    jnn, tnn, q = _backends(mode)
    assert tnn.bank.dtype == torch.int8 and tnn.quantization is not None
    cap = tnn._cap
    assert (tnn._n_leaves, cap) == (jnn._n_leaves, jnn._cap)
    ts, js = tnn.slots.numpy(), np.asarray(jnn.slots).astype(np.int64)
    np.testing.assert_array_equal(ts // cap, js // cap)  # the same leaf for every row
    np.testing.assert_array_equal(tnn.leaf_valid.numpy(), np.asarray(jnn.leaf_valid))
    tstate, jstate = tnn.device_state, jnn.device_state
    assert set(tstate) == set(jstate)
    codes_t, codes_j = tnn.bank.numpy()[ts], np.asarray(jnn.bank)[js]
    aniso = mode == "score_ah"
    differ = (codes_t != codes_j).any(1)
    assert differ.mean() <= (0.02 if aniso else 0.0)
    if "bank_row_scale" in tstate:
        rs = tstate["bank_row_scale"].numpy()
        np.testing.assert_array_equal(rs[ts], np.asarray(jstate["bank_row_scale"])[js])
        empty = np.ones(len(rs), bool)
        empty[ts] = False
        assert (rs[empty] == 0).all()
    else:
        assert float(tstate["bank_scale"]) == float(jstate["bank_scale"])
    if aniso:
        np.testing.assert_array_equal(tstate["bank_col_scale"].numpy(), np.asarray(jstate["bank_col_scale"]))
    jv, ji, jl = jnn.search_with_labels(jnp.asarray(q))
    tv, ti, tl = tnn.search_with_labels(torch.from_numpy(q))
    if mode == "use_int8":
        tol = 0.0  # integer scores times the same two scales
    else:
        col = tstate["bank_col_scale"].numpy() if aniso else 1.0
        deq = tstate["bank"].float().numpy() * tstate["bank_row_scale"].numpy()
        tol = RTOL * float(np.linalg.norm(q * col, axis=1).max() * np.linalg.norm(deq, axis=1).max())
    if aniso:
        # a near-tied row's other codes move its scores by ~one code step
        tol += 2.0 * float(np.abs(q * col).max() * tstate["bank_row_scale"].numpy().max())
    tvs, jvs = np.sort(tv.numpy(), 1), np.sort(np.asarray(jv), 1)
    np.testing.assert_allclose(tvs, jvs, rtol=0, atol=tol)
    same = (ti.numpy() == np.asarray(ji)).all(1)
    assert same.mean() >= (0.9 if aniso else 0.97)
    np.testing.assert_array_equal(tl.numpy()[same], np.asarray(jl)[same])
    np.testing.assert_allclose(
        tnn.gather_features_pure(tstate, ti).numpy()[same],
        np.asarray(jnn.gather_features_pure(jstate, jnp.asarray(ti.numpy())))[same],
        rtol=0, atol=1e-6 if not aniso else 1.0,
    )


def test_int8_tree_calibrates_the_same_probe_count():
    """Probe calibration ranks by the dequantized order (row scales)."""
    jnn, tnn, _ = _backends("int8_rows")
    n_probe = tnn.calibrate_n_probe(0.95, n_queries=256)
    assert n_probe == jnn.calibrate_n_probe(0.95, n_queries=256) and 1 < n_probe < 16


def test_prequantized_tree_takes_the_bank_scale():
    """A torch int8 tensor is taken as codes with the given global scale."""
    from hbird_tpu_torch.nn import NearestNeighborSearchApprox

    x = mixture_bank(2000, 16, 4, seed=5)
    codes, scale = quantize_bank_int8(jnp.asarray(x), per_row=False)
    tcodes = torch.from_numpy(np.array(codes))
    nn = NearestNeighborSearchApprox(tcodes, n_neighbors=5, use_tree=True, use_int8=True,
                                     bank_scale=float(scale), num_leaves=8, num_leaves_to_search=8,
                                     device="cpu")
    assert torch.equal(nn.bank[nn.slots], tcodes) and float(nn.bank_scale) == float(scale)
    ref = NearestNeighborSearchApprox(x, n_neighbors=5, use_tree=True, use_int8=True, num_leaves=8,
                                      num_leaves_to_search=8, device="cpu")
    q = torch.from_numpy(x[:50])
    v, i, _ = nn.search_with_labels(q)
    rv, ri, _ = ref.search_with_labels(q)
    assert torch.equal(v, rv)
    for kwargs in ({}, {"quantization": "int8_rows", "bank_scale": 0.1}):
        with pytest.raises(ValueError):
            NearestNeighborSearchApprox(tcodes, n_neighbors=5, use_tree=True,
                                        **({"use_int8": True} | kwargs), device="cpu")
