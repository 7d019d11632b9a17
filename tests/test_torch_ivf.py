"""The IVF tree (ops/ivf.py, K2's plain version, the tree backend): the port
against the JAX package.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side of K2 runs as `tests/test_ivf.py` runs it on the CPU:
`pallas_ivf_knn(..., interpret=True)` and `ivf_search_xla`; the port runs
`ivf_search_plain`, which its K2 wrapper takes for CPU tensors.

Tolerances: the build (layout, slots, fill, bank, labels, perm) exactly
given the same leaf choices; centroids 1e-5; leaf ids and query orders
exactly on well-separated clusters, apart from leaves or rows whose f32
scores tie within rounding (XLA and torch sum in another order);
search values within 1e-5 · ||q|| · max||b||, index sets equal on
tie-free inputs and value multisets on duplicated rows (the port orders
ties by slot, the JAX package by probe order or carry slot); labels 1e-6.
K2's int8 forms and the int8 tree are in test_torch_ivf_int8.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hbird_tpu.ops import ivf as jivf
from hbird_tpu.ops.knn import rerank_exact as jax_rerank_exact
from hbird_tpu_torch.ops import ivf, ivf_cuda, knn_cuda
from hbird_tpu_torch.ops.knn import rerank_exact
import wgmma_smem
from wgmma_smem import WgmmaLibrary

RTOL = 1e-5


def mixture_bank(m, d, n_clusters, seed=0, noise=0.08):
    """Unit-norm rows around n_clusters random directions."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    who = rng.integers(0, n_clusters, m)
    x = centers[who] + noise * rng.normal(size=(m, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32), who


def _to_dtype(x, dtype):
    """numpy f32 -> (jax array, torch tensor) in `dtype`, identical values."""
    t = torch.from_numpy(np.ascontiguousarray(x)).to(dtype)
    j = jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    )
    return j, t


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _assert_same_topk(tv, ti, jv, ji, tol):
    """Values within tol, -inf where JAX has -inf (the port's index is then
    0; the JAX XLA path leaves a masked slot there), finite index sets equal."""
    tv, ti = tv.numpy(), ti.numpy()
    jv, ji = np.asarray(jv), np.asarray(ji).astype(np.int64)
    finite = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv), finite)
    np.testing.assert_allclose(tv[finite], jv[finite], rtol=0, atol=tol)
    assert (ti[~finite] == 0).all()
    np.testing.assert_array_equal(
        np.sort(np.where(finite, ti, -1), axis=1), np.sort(np.where(finite, ji, -1), axis=1)
    )


def _assert_port_order(tv, ti):
    """Value descending, then slot ascending."""
    tv, ti = tv.numpy(), ti.numpy()
    fin = np.isfinite(tv[:, 1:])
    ok = (tv[:, :-1] > tv[:, 1:]) | ((tv[:, :-1] == tv[:, 1:]) & (ti[:, :-1] < ti[:, 1:]))
    assert (ok | ~fin).all()


def _tol(q, b):
    return RTOL * float(np.linalg.norm(q, axis=1).max() * max(np.linalg.norm(b, axis=1).max(), 1.0))


def hand_over_centroids(mp, centroids):
    """Make the port's tree build take `centroids` (the JAX package's, whose
    k-means init draws jax.random) for its k-means result; build with
    tree_refine_rounds=0 so that they stay as handed over."""
    c = torch.from_numpy(np.asarray(centroids, np.float32))
    mp.setattr(ivf, "train_centroids", lambda sample, n_leaves, **kw: c.to(sample.device))


# ----------------------------------------------------------------------
# Build
# ----------------------------------------------------------------------
@pytest.mark.parametrize(
    "n_rows, num_leaves, slack",
    [(10_000, 16, 1.3), (87_616, 512, 1.3), (5, 512, 1.3), (1_024_000, 512, 1.3), (3000, 7, 2.0)],
)
def test_tree_layout_matches_jax(n_rows, num_leaves, slack):
    assert ivf.tree_layout(n_rows, num_leaves, slack) == jivf.tree_layout(n_rows, num_leaves, slack)


@pytest.mark.parametrize("with_scores", [False, True], ids=["no_scores", "scores"])
@pytest.mark.parametrize("cap", [256, 40, 26], ids=["ample", "spills", "full"])
def test_balanced_layout_matches_jax(with_scores, cap):
    rng = np.random.default_rng(cap)
    m, n_leaves = 1000, 40
    choices = rng.integers(0, n_leaves, (m, 3)).astype(np.int32)
    choices[:300, 0] = 3  # an overfull favourite leaf
    scores = rng.random((m, 3)).astype(np.float32) if with_scores else None
    slots, fill = ivf.balanced_layout(choices, n_leaves, cap, scores=scores)
    jslots, jfill = jivf.balanced_layout(choices, n_leaves, cap, scores=scores)
    np.testing.assert_array_equal(slots, jslots)
    np.testing.assert_array_equal(fill, jfill)
    assert len(np.unique(slots)) == m and fill.sum() == m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("with_labels", [True, False], ids=["labels", "no_labels"])
def test_build_ivf_arrays_matches_jax(dtype, with_labels):
    x, _ = mixture_bank(700, 16, 4, seed=1)
    rng = np.random.default_rng(2)
    labels = rng.random((700, 5)).astype(np.float32) if with_labels else None
    n_leaves, cap = 6, 256
    choices = rng.integers(0, n_leaves, (700, 3)).astype(np.int32)
    slots, _ = jivf.balanced_layout(choices, n_leaves, cap)
    xj, xt = _to_dtype(x, dtype)
    tb, tl, tp = ivf.build_ivf_arrays(
        xt, None if labels is None else torch.from_numpy(labels), slots, n_leaves, cap
    )
    jb, jl, jp = jivf.build_ivf_arrays(xj, labels, slots, n_leaves, cap)
    assert tb.dtype == dtype and tb.shape == (n_leaves * cap, 16)
    np.testing.assert_array_equal(_np(tb), _np(jb))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    if with_labels:
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    else:
        assert tl is None and jl is None


@pytest.mark.parametrize(
    "n_sample, n_leaves, spherical",
    [(2000, 12, True), (2000, 12, False), (10, 16, True)],
    ids=["spherical", "euclidean", "fewer_rows_than_leaves"],
)
def test_train_centroids_with_jax_init(n_sample, n_leaves, spherical):
    x, _ = mixture_bank(n_sample, 24, 6, seed=3)
    key = jax.random.PRNGKey(7)
    init = np.asarray(jax.random.choice(key, n_sample, (n_leaves,), replace=n_sample < n_leaves))
    jc = jivf.train_centroids(jnp.asarray(x), n_leaves, iters=6, key=key, spherical=spherical)
    tc = ivf.train_centroids(torch.from_numpy(x), n_leaves, iters=6, init=init, spherical=spherical)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)


def test_train_centroids_draws_from_the_generator():
    x, _ = mixture_bank(500, 8, 4, seed=4)
    a = ivf.train_centroids(torch.from_numpy(x), 6, generator=torch.Generator().manual_seed(1))
    b = ivf.train_centroids(torch.from_numpy(x), 6, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and a.shape == (6, 8)


def _jax_centroids(x, n_leaves, seed=0):
    return jivf.train_centroids(jnp.asarray(x), n_leaves, iters=8, key=jax.random.PRNGKey(seed))


def test_refine_centroids_balanced_matches_jax():
    x, _ = mixture_bank(3000, 24, 5, seed=5)
    c = _jax_centroids(x, 10)
    jc = jivf.refine_centroids_balanced(jnp.asarray(x), c, slack=1.1, rounds=2)
    tc = ivf.refine_centroids_balanced(
        torch.from_numpy(x), torch.from_numpy(np.asarray(c)), slack=1.1, rounds=2
    )
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)


@pytest.mark.parametrize(
    "block_rows, onehot_elems",
    [(1 << 18, None), (700, None), (1 << 18, 8 * 96)],
    ids=["one_block", "blocks", "onehot_blocks"],
)
def test_full_bank_lloyd_matches_jax(monkeypatch, block_rows, onehot_elems):
    if onehot_elems is not None:  # the leaf sums in one-hot blocks of 96 rows
        monkeypatch.setattr(ivf, "_ONEHOT_ELEMS", onehot_elems)
    x, _ = mixture_bank(2500, 24, 5, seed=6)
    c = _jax_centroids(x[:500], 8)
    jc = jivf.full_bank_lloyd(jnp.asarray(x), c, iters=2, block_rows=block_rows)
    tc = ivf.full_bank_lloyd(
        torch.from_numpy(x), torch.from_numpy(np.asarray(c)), iters=2, block_rows=block_rows
    )
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_choices", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_assign_leaves_matches_jax(n_choices, dtype):
    x, _ = mixture_bank(3000, 24, 6, seed=7)
    c = _jax_centroids(x, 12)
    xj, xt = _to_dtype(x, dtype)
    jids, jsc = jivf.assign_leaves(xj, c, n_choices=n_choices, block_rows=1024, return_scores=True)
    tids, tsc = ivf.assign_leaves(
        xt, torch.from_numpy(np.asarray(c)), n_choices=n_choices, block_rows=1024,
        return_scores=True,
    )
    assert tids.dtype == np.int32 and tids.shape == (3000, n_choices)
    np.testing.assert_allclose(tsc, jsc, rtol=0, atol=1e-5)
    # Ids equal, except between leaves whose scores tie within f32 rounding
    # (XLA and torch sum the products in another order).
    s = _np(xt).astype(np.float64) @ np.asarray(c, np.float64).T
    r, a = np.nonzero(tids != jids)
    assert len(r) <= 2
    np.testing.assert_allclose(s[r, tids[r, a]], s[r, jids[r, a]], rtol=0, atol=1e-6)
    ids_only = ivf.assign_leaves(xt, torch.from_numpy(np.asarray(c)), n_choices=n_choices)
    np.testing.assert_array_equal(ids_only, tids)


# ----------------------------------------------------------------------
# Search
# ----------------------------------------------------------------------
class Tree:
    """A JAX-built tree on a clustered bank and the port's copy of it."""

    def __init__(self, m=6000, d=32, n_clusters=6, num_leaves=12, seed=4, dtype=torch.float32):
        self.x, _ = mixture_bank(m, d, n_clusters, seed=seed)
        self.n_leaves, self.cap = jivf.tree_layout(m, num_leaves)
        self.jc = _jax_centroids(self.x[:4096], self.n_leaves)
        xj, xt = _to_dtype(self.x, dtype)
        choices = jivf.assign_leaves(xj, self.jc, n_choices=3)
        slots, fill = jivf.balanced_layout(choices, self.n_leaves, self.cap)
        self.jbank, _, self.jperm = jivf.build_ivf_arrays(xj, None, slots, self.n_leaves, self.cap)
        self.jlv = jnp.asarray(fill, jnp.int32)
        self.tbank, _, self.tperm = ivf.build_ivf_arrays(xt, None, slots, self.n_leaves, self.cap)
        self.tlv = torch.from_numpy(fill.astype(np.int32))
        self.tc = torch.from_numpy(np.asarray(self.jc))

    def queries(self, n, seed=5, noise=0.02, dtype=torch.float32):
        rng = np.random.default_rng(seed)
        q = self.x[rng.integers(0, len(self.x), n)] + noise * rng.normal(size=(n, self.x.shape[1]))
        return _to_dtype(q.astype(np.float32), dtype)


@pytest.fixture(scope="module")
def tree():
    return Tree()


def test_select_block_leaves_and_query_order_match_jax(tree):
    qj, qt = tree.queries(512)
    for block_q, n_probe in ((64, 3), (128, 12), (256, 1)):
        np.testing.assert_array_equal(
            ivf.select_block_leaves(qt, tree.tc, n_probe, block_q).numpy(),
            np.asarray(jivf.select_block_leaves(qj, tree.jc, n_probe, block_q)),
        )
    np.testing.assert_array_equal(
        ivf.coherent_query_order(qt, tree.tc).numpy(),
        np.asarray(jivf.coherent_query_order(qj, tree.jc)),
    )
    for block_q in (64, 256):
        assert ivf.tile_coherence(qt, tree.tc, block_q) == jivf.tile_coherence(qj, tree.jc, block_q)


def _k2_inputs(dtype, block_q, n_probe, seed):
    """Random slabs with an empty slab and an underfilled one (fewer rows
    than k), and the probe lists of two query tiles."""
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
    qj, qt = _to_dtype(q, dtype)
    bj, bt = _to_dtype(bank, dtype)
    return (q, bank, cap), (qj, bj, jnp.asarray(lids), jnp.asarray(fill, jnp.int32)), (
        qt, bt, torch.from_numpy(lids), torch.from_numpy(fill.astype(np.int32))
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("block_q", [64, 128, 256])
@pytest.mark.parametrize("k", [1, 30, 128])
@pytest.mark.parametrize("n_probe", [1, 5], ids=["probe1", "probe_all"])
def test_plain_version_matches_jax(dtype, block_q, k, n_probe):
    (q, bank, cap), jargs, targs = _k2_inputs(dtype, block_q, n_probe, seed=k + block_q + n_probe)
    tv, ti = ivf.ivf_search_plain(*targs, k, cap=cap)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int64 and tv.shape == (2 * block_q, k)
    _assert_port_order(tv, ti)
    tol = _tol(q, bank)
    xv, xi = jivf.ivf_search_xla(*jargs, k, cap=cap)
    _assert_same_topk(tv, ti, xv, xi, tol)
    pv, pi = jivf.pallas_ivf_knn(*jargs, k, cap=cap, block_q=block_q, interpret=True)
    _assert_same_topk(tv, ti, pv, pi, tol)


def test_plain_version_on_duplicated_rows():
    """Each slab holds the same rows: ties across slabs. The port orders
    them by slot; the JAX values agree as a multiset."""
    rng = np.random.default_rng(9)
    cap, d = 256, 16
    base = rng.normal(size=(64, d)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    bank = np.zeros((3 * cap, d), np.float32)
    for s in range(3):
        bank[s * cap : s * cap + 64] = base
    q = base
    lids = np.array([[2, 0, 1]], np.int32)
    fill = np.full(3, 64, np.int32)
    tv, ti = ivf.ivf_search_plain(
        torch.from_numpy(q), torch.from_numpy(bank), torch.from_numpy(lids),
        torch.from_numpy(fill), 12, cap=cap,
    )
    _assert_port_order(tv, ti)
    assert (ti.numpy()[:, :3] % cap == np.arange(64)[:, None]).all()
    np.testing.assert_array_equal(ti.numpy()[:, :3] // cap, np.tile(np.arange(3), (64, 1)))
    for jv, _ in (
        jivf.ivf_search_xla(jnp.asarray(q), jnp.asarray(bank), jnp.asarray(lids), jnp.asarray(fill), 12, cap=cap),
        jivf.pallas_ivf_knn(jnp.asarray(q), jnp.asarray(bank), jnp.asarray(lids), jnp.asarray(fill), 12,
                            cap=cap, block_q=64, interpret=True),
    ):
        np.testing.assert_allclose(tv.numpy(), np.sort(np.asarray(jv), axis=1)[:, ::-1], atol=1e-6)


@pytest.mark.parametrize(
    "probe_mode, n_q, n_probe, block_q",
    [("tile", 512, 3, 64), ("tile", 300, 2, 256), ("query", 300, 3, 64),
     ("query", 37, 12, 128), ("auto", 600, 2, 256), ("auto", 60, 2, 64)],
    ids=["tile", "tile_ragged", "query", "query_all_leaves", "auto_dense", "auto_sparse"],
)
def test_ivf_search_matches_jax(tree, probe_mode, n_q, n_probe, block_q):
    if probe_mode == "auto" and n_q < 100:
        qj, qt = _to_dtype(np.random.default_rng(8).normal(size=(n_q, 32)).astype(np.float32),
                           torch.float32)  # iid queries: low tile coherence
    else:
        qj, qt = tree.queries(n_q, seed=n_q)
    args = dict(cap=tree.cap, n_probe=n_probe, block_q=block_q, probe_mode=probe_mode)
    tv, ti = ivf.ivf_search(qt, tree.tbank, tree.tc, tree.tlv, 10, **args)
    jv, ji = jivf.ivf_search(qj, tree.jbank, tree.jc, tree.jlv, 10, kernel="xla", **args)
    assert tv.shape == (n_q, 10)
    _assert_same_topk(tv, ti, jv, ji, _tol(np.asarray(qj), tree.x))
    _assert_port_order(tv, ti)


def test_auto_mode_resolves_as_jax():
    """Dense leaf-coherent queries probe per tile, sparse iid ones per query."""
    t = Tree(m=4000, num_leaves=32)
    dense_j, dense_t = t.queries(1024)
    sparse_j, sparse_t = _to_dtype(np.random.default_rng(1).normal(size=(64, 32)).astype(np.float32),
                                   torch.float32)
    coh = {}
    for name, qj, qt in (("dense", dense_j, dense_t), ("sparse", sparse_j, sparse_t)):
        coh[name] = ivf.tile_coherence(qt, t.tc, 256)
        assert coh[name] == jivf.tile_coherence(qj, t.jc, 256)
    # with n_probe = 32, 'auto' probes the dense set per tile, the sparse per query
    assert coh["dense"] <= 16 < coh["sparse"]


def test_dedup_topk_matches_jax():
    """Repeated rows keep their first occurrence; -inf fillers (index 0)
    never collide with a real row 0; short rows end in (-inf, 0)."""
    vals = np.array(
        [[0.9, 0.5, 0.9, -np.inf, 0.1, 0.5],
         [0.3, -np.inf, 0.3, -np.inf, -np.inf, -np.inf],
         [0.7, 0.2, 0.6, 0.2, 0.8, -np.inf]], np.float32)
    idx = np.array([[4, 0, 4, 0, 7, 0], [0, 0, 0, 0, 0, 0], [1, 2, 3, 5, 6, 0]], np.int32)
    tv, ti = ivf._dedup_topk(torch.from_numpy(vals), torch.from_numpy(idx.astype(np.int64)), 4)
    jv, ji = jivf._dedup_topk(jnp.asarray(vals), jnp.asarray(idx), 4)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy()[1], [0, 0, 0, 0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rerank_exact_matches_jax(dtype):
    rng = np.random.default_rng(12)
    q = rng.normal(size=(70, 16)).astype(np.float32)
    bank = rng.normal(size=(400, 16)).astype(np.float32)
    cand = np.stack([rng.choice(400, 20, replace=False) for _ in range(70)]).astype(np.int32)
    valid = rng.random((70, 20)) > 0.2
    bj, bt = _to_dtype(bank, dtype)
    tv, ti = rerank_exact(torch.from_numpy(q), bt, torch.from_numpy(cand.astype(np.int64)), 8,
                          cand_valid=torch.from_numpy(valid), query_block=32)
    jv, ji = jax_rerank_exact(jnp.asarray(q), bj, jnp.asarray(cand), 8, cand_valid=jnp.asarray(valid))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ----------------------------------------------------------------------
# The K2 wrapper on the CPU
# ----------------------------------------------------------------------
def test_wrapper_routes_cpu_tensors_to_plain_version():
    _, _, (qt, bt, lids, lv) = _k2_inputs(torch.float32, 64, 2, seed=1)
    before = ivf_cuda.ivf_topk.launches
    kv, ki = ivf_cuda.ivf_topk(qt, bt, lids, lv, 5, cap=256, block_q=64)
    pv, pi = ivf.ivf_search_plain(qt, bt, lids, lv, 5, cap=256)
    assert ivf_cuda.ivf_topk.launches == before == 0
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


@pytest.mark.parametrize(
    "kwargs, error",
    [({"int8": True}, ValueError), ({"row_scale": torch.ones(1280)}, ValueError),
     ({"k": 129}, ValueError), ({"cap": 300}, ValueError), ({"block_q": 32}, ValueError),
     ({"mixed": True}, ValueError), ({"codes": True, "row_scale": torch.ones(1279)}, ValueError)],
    ids=["int8", "row_scale", "k_too_large", "cap_not_slabs", "tiles_mismatch", "mixed_dtype",
         "row_scale_length"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(kwargs, error):
    """As `pallas_ivf_knn` asserts: dtype pairs outside f32/f32, bf16/bf16,
    int8/int8 and bf16/int8 (here int8 queries on f32 slabs), row scales on
    float slabs or of the wrong length."""
    kwargs = dict(kwargs)
    _, _, (qt, bt, lids, lv) = _k2_inputs(torch.float32, 64, 2, seed=1)
    if kwargs.pop("int8", False):
        qt = qt.to(torch.int8)
    if kwargs.pop("codes", False):
        qt, bt = qt.to(torch.int8), bt.to(torch.int8)
    if kwargs.pop("mixed", False):
        bt = bt.to(torch.bfloat16)
    k = kwargs.pop("k", 3)
    kwargs.setdefault("cap", 256)
    kwargs.setdefault("block_q", 64)
    with pytest.raises(error):
        ivf_cuda.ivf_topk(qt, bt, lids, lv, k, **kwargs)


@pytest.mark.parametrize("d", [3088, 3200])
def test_route_takes_int8_at_every_depth(d):
    """int8 x int8 slabs deeper than the wgmma kernel's resident queries fit
    (D > 3,072) stream each query chunk beside the slab chunk: on CUDA
    tensors `route` sends K2 to the wgmma kernel (held to the kernel's
    formula, tests/wgmma_smem.py), and on the CPU the wrapper runs the
    plain version, as at every depth."""
    assert wgmma_smem.smem_at(wgmma_smem.S8_FORM, d) == 0 < wgmma_smem.smem(wgmma_smem.S8_FORM, d)
    rng = np.random.default_rng(d)
    qt = torch.from_numpy(rng.integers(-127, 128, (64, d)).astype(np.int8))
    bt = torch.from_numpy(rng.integers(-127, 128, (512, d)).astype(np.int8))
    lids, lv = torch.tensor([[1, 0]], dtype=torch.int32), torch.tensor([256, 100], dtype=torch.int32)
    assert knn_cuda.route(WgmmaLibrary("ivf_topk"), qt, bt, "ivf_topk") == "wgmma"
    kv, ki = ivf_cuda.ivf_topk(qt, bt, lids, lv, 30, cap=256, block_q=64)
    pv, pi = ivf.ivf_search_plain(qt, bt, lids, lv, 30, cap=256)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


@pytest.mark.parametrize("d", [1544, 1664, 2048, 3200])
def test_route_takes_bf16_past_the_resident_edge(d):
    """bf16 slabs deeper than the wgmma kernel keeps its queries resident
    (64 query rows fit only up to D = 1,536) stream each query chunk beside
    the slab chunk: on CUDA tensors `route` sends K2 to the wgmma kernel
    (held to the kernel's formula, tests/wgmma_smem.py)."""
    form = wgmma_smem.BF16_FORM
    assert wgmma_smem.smem_at(form, d) == 0 < wgmma_smem.smem(form, d)
    qt = torch.zeros(64, d, dtype=torch.bfloat16)
    assert knn_cuda.route(WgmmaLibrary("ivf_topk"), qt, qt, "ivf_topk") == "wgmma"


def test_plain_bf16_at_width_1664_matches_pallas_ivf_knn():
    """K2 bf16 at D = 1,664 (streamed on the card): the plain version
    against `pallas_ivf_knn` (interpret) and `ivf_search_xla` on 3 slabs of
    cap 128 (one underfilled, one empty), two 64-query tiles probing them
    in different orders, at K2's tolerance."""
    rng = np.random.default_rng(1664)
    cap, fill = 128, np.array([128, 40, 0], dtype=np.int32)
    bank = rng.normal(size=(3 * cap, 1664)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    bank[(np.arange(3 * cap) % cap) >= np.repeat(fill, cap)] = 0.0
    q = rng.normal(size=(128, 1664)).astype(np.float32)
    lids = np.array([[0, 1, 2], [2, 1, 0]], dtype=np.int32)
    qj, qt = _to_dtype(q, torch.bfloat16)
    bj, bt = _to_dtype(bank, torch.bfloat16)
    tv, ti = ivf.ivf_search_plain(qt, bt, torch.from_numpy(lids), torch.from_numpy(fill), 30, cap=cap)
    tol = _tol(q, bank)
    jargs = (qj, bj, jnp.asarray(lids), jnp.asarray(fill))
    xv, xi = jivf.ivf_search_xla(*jargs, 30, cap=cap)
    _assert_same_topk(tv, ti, xv, xi, tol)
    pv, pi = jivf.pallas_ivf_knn(*jargs, 30, cap=cap, block_q=64, interpret=True)
    _assert_same_topk(tv, ti, pv, pi, tol)


# ----------------------------------------------------------------------
# The tree backend
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def backends():
    """JAX's tree backend and the port's, handed JAX's centroids."""
    from hbird_tpu.nn.search_approx import NearestNeighborSearchApprox as JApprox
    from hbird_tpu_torch.nn import NearestNeighborSearchApprox

    x, _ = mixture_bank(5000, 32, 6, seed=21)
    labels = np.random.default_rng(22).random((5000, 4)).astype(np.float32)
    kw = dict(n_neighbors=10, label_memory=labels, use_tree=True, num_leaves=16,
              num_leaves_to_search=3, tree_sample_rows=2048, kmeans_iters=6, query_block=64)
    jnn = JApprox(x, **kw)
    with pytest.MonkeyPatch.context() as mp:
        hand_over_centroids(mp, np.asarray(jnn.centroids))
        tnn = NearestNeighborSearchApprox(x, **kw, tree_refine_rounds=0, device="cpu")
    q = x[np.random.default_rng(23).integers(0, 5000, 300)] + 0.02 * np.random.default_rng(24).normal(
        size=(300, 32)).astype(np.float32)
    return jnn, tnn, x, q.astype(np.float32)


def test_backend_tree_layout_matches_jax(backends):
    jnn, tnn, _, _ = backends
    cap = tnn._cap
    assert (tnn._n_leaves, cap) == (jnn._n_leaves, jnn._cap)
    assert tnn.bank.dtype == torch.bfloat16
    ts, js = tnn.slots.numpy(), np.asarray(jnn.slots).astype(np.int64)
    np.testing.assert_array_equal(ts // cap, js // cap)  # the same leaf for every row
    np.testing.assert_array_equal(tnn.leaf_valid.numpy(), np.asarray(jnn.leaf_valid))
    # Within a leaf rows rank by centroid score; rows whose scores tie
    # within f32 rounding may swap places.
    rows = np.nonzero(ts != js)[0]
    assert len(rows) <= 20
    cent = tnn.centroids.numpy().astype(np.float64)
    bank = _np(tnn.bank).astype(np.float64)

    def score(r):
        return (bank[ts[r]] * cent[ts[r] // cap]).sum(1)

    jax_row_at = np.asarray(jnn.perm)  # the row JAX keeps in each slot
    np.testing.assert_allclose(score(rows), score(jax_row_at[ts[rows]]), rtol=0, atol=1e-6)
    # each row is stored (with its label) where its slot says
    np.testing.assert_array_equal(_np(tnn.bank)[ts], _np(jnn.bank)[js])
    np.testing.assert_array_equal(tnn.labels.numpy()[ts], np.asarray(jnn.labels)[js])
    np.testing.assert_array_equal(tnn.perm.numpy()[ts], np.arange(len(ts)))
    assert set(tnn.device_state) == {"bank", "labels", "centroids", "leaf_valid", "perm", "slots"}


@pytest.mark.parametrize("reorder", [0, 20], ids=["no_reorder", "reorder_20"])
def test_backend_search_with_labels_matches_jax(backends, reorder):
    jnn, tnn, x, q = backends
    jnn.num_reordering_candidates = tnn.num_reordering_candidates = reorder
    try:
        jv, ji, jl = jnn.search_with_labels(jnp.asarray(q))
        tv, ti, tl = tnn.search_with_labels(torch.from_numpy(q))
    finally:
        jnn.num_reordering_candidates = tnn.num_reordering_candidates = 0
    _assert_same_topk(tv, ti, jv, ji, _tol(q, x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        tnn.gather_features_pure(tnn.device_state, ti).float().numpy(),
        np.asarray(jnn.gather_features_pure(jnn.device_state, ji)).astype(np.float32),
    )


def test_backend_find_nearest_neighbors_matches_jax(backends):
    jnn, tnn, x, q = backends
    ti, tv = tnn.find_nearest_neighbors(q[:40], 5)  # sparse: 'auto' probes per query
    ji, jv = jnn.find_nearest_neighbors(q[:40], 5)
    assert isinstance(ti, np.ndarray) and ti.shape == (40, 5)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=_tol(q, x))
    np.testing.assert_array_equal(np.sort(ti, 1), np.sort(ji, 1))


def test_backend_calibrates_the_same_probe_count(backends):
    jnn, tnn, _, _ = backends
    try:
        jn = jnn.calibrate_n_probe(0.97, n_queries=1024)
        tn = tnn.calibrate_n_probe(0.97, n_queries=1024)
    finally:
        jnn.num_leaves_to_search = tnn.num_leaves_to_search = 3
    assert tn == jn and 1 <= tn <= 16


def test_backend_builds_its_own_tree_and_trims_padding():
    """Without handed-over centroids the port trains its own (a
    torch.Generator draws the k-means init); rows past valid_rows are
    padding and never surface."""
    from hbird_tpu_torch.nn import NearestNeighborSearchApprox

    x, _ = mixture_bank(2000, 16, 4, seed=31)
    padded = np.concatenate([x, np.zeros((48, 16), np.float32)])
    nn = NearestNeighborSearchApprox(
        padded, n_neighbors=8, use_tree=True, num_leaves=8, num_leaves_to_search=8,
        valid_rows=2000, tree_sample_rows=1000, device="cpu",
    )
    assert nn.valid_rows == 2000 and int(nn.leaf_valid.sum()) == 2000
    assert set(nn.build_seconds) == {"kmeans", "refine", "assign", "layout", "scatter"}
    q = torch.from_numpy(x[:100])
    vals, idx, _ = nn.search_with_labels(q)
    # the bank is bf16, and the queries are cast to it
    bf = torch.from_numpy(x).to(torch.bfloat16).float()
    exact = torch.topk(q.to(torch.bfloat16).float() @ bf.T, 8).values
    assert (idx < 2000).all()
    assert (vals - exact).abs().max().item() <= 1e-5  # every leaf probed: exact


@pytest.mark.parametrize("kwargs", [{"mesh": "bank2"}], ids=["mesh"])
def test_tree_options_of_later_slices_raise(kwargs):
    """A tree on a bank mesh, which raised here until its slice was ported,
    is built over the shards: with every leaf probed it answers as the
    unmeshed tree. Its options raise ValueError when they name no mode."""
    from hbird_tpu_torch.nn import NearestNeighborSearchApprox
    from hbird_tpu_torch.parallel import make_mesh

    mesh = make_mesh((2,), ("bank",), ["cpu", "cpu"])
    x, _ = mixture_bank(500, 8, 4, seed=3)
    common = dict(n_neighbors=4, use_tree=True, num_leaves=4, num_leaves_to_search=4, query_block=64, device="cpu")
    nn = NearestNeighborSearchApprox(x, **common, mesh=mesh)
    one = NearestNeighborSearchApprox(x, **common)
    assert isinstance(nn.bank, list) and len(nn.bank) == 2 and nn._n_leaves == 4
    q = torch.from_numpy(x[:70])
    for a, b in zip(nn.search_with_labels(q), one.search_with_labels(q)):
        assert torch.equal(a, b)
    for bad in ({"shard_probe": "half"}, {"tree_build_layout": "disk"}):
        with pytest.raises(ValueError, match=next(iter(bad))):
            NearestNeighborSearchApprox(x, **common, mesh=mesh, **bad)
