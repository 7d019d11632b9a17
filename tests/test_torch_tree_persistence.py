"""Built-tree persistence, the streamed tree build and the engine's
save/load paths: the port against the JAX package and against itself.

- The mesh-free cases of tests/test_tree_persistence.py and of
  tests/test_ivf.py's streamed-build classes, on the port.
- `build_tree_streamed` with the JAX package's centroids handed over (its
  k-means init draws jax.random, which the port cannot repeat; no
  refinement rounds, so they stay as handed over): slots, leaf fill and
  perm equal to `hbird_tpu.ops.ivf.build_tree_streamed`'s, slabs within
  1e-6.
- A .treedir written by the JAX package, searched by the port: values
  within 1e-5·||q||·max||b||, ids equal on these tie-free queries, labels
  within 1e-6 (as K2's tests hold them).
- The engine saves its bank (.npy, .bankdir) or index (.treedir), and a
  second engine restores it with load_memory=True: the mIoU of the run that
  built it, exactly, without touching the train loader.
- The repaired bank build: banks bit for bit equal to concatenating each
  step's rows (the build before the repair), bounded and unbounded, and no
  concatenation when the row count is known.
"""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hbird_tpu.nn.search_approx import NearestNeighborSearchApprox as JApprox
from hbird_tpu.ops import ivf as jivf
from hbird_tpu_torch import hbird_eval
from hbird_tpu_torch.bank.io import is_tree_path, load_tree_state, save_memory_sharded, tree_path_on_disk
from hbird_tpu_torch.data import get_dataset
from hbird_tpu_torch.data.synthetic import make_voc_fixture
from hbird_tpu_torch.data.transforms import get_hbird_val_transforms
from hbird_tpu_torch.hbird_eval import HbirdEvaluation, _as_batch, _pad_batch
from hbird_tpu_torch.models.extractor import FeatureExtractorSimple
from hbird_tpu_torch.nn import NearestNeighborSearchApprox
from hbird_tpu_torch.ops import ivf

RTOL = 1e-5
INPUT, PATCH = 32, 4
S = INPUT // PATCH


def mixture_bank(m, d, n_clusters, seed=0, noise=0.08):
    """Unit-norm rows around n_clusters random directions."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.integers(0, n_clusters, m)] + noise * rng.normal(size=(m, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


def _clustered(m, d, n_clusters, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * 3
    x = centers[rng.integers(0, n_clusters, m)] + rng.normal(size=(m, d)).astype(np.float32) * 0.3
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def fixture():
    m, d, c = 2000, 32, 5
    x = _clustered(m, d, 8, seed=11)
    rng = np.random.default_rng(12)
    labels = rng.random((m, c)).astype(np.float32)
    q = x[rng.integers(0, m, 150)] + 0.02 * rng.normal(size=(150, d)).astype(np.float32)
    return x, labels, torch.from_numpy(q.astype(np.float32))


def _build(x, labels, **kw):
    kw.setdefault("num_leaves", 8)
    kw.setdefault("num_leaves_to_search", 4)
    kw.setdefault("query_block", 64)
    return NearestNeighborSearchApprox(x, n_neighbors=10, label_memory=labels, use_tree=True,
                                       device="cpu", **kw)


# ----------------------------------------------------------------------
# save_tree / load_tree (tests/test_tree_persistence.py, mesh-free)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    {},  # bf16 slabs (uint16 storage)
    {"use_fp16": False},  # f32 slabs
    {"use_int8": True},  # int8 slabs + global scale
    {"quantization": "int8_rows"},  # int8 slabs + per-slot scales
    {"quantization": "int8_asym", "dimensions_per_block": 4},  # asym scoring + column scales
], ids=["bf16", "f32", "int8", "int8_rows", "int8_asym"])
def test_search_bitequal_after_reload(fixture, tmp_path, kw):
    x, labels, q = fixture
    nn = _build(x, labels, **kw)
    path = str(tmp_path / "idx.treedir")
    assert nn.save_tree(path) == path and is_tree_path(path) and tree_path_on_disk(path) == path
    nn2 = NearestNeighborSearchApprox.load_tree(path, n_neighbors=10, num_leaves_to_search=4,
                                                query_block=64, device="cpu")
    assert nn2.use_tree and nn2.bank.dtype == nn.bank.dtype and nn2.quantization == nn.quantization
    v1, i1, l1 = nn.search_with_labels(q, 10)
    v2, i2, l2 = nn2.search_with_labels(q, 10)
    assert torch.equal(i1, i2) and torch.equal(v1, v2) and torch.equal(l1, l2)
    assert torch.equal(nn.gather_features_pure(nn.device_state, i1),
                       nn2.gather_features_pure(nn2.device_state, i2))


def test_state_roundtrip_fields(fixture, tmp_path):
    x, labels, _ = fixture
    nn = _build(x, labels)
    path = str(tmp_path / "idx.treedir")
    nn.save_tree(path, chunk_rows=700)  # several chunks
    st = load_tree_state(path, device="cpu")
    for name, want in (("perm", nn.perm), ("slots", nn.slots), ("leaf_valid", nn.leaf_valid),
                       ("centroids", nn.centroids), ("ivf_labels", nn.labels)):
        assert torch.equal(st[name], want), name
    assert st["ivf_bank"].dtype == torch.bfloat16 and torch.equal(st["ivf_bank"], nn.bank)
    assert st["cap"] == nn._cap and st["valid_rows"] == nn.valid_rows
    assert st["bank_row_scale"] is None and st["bank_col_scale"] is None and not st["asym"]


def test_save_requires_built_tree(fixture, tmp_path):
    x, labels, _ = fixture
    flat = NearestNeighborSearchApprox(x, n_neighbors=10, label_memory=labels, device="cpu")
    with pytest.raises(ValueError, match="BUILT tree"):
        flat.save_tree(str(tmp_path / "x.treedir"))


def test_int8_slab_injection_needs_its_scales(fixture):
    x, labels, _ = fixture
    nn = _build(x, labels, quantization="int8_rows")
    args = (nn.bank, nn.labels, nn.centroids, nn.leaf_valid, nn.perm, nn.slots)
    with pytest.raises(ValueError, match="bank_scale or bank_row_scale"):
        NearestNeighborSearchApprox.from_tree_state(*args, cap=nn._cap, valid_rows=nn.valid_rows)
    with pytest.raises(ValueError, match="requires bank_row_scale"):
        NearestNeighborSearchApprox.from_tree_state(*args, cap=nn._cap, valid_rows=nn.valid_rows,
                                                    bank_scale=1.0, quantization="int8_rows")
    with pytest.raises(ValueError, match="whole leaves"):
        NearestNeighborSearchApprox.from_tree_state(*args, cap=nn._cap + 1, valid_rows=nn.valid_rows,
                                                    bank_row_scale=nn.bank_row_scale)


def test_meshed_trees_raise(fixture, tmp_path):
    """Meshed trees, which raised here until their slice was ported: a
    .treedir loads onto a 2-shard mesh and answers as the unmeshed load;
    a mesh whose bank axis does not divide the leaf count raises
    ValueError, as the JAX package's loader does, and so does a streamed
    build whose rounded leaf count cannot split."""
    from hbird_tpu_torch.parallel import make_mesh

    x, labels, q = fixture
    nn = _build(x, labels)
    path = nn.save_tree(str(tmp_path / "t.treedir"))
    two, three = (make_mesh((n,), ("bank",), ["cpu"] * n) for n in (2, 3))
    meshed = NearestNeighborSearchApprox.load_tree(path, n_neighbors=10, num_leaves_to_search=8, query_block=64,
                                                   mesh=two, device="cpu")
    assert len(meshed.bank) == 2 and torch.equal(torch.cat(meshed.bank), nn.bank)
    one = NearestNeighborSearchApprox.load_tree(path, n_neighbors=10, num_leaves_to_search=8, query_block=64,
                                                device="cpu")
    for a, b in zip(meshed.search_with_labels(q), one.search_with_labels(q)):
        assert torch.equal(a, b)
    for call in (lambda: NearestNeighborSearchApprox.load_tree(path, mesh=three, device="cpu"),
                 lambda: load_tree_state(path, mesh=three, device="cpu"),
                 lambda: ivf.build_tree_streamed(lambda: iter(()), 2, 2, mesh=three)):
        with pytest.raises(ValueError, match="divisible"):
            call()


def _assert_same_topk(tv, ti, jv, ji, tol):
    jv, ji = np.asarray(jv), np.asarray(ji).astype(np.int64)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=tol)
    np.testing.assert_array_equal(np.sort(ti.numpy(), 1), np.sort(ji, 1))


@pytest.mark.parametrize("kw", [{}, {"use_fp16": False}], ids=["bf16", "f32"])
def test_jax_treedir_searched_by_the_port(tmp_path, kw):
    """A tree the JAX package built and saved, searched through the port's
    K2 path, agrees with the JAX package's search of the same tree."""
    x = mixture_bank(4000, 32, 6, seed=21)
    labels = np.random.default_rng(22).random((4000, 4)).astype(np.float32)
    jnn = JApprox(x, n_neighbors=10, label_memory=jnp.asarray(labels), use_tree=True, num_leaves=16,
                  num_leaves_to_search=4, query_block=64, **kw)
    path = str(tmp_path / "jax.treedir")
    jnn.save_tree(path, chunk_rows=1000)
    tnn = NearestNeighborSearchApprox.load_tree(path, n_neighbors=10, num_leaves_to_search=4,
                                                query_block=64, device="cpu")
    rng = np.random.default_rng(23)
    q = (x[rng.integers(0, 4000, 256)] + 0.05 * rng.normal(size=(256, 32))).astype(np.float32)
    jv, ji, jl = jnn.search_with_labels(jnp.asarray(q), 10)
    tv, ti, tl = tnn.search_with_labels(torch.from_numpy(q), 10)  # "auto" probing in both
    tol = RTOL * float(np.linalg.norm(q, axis=1).max())
    _assert_same_topk(tv, ti, jv, ji, tol)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-6)


# ----------------------------------------------------------------------
# The streamed build (tests/test_ivf.py's streamed-build classes, mesh-free)
# ----------------------------------------------------------------------
def _stream(x, labels, step, dtype=torch.float32):
    def stream():
        for i in range(0, x.shape[0], step):
            yield (torch.from_numpy(x[i : i + step]).to(dtype),
                   None if labels is None else torch.from_numpy(labels[i : i + step]))
    return stream


def test_stream_matches_flat_build():
    """The streamed build takes the flat build's sample and generator, so
    on the same rows it builds the same tree; search recall holds."""
    x = mixture_bank(3000, 32, 5, seed=21)
    rng = np.random.default_rng(22)
    labels = rng.random((3000, 6)).astype(np.float32)
    parts = ivf.build_tree_streamed(_stream(x, labels, 700), 3000, 10, slack=1.3, seed=0)  # ragged windows
    flat = NearestNeighborSearchApprox(x, n_neighbors=10, label_memory=labels, use_tree=True, num_leaves=10,
                                       num_leaves_to_search=5, query_block=64, use_fp16=False, device="cpu")
    assert torch.equal(parts["centroids"], flat.centroids)
    assert torch.equal(parts["slots"], flat.slots) and torch.equal(parts["perm"], flat.perm)
    assert torch.equal(parts["leaf_fill"], flat.leaf_valid)
    assert torch.equal(parts["ivf_bank"], flat.bank) and torch.equal(parts["ivf_labels"], flat.labels)
    assert set(parts["build_seconds"]) == {"kmeans", "refine", "assign", "layout", "scatter"}
    nn = NearestNeighborSearchApprox.from_tree_state(
        parts["ivf_bank"], parts["ivf_labels"], parts["centroids"], parts["leaf_fill"], parts["perm"],
        parts["slots"], cap=parts["cap"], valid_rows=3000, n_neighbors=10, num_leaves=10,
        num_leaves_to_search=5, query_block=64, use_int8=False,
    )
    q = torch.from_numpy(x[rng.integers(0, 3000, 128)])
    _, idx, labs = nn.search_with_labels(q, 10)
    idx = idx.numpy()
    assert (idx >= 0).all() and (idx < 3000).all()
    np.testing.assert_allclose(labs.numpy(), labels[idx], atol=1e-6)
    exact = np.argsort(-(q.numpy() @ x.T), axis=1)[:, :10]
    recall = np.mean([len(set(idx[i]) & set(exact[i])) / 10 for i in range(len(idx))])
    assert recall > 0.85, recall


def test_short_stream_is_caught():
    x = mixture_bank(300, 8, 2)
    with pytest.raises(ValueError, match="yielded 300 rows"):
        ivf.build_tree_streamed(_stream(x, None, 100), 400, 4)


TIE = 1e-6  # f32 near-ties in the layout priority (PERF.md section 2)


def _layout_prio(choices, scores, slots, cap):
    """Each row's layout priority: its centroid score for the leaf it sits
    in (NaN for a row spilled to a leaf it did not choose)."""
    hit = np.asarray(choices) == (np.asarray(slots) // cap)[:, None]
    prio = np.where(hit, np.asarray(scores), np.nan)
    return np.where(hit.any(1), np.nanmax(np.where(hit, prio, -np.inf), 1), np.nan)


def _assert_same_layout(t_slots, j_slots, cap, n_slots, t_prio, j_prio, tol=TIE):
    """Slots equal except adjacent swaps of rows whose priorities tie
    within `tol` in both packages; each row's leaf equal exactly. Returns
    sigma, the map from the JAX package's slots to the port's."""
    t_slots, j_slots = np.asarray(t_slots), np.asarray(j_slots)
    np.testing.assert_array_equal(t_slots // cap, j_slots // cap)
    sigma = np.arange(n_slots)
    sigma[j_slots] = t_slots
    row_at_t = np.full(sigma.size, -1)
    row_at_t[t_slots] = np.arange(t_slots.size)
    for r in np.nonzero(t_slots != j_slots)[0]:
        r2 = row_at_t[j_slots[r]]  # the row the port put in JAX's slot for r
        assert abs(int(t_slots[r]) - int(j_slots[r])) == 1 and j_slots[r2] == t_slots[r], (r, r2)
        for prio in (t_prio, j_prio):
            assert abs(float(prio[r]) - float(prio[r2])) <= tol, (r, r2, prio[r], prio[r2])
    return sigma


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_streamed_build_matches_jax_with_its_centroids(monkeypatch, dtype):
    """Leaves equal exactly; within a leaf the order equal except adjacent
    rows whose priorities tie within 1e-6 in both packages (the two
    matmuls may round them apart either way); perm and the slabs equal
    through that map of slots."""
    x = mixture_bank(3000, 32, 5, seed=25)
    labels = np.random.default_rng(26).random((3000, 6)).astype(np.float32)
    x = torch.from_numpy(x).to(dtype).float().numpy()  # rows as the store dtype holds them
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def jstream():
        for i in range(0, 3000, 700):
            yield jnp.asarray(x[i : i + 700], jdtype), labels[i : i + 700]

    jparts = jivf.build_tree_streamed(jstream, 3000, 10, slack=1.3, refine_rounds=0, seed=0)
    c = torch.from_numpy(np.asarray(jparts["centroids"], np.float32))
    monkeypatch.setattr(ivf, "train_centroids", lambda sample, n_leaves, **kw: c)
    parts = ivf.build_tree_streamed(_stream(x, labels, 700, dtype), 3000, 10, slack=1.3, refine_rounds=0)
    cap = parts["cap"]
    assert (cap, parts["n_leaves"]) == (jparts["cap"], jparts["n_leaves"])
    t_ch, t_sc = ivf.assign_leaves(torch.from_numpy(x).to(dtype), c, n_choices=3, return_scores=True)
    j_ch, j_sc = jivf.assign_leaves(jnp.asarray(x, jdtype), jnp.asarray(c.numpy()), n_choices=3, return_scores=True)
    t_slots, j_slots = parts["slots"].numpy(), np.asarray(jparts["slots"])
    sigma = _assert_same_layout(t_slots, j_slots, cap, parts["perm"].numel(), _layout_prio(t_ch, t_sc, t_slots, cap),
                                _layout_prio(j_ch, j_sc, j_slots, cap))
    np.testing.assert_array_equal(parts["leaf_fill"].numpy(), np.asarray(jparts["leaf_fill"]))
    j_perm = np.asarray(jparts["perm"])
    moved = np.empty_like(j_perm)
    moved[sigma] = j_perm
    np.testing.assert_array_equal(parts["perm"].numpy(), moved)
    assert parts["ivf_bank"].dtype == dtype
    for name, tv in (("ivf_bank", parts["ivf_bank"].float()), ("ivf_labels", parts["ivf_labels"])):
        jv = np.asarray(jparts[name], np.float32)
        moved = np.empty_like(jv)
        moved[sigma] = jv
        np.testing.assert_allclose(tv.numpy(), moved, rtol=0, atol=TIE, err_msg=name)


@pytest.mark.parametrize("gap, tied", [(4e-8, True), (1e-3, False)], ids=["near_tie", "apart"])
def test_layout_near_tie_is_tolerated_only_within_tie(gap, tied):
    """A constructed pair whose priorities the two packages round apart in
    opposite orders: accepted within 1e-6, refused when it is wider."""
    choices = np.array([[0, 1], [0, 1], [0, 1], [1, 0]], np.int32)
    base = np.array([[0.9, 0.1], [0.9, 0.2], [0.5, 0.3], [0.8, 0.4]], np.float32)
    t_sc, j_sc = base.copy(), base.copy()
    t_sc[0, 0] += gap  # the port puts row 0 first, the JAX package row 1
    j_sc[1, 0] += gap
    t_slots, _ = ivf.balanced_layout(choices, 2, 3, scores=t_sc)
    j_slots, _ = jivf.balanced_layout(choices, 2, 3, scores=j_sc)
    assert (t_slots[:2].tolist(), j_slots[:2].tolist()) == ([0, 1], [1, 0])
    args = (t_slots, j_slots, 3, 6, _layout_prio(choices, t_sc, t_slots, 3), _layout_prio(choices, j_sc, j_slots, 3))
    if tied:
        sigma = _assert_same_layout(*args)
        assert sigma[:2].tolist() == [1, 0]
    else:
        with pytest.raises(AssertionError):
            _assert_same_layout(*args)


def _bankdirs(tmp_path, x, labels, f_chunk, l_chunk):
    f_dir, l_dir = str(tmp_path / "feats.bankdir"), str(tmp_path / "labs.bankdir")
    save_memory_sharded(x, f_dir, chunk_rows=f_chunk)
    save_memory_sharded(labels, l_dir, chunk_rows=l_chunk)
    return f_dir, l_dir


def test_from_bankdir(tmp_path):
    x = mixture_bank(2500, 32, 4, seed=23)
    rng = np.random.default_rng(24)
    labels = rng.random((2500, 5)).astype(np.float32)
    f_dir, l_dir = _bankdirs(tmp_path, x, labels, 600, 900)  # chunked differently on purpose
    nn = NearestNeighborSearchApprox.from_bankdir(
        f_dir, l_dir, n_neighbors=10, window_rows=800, num_leaves=8, num_leaves_to_search=4,
        query_block=64, use_int8=False, device="cpu",
    )
    assert nn.valid_rows == 2500 and nn.bank.dtype == torch.bfloat16
    assert set(nn.build_seconds) == {"kmeans", "refine", "assign", "layout", "scatter"}
    _, idx, labs = nn.search_with_labels(torch.from_numpy(x[rng.integers(0, 2500, 100)]), 10)
    idx = idx.numpy()
    assert (idx >= 0).all() and (idx < 2500).all()
    np.testing.assert_allclose(labs.numpy(), labels[idx], atol=1e-6)
    # the same tree as the in-memory build of the same bank
    flat = NearestNeighborSearchApprox(x, n_neighbors=10, label_memory=labels, use_tree=True, num_leaves=8,
                                       num_leaves_to_search=4, query_block=64, device="cpu")
    for name in ("centroids", "slots", "perm", "leaf_valid", "bank", "labels"):
        assert torch.equal(getattr(nn, name), getattr(flat, name)), name


def test_from_bankdir_bfloat16(tmp_path):
    """A bf16 .bankdir (uint16 bits under the manifest dtype) streams into
    the tree build; every leaf probed, the top hit is the exact one."""
    x = mixture_bank(2000, 32, 4, seed=31)
    f_dir = str(tmp_path / "feats16.bankdir")
    save_memory_sharded(torch.from_numpy(x).to(torch.bfloat16), f_dir, chunk_rows=700)
    nn = NearestNeighborSearchApprox.from_bankdir(
        f_dir, None, n_neighbors=10, window_rows=600, num_leaves=8, num_leaves_to_search=8,
        query_block=64, device="cpu",
    )
    assert nn.bank.dtype == torch.bfloat16 and nn.valid_rows == 2000
    q = x[np.random.default_rng(32).integers(0, 2000, 100)]
    _, idx, _ = nn.search_with_labels(torch.from_numpy(q), 10)
    assert (idx[:, 0].numpy() == np.argmax(q @ x.T, axis=1)).mean() > 0.95


def test_from_bankdir_reads_a_jax_bf16_bankdir(tmp_path):
    from hbird_tpu.bank.io import save_memory_sharded as jax_save_sharded

    x = mixture_bank(1500, 16, 4, seed=33)
    j_dir, t_dir = str(tmp_path / "j.bankdir"), str(tmp_path / "t.bankdir")
    jax_save_sharded(jnp.asarray(x, jnp.bfloat16), j_dir, chunk_rows=400)
    save_memory_sharded(torch.from_numpy(x).to(torch.bfloat16), t_dir, chunk_rows=400)
    kw = dict(n_neighbors=5, window_rows=500, num_leaves=6, device="cpu")
    a = NearestNeighborSearchApprox.from_bankdir(j_dir, **kw)
    b = NearestNeighborSearchApprox.from_bankdir(t_dir, **kw)
    assert torch.equal(a.bank, b.bank) and torch.equal(a.slots, b.slots)


def test_f32_bankdir_use_int8_warns_and_casts_bf16(tmp_path, caplog):
    x = mixture_bank(1500, 16, 4, seed=43)
    labels = np.random.default_rng(44).random((1500, 4)).astype(np.float32)
    f_dir, l_dir = _bankdirs(tmp_path, x, labels, 400, 400)
    with caplog.at_level(logging.WARNING, logger="hbird_tpu_torch.nn.search_approx"):
        nn = NearestNeighborSearchApprox.from_bankdir(f_dir, l_dir, n_neighbors=5, num_leaves=6,
                                                      num_leaves_to_search=6, query_block=64,
                                                      use_int8=True, device="cpu")
    assert any("use_int8 ignored" in r.message for r in caplog.records)
    assert nn.bank.dtype == torch.bfloat16 and nn.quantization is None
    _, idx, _ = nn.search_with_labels(torch.from_numpy(x[:32]), 5)
    assert (idx < 1500).all()
    with pytest.raises(ValueError, match="not supported for streamed"):
        NearestNeighborSearchApprox.from_bankdir(f_dir, l_dir, quantization="int8_rows", device="cpu")


def test_int8_bankdir_streams_with_its_scale(tmp_path):
    """An int8 .bankdir (codes of one global scale) builds an int8 tree
    whose scores are in true units."""
    x = mixture_bank(1200, 16, 4, seed=45)
    scale = float(np.abs(x).max() / 127)
    codes = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    f_dir = str(tmp_path / "codes.bankdir")
    save_memory_sharded(codes, f_dir, chunk_rows=500)
    nn = NearestNeighborSearchApprox.from_bankdir(f_dir, n_neighbors=5, num_leaves=4, num_leaves_to_search=4,
                                                  bank_scale=scale, device="cpu")
    assert nn.bank.dtype == torch.int8 and nn.quantization == "int8"
    assert float(nn.bank_scale) == np.float32(scale)
    vals, idx, _ = nn.search_with_labels(torch.from_numpy(x[:16]), 5)
    true = (x[:16] * (codes[idx.numpy()[:, 0]] * np.float32(scale))).sum(1)
    np.testing.assert_allclose(vals[:, 0].numpy(), true, rtol=2e-2)


# ----------------------------------------------------------------------
# The engine
# ----------------------------------------------------------------------
def oracle_t(model, imgs):
    b, c, h, w = imgs.shape
    s = h // PATCH
    x = imgs.reshape(b, c, s, PATCH, s, PATCH).mean(dim=(3, 5))
    return x.permute(0, 2, 3, 1).reshape(b, s * s, c), None


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc_persist") / "voc")
    make_voc_fixture(root, n_train=12, n_val=6, size=(64, 48), colorize=True, seed=3, class_pool=[1, 2, 3, 4, 5])
    va = get_hbird_val_transforms(INPUT)
    ds, _ = get_dataset("voc", root, 4, 0, va, va)
    return ds


FE = FeatureExtractorSimple(None, oracle_t, eval_spatial_resolution=S, d_model=3)
TREE_PARAMS = {"num_leaves": 4, "num_leaves_to_search": 4, "query_block": 16}


def _engine(loader, nn_method, **kw):
    return HbirdEvaluation(FE, loader, num_classes=21, n_neighbours=5, device="cpu", nn_method=nn_method, **kw)


def exploding_loader():
    raise AssertionError("train loader touched on a load path")
    yield  # pragma: no cover


PERSIST_CASES = {
    # nn_method, nn_params, f_mem_p, l_mem_p (None: not saved)
    "scann_npy": ("scann", {}, "f.npy", "l.npy"),
    "faiss_npz": ("faiss", {}, "f.npz", "l.pt"),
    "scann_bankdir": ("scann", {}, "f.bankdir", "l.bankdir"),
    "ivf_bankdir_streamed": ("ivf", TREE_PARAMS, "f.bankdir", "l.bankdir"),
    "ivf_treedir": ("ivf", TREE_PARAMS, "idx.treedir", None),
    "ivf_int8_rows_treedir": ("ivf", dict(TREE_PARAMS, quantization="int8_rows"), "idx.treedir", None),
}


@pytest.mark.parametrize("case", list(PERSIST_CASES))
def test_engine_save_then_load_memory(voc, tmp_path, case):
    method, params, f_name, l_name = PERSIST_CASES[case]
    paths = dict(f_mem_p=str(tmp_path / f_name), l_mem_p=None if l_name is None else str(tmp_path / l_name))
    ev = _engine(voc.train_dataloader(), method, nn_params=dict(params), dataset_size=12, **paths)
    miou = ev.evaluate(voc.val_dataloader(), S)
    ev2 = _engine(exploding_loader(), method, nn_params=dict(params), load_memory=True, **paths)
    assert ev2.timer.summary()["memory_build"].get("items", 0) == 0
    if f_name.endswith(".treedir") or method == "ivf":
        assert ev2.feature_memory is None and ev2.NN_algorithm.use_tree
    else:
        assert torch.equal(ev2.feature_memory, ev.feature_memory)
        assert torch.equal(ev2.label_memory, ev.label_memory)
    assert ev2.evaluate(voc.val_dataloader(), S) == miou


def test_missing_files_fall_back_to_a_build(voc, tmp_path):
    with pytest.raises(AssertionError, match="train loader touched"):
        _engine(exploding_loader(), "ivf", nn_params=dict(TREE_PARAMS),
                f_mem_p=str(tmp_path / "absent.treedir"), load_memory=True)
    ev = _engine(voc.train_dataloader(), "scann", f_mem_p=str(tmp_path / "absent.npy"), load_memory=True)
    assert ev.feature_memory.shape == (12 * S * S, 3)


def test_treedir_does_not_skip_label_save(voc, tmp_path):
    """A .treedir f_mem_p still saves l_mem_p; a flat backend asked for a
    tree save saves its flat memory as '.flat.npy'."""
    tree_p, lab_p = str(tmp_path / "t.treedir"), str(tmp_path / "labels.npy")
    ev = _engine(voc.train_dataloader(), "ivf", nn_params=dict(TREE_PARAMS), f_mem_p=tree_p, l_mem_p=lab_p)
    np.testing.assert_array_equal(np.load(lab_p), ev.label_memory.numpy())
    assert tree_path_on_disk(tree_p)
    tree_p2 = str(tmp_path / "t2.treedir")
    ev2 = _engine(voc.train_dataloader(), "exact", f_mem_p=tree_p2)
    assert not tree_path_on_disk(tree_p2)
    np.testing.assert_array_equal(np.load(tree_p2 + ".flat.npy"), ev2.feature_memory.numpy())


@pytest.mark.parametrize("f_name", ["idx.treedir", "f.bankdir"])
def test_load_calibrates_a_recall_target(voc, tmp_path, monkeypatch, f_name):
    paths = dict(f_mem_p=str(tmp_path / f_name), l_mem_p=str(tmp_path / "l.bankdir"))
    _engine(voc.train_dataloader(), "ivf", nn_params={"num_leaves": 8}, **paths)
    calls = []
    calibrate = NearestNeighborSearchApprox.calibrate_n_probe
    monkeypatch.setattr(NearestNeighborSearchApprox, "calibrate_n_probe",
                        lambda self, r, **kw: calls.append(r) or calibrate(self, r, **kw))
    ev = _engine(exploding_loader(), "ivf", nn_params={"num_leaves": 8, "recall_target": 0.9},
                 load_memory=True, **paths)
    assert calls == [0.9] and 1 <= ev.NN_algorithm.num_leaves_to_search <= 8
    assert ev._search_opts == {"probe_mode": "tile"}


def test_scann_use_tree_streams_a_bankdir(tmp_path):
    x = mixture_bank(1500, 16, 4, seed=43)
    labels = np.random.default_rng(44).random((1500, 4)).astype(np.float32)
    f_dir, l_dir = _bankdirs(tmp_path, x, labels, 400, 400)
    ev = HbirdEvaluation.__new__(HbirdEvaluation)
    ev.f_mem_p, ev.l_mem_p = f_dir, l_dir
    ev.n_neighbours, ev.nn_method, ev.bf16_bank = 5, "approx", False
    ev.nn_params = {"use_tree": True, "num_leaves": 6, "num_leaves_to_search": 6, "query_block": 64}
    ev.device = torch.device("cpu")
    assert ev.load_memory() is True
    assert ev.feature_memory is None and ev.NN_algorithm.use_tree and ev.NN_algorithm.valid_rows == 1500
    _, idx, labs = ev.NN_algorithm.search_with_labels(torch.from_numpy(x[:64]), 5)
    np.testing.assert_allclose(labs.numpy(), labels[idx.numpy()], atol=1e-6)


class _CountCat:
    """Stands in for the engine module's `torch`, counting torch.cat calls."""

    def __init__(self):
        self.calls = 0

    def __getattr__(self, name):
        return getattr(torch, name)

    def cat(self, *args, **kwargs):
        self.calls += 1
        return torch.cat(*args, **kwargs)


def _concatenated_bank(loader, memory_size, dataset_size, seed=123):
    """The bank as the build made it before the repair: each step's rows
    kept and concatenated after the loop."""
    ev = HbirdEvaluation.__new__(HbirdEvaluation)
    ev.feature_extractor, ev.num_classes, ev.memory_size = FE, 21, memory_size
    ev.device, ev._device_norm = torch.device("cpu"), None
    ev._generator = torch.Generator().manual_seed(seed)
    ev.num_sampled_features = None if memory_size is None else max(1, memory_size // dataset_size)
    feats, labels, rows, batch_size = [], [], 0, None
    for x, y in loader:
        x, y = _as_batch(x), _as_batch(y)
        batch_size = batch_size or x.shape[0]
        x, valid = _pad_batch(x, batch_size)
        y, _ = _pad_batch(y, batch_size)
        f, lab = ev._memory_step(torch.from_numpy(x), torch.from_numpy(y))
        n = valid * (f.shape[0] // batch_size)
        if memory_size is not None:
            n = min(n, memory_size - rows)
        feats.append(f[:n])
        labels.append(lab[:n])
        rows += n
    return torch.cat(feats), torch.cat(labels)


@pytest.mark.parametrize("memory_size, dataset_size, cats", [
    (None, 12, 0),  # unbounded, row count known: written in place
    (None, None, 2),  # unbounded, count unknown: features and labels concatenated
    (200, 12, 0),  # bounded: 16 patches an image, 192 rows allocated
    (900, 12, 0),  # bounded, more budget than patches: every patch, 192 rows
    (None, 10, 2),  # a feed longer than dataset_size says: the excess joined on the host
    (None, 14, 0),  # a feed shorter than dataset_size says: a trimmed copy
], ids=["unbounded", "unbounded_unknown", "bounded", "bounded_trimmed", "overflow", "short"])
def test_bank_build_is_bit_for_bit_the_concatenation(voc, monkeypatch, memory_size, dataset_size, cats):
    counter = _CountCat()
    monkeypatch.setattr(hbird_eval, "torch", counter)
    ev = _engine(voc.train_dataloader(), "faiss", memory_size=memory_size, dataset_size=dataset_size)
    monkeypatch.undo()
    assert counter.calls == cats
    feats, labels = _concatenated_bank(voc.train_dataloader(), memory_size, 12)
    want_rows = 12 * (S * S if memory_size is None else min(S * S, memory_size // 12))
    assert ev.feature_memory.shape[0] == feats.shape[0] == want_rows
    assert torch.equal(ev.feature_memory, feats) and torch.equal(ev.label_memory, labels)
    assert ev.timer.summary()["memory_build"]["items"] == 12
    for bank in (ev.feature_memory, ev.label_memory):  # no larger allocation kept alive behind a view
        assert bank.untyped_storage().nbytes() == bank.numel() * bank.element_size()
