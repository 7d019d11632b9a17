"""int8 x int8 search on the wide banks (D = 1,040, 1,280 and 1,536, and
3,200, past the depth at which the card's kernel keeps its int8 queries
resident), and bf16 queries on int8 codes at D = 1,280 (mae_vith14's
width, where the card's kernel streams its query chunks): the port against
the JAX package.

The TPU kernels (`_knn_kernel`, `_ivf_kernel`) accumulate int8 x int8 in
int32 and convert to f32 once, at every depth; so do the port's CUDA
kernels (s32 wgmma accumulators, one `__int2float_rn`) and, since they are
held to them bit for bit, the plain versions (ops/knn.py::dot_scores: the
exact integer sum, rounded once). Past 2^24 an f32 running sum rounds at
every step, so the order of summation shows. The codes here have every
7th column negated (in queries and bank alike, so every product is
positive) and magnitudes 120-127: the exact sums pass 2^24 within the
first 1,152 columns, so at D = 1,280 and 1,536 a 128-deep chunked f32 sum
rounds more than once and misses the once-rounded value in many scores
(half the sums are odd). Each test first asserts that; at D = 1,040 no
int8 sum can reach 2^24 (1,040 · 127² < 2^24), and that depth's last
128-byte chunk is partial, which the kernel's TMA fills with zeros.

Held here, numpy inputs from a seed:
- the plain K1 (`exact_knn`) and K2 (`ivf_search_plain`), int8 and
  int8_rows, against `pallas_knn` and `pallas_ivf_knn` in interpret mode:
  values bit for bit; ids equal on rows whose top k + 1 values are all
  distinct, and elsewhere the ids strictly above the k-th value as sets;
  and exactly a stable sort (value descending, then index) of the int64
  scores rounded once;
- the plain K1 asym and asym_rows (bf16 queries on int8 codes widened
  exactly) against `pallas_knn` in interpret mode at D = 1,280: values
  within 1e-5 · max ||q|| · max_i(||b_i|| · s_i), the ids above the k-th
  value (+ that) as sets;
- the wrappers (`knn_topk`, `ivf_topk`) take these depths on CPU tensors
  (the plain version, no launch), and `route` sends them to the wgmma
  kernel at every depth: its queries resident up to D = 3,072, streamed
  past it (tests/wgmma_smem.py);
- K1 over a 2-shard bank mesh (gather, ring) equals the unsharded search
  bit for bit at D = 1,536;
- `hbird_evaluation` with a tiny ViT 1,280 wide (one block of 16 heads of
  80, the JAX weights carried across) in `faiss` int8 + reorder 120,
  `scann` int8_rows and `ivf` int8_rows probing every leaf: the mIoU
  within 1e-4 of the JAX engine's.
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hbird_tpu
import hbird_tpu_torch
from hbird_tpu.models.vit import ViT as JViT, ViTConfig as JConfig
from hbird_tpu.ops import ivf as jivf
from hbird_tpu.ops.knn_pallas import pallas_knn
from hbird_tpu_torch.data.synthetic import make_voc_fixture
from hbird_tpu_torch.models.convert import params_from_jax
from hbird_tpu_torch.models.vit import ViT, ViTConfig
from hbird_tpu_torch.ops import ivf, ivf_cuda, knn_cuda
from hbird_tpu_torch.ops.knn import exact_knn, knn_with_labels
from hbird_tpu_torch.parallel import make_mesh, ring_knn_with_labels, shard_bank, sharded_knn_with_labels
from hbird_tpu_torch.parallel.sharded_knn import shard_rows
import wgmma_smem
from wgmma_smem import WgmmaLibrary

DEPTHS = [1040, 1280, 1536, 3200]
KS = [30, 120]
FORMS = ["int8", "int8_rows"]
CHUNK = 128  # the kernel's depth chunk of int8 codes


def sharp_codes(rng, n, d):
    """int8 codes of magnitude 120-127, every 7th column negated."""
    sign = np.where(np.arange(d) % 7 == 0, -1, 1)
    return (rng.integers(120, 128, size=(n, d)) * sign).astype(np.int8)


def exact_scores(q, b):
    """int64 q·bᵀ of int8 codes."""
    return q.astype(np.int64) @ b.astype(np.int64).T


def assert_sharp(q, b):
    """The inputs can tell one rounding from a running f32 sum: at D >=
    1,280 a 128-deep chunked f32 accumulation misses the once-rounded exact
    sum in some scores; at D = 1,040 no sum reaches 2^24."""
    exact = exact_scores(q, b)
    d = q.shape[1]
    if d * 127**2 < 2**24:
        assert exact.max() < 2**24
        return
    acc = np.zeros(exact.shape, np.float32)
    for c in range(0, d, CHUNK):
        acc = (acc + exact_scores(q[:, c:c + CHUNK], b[:, c:c + CHUNK]).astype(np.float32)).astype(np.float32)
    assert exact.min() > 2**24 and (exact % 2 == 1).any()
    assert (acc != exact.astype(np.float32)).sum() > 0.01 * exact.size


def reference(exact, k, row_scale=None):
    """The once-rounded scores (times the row scale, one f32 multiply) and
    their stable top-k: value descending, then index."""
    s = exact.astype(np.float32)
    if row_scale is not None:
        s = (s * row_scale.reshape(1, -1)).astype(np.float32)
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, order, 1), order


def assert_matches_tpu_kernel(tv, ti, jv, ji, ref_next):
    """Values bit for bit; ids equal where a row's top k + 1 values (the
    reference's (k+1)-th beside them) are distinct, else the ids above the
    k-th value as sets (the TPU kernel orders tied rows its own way)."""
    tv, ti, jv, ji = tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji).astype(np.int64)
    np.testing.assert_array_equal(tv, jv)
    full = np.concatenate([tv, ref_next[:, None]], 1)
    tie_free = (full[:, :-1] > full[:, 1:]).all(1)
    np.testing.assert_array_equal(ti[tie_free], ji[tie_free])
    for r in np.flatnonzero(~tie_free):
        assert set(ti[r][tv[r] > tv[r, -1]]) == set(ji[r][jv[r] > jv[r, -1]]), r


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("d", DEPTHS)
def test_plain_k1_matches_pallas_knn(d, form, k):
    rng = np.random.default_rng(d + k)
    q, b = sharp_codes(rng, 64, d), sharp_codes(rng, 1024, d)
    assert_sharp(q, b)
    rs = (0.25 + rng.random(1024)).astype(np.float32) if form == "int8_rows" else None
    trs = None if rs is None else torch.from_numpy(rs)
    tv, ti = exact_knn(torch.from_numpy(q), torch.from_numpy(b), k, row_scale=trs)
    rv, ri = reference(exact_scores(q, b), k + 1, rs)
    np.testing.assert_array_equal(tv.numpy(), rv[:, :k])
    np.testing.assert_array_equal(ti.numpy(), ri[:, :k])
    jv, ji = pallas_knn(jnp.asarray(q), jnp.asarray(b), k, block_q=64, block_m=512, interpret=True,
                        row_scale=None if rs is None else jnp.asarray(rs[:, None]))
    assert_matches_tpu_kernel(tv, ti, jv, ji, rv[:, k])


def _slabs(rng, d):
    """4 slabs of cap 256 (one empty, two ragged), probed out of slot order by
    one 64-query tile; padding slots zero."""
    cap, fill = 256, np.array([256, 200, 0, 131], np.int32)
    bank = sharp_codes(rng, 4 * cap, d)
    bank[(np.arange(4 * cap) % cap) >= np.repeat(fill, cap)] = 0
    return bank, cap, fill, np.array([[2, 0, 3, 1]], np.int32)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("d", DEPTHS)
def test_plain_k2_matches_pallas_ivf_knn(d, form, k):
    rng = np.random.default_rng(2 * d + k)
    q = sharp_codes(rng, 64, d)
    bank, cap, fill, lids = _slabs(rng, d)
    valid = np.flatnonzero((np.arange(4 * cap) % cap) < np.repeat(fill, cap))
    assert_sharp(q, bank[valid])
    rs = (0.25 + rng.random(4 * cap)).astype(np.float32) if form == "int8_rows" else None
    trs = None if rs is None else torch.from_numpy(rs)
    tv, ti = ivf.ivf_search_plain(torch.from_numpy(q), torch.from_numpy(bank), torch.from_numpy(lids),
                                  torch.from_numpy(fill), k, cap=cap, row_scale=trs)
    rv, order = reference(exact_scores(q, bank[valid]), k + 1, None if rs is None else rs[valid])
    np.testing.assert_array_equal(tv.numpy(), rv[:, :k])
    np.testing.assert_array_equal(ti.numpy(), valid[order[:, :k]])
    jv, ji = jivf.pallas_ivf_knn(jnp.asarray(q), jnp.asarray(bank), jnp.asarray(lids), jnp.asarray(fill), k,
                                 cap=cap, block_q=64, interpret=True,
                                 row_scale=None if rs is None else jnp.asarray(rs[:, None]))
    assert_matches_tpu_kernel(tv, ti, jv, ji, rv[:, k])


@pytest.mark.parametrize("d", DEPTHS)
def test_wrappers_take_wide_int8(d):
    """On CPU tensors the K1 and K2 wrappers run the plain version at these
    depths (no launch); on CUDA tensors `route` sends them to the wgmma
    kernel at every depth: its shared memory holds int8 queries up to
    D = 3,072, and past that they stream in the ring (3,088, 3,200)."""
    rng = np.random.default_rng(d)
    q = torch.from_numpy(sharp_codes(rng, 64, d))
    bank, cap, fill, lids = _slabs(rng, d)
    bank, fill, lids = torch.from_numpy(bank), torch.from_numpy(fill), torch.from_numpy(lids)
    rs = 0.25 + torch.rand(bank.shape[0], generator=torch.Generator().manual_seed(d))
    before = (knn_cuda.knn_topk.launches, ivf_cuda.ivf_topk.launches)
    for scale in (None, rs):
        got = knn_cuda.knn_topk(q, bank, 30, valid_rows=900, row_scale=scale)
        want = exact_knn(q, bank, 30, valid_rows=900, row_scale=scale)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        got = ivf_cuda.ivf_topk(q, bank, lids, fill, 30, cap=cap, block_q=64, row_scale=scale)
        want = ivf.ivf_search_plain(q, bank, lids, fill, 30, cap=cap, row_scale=scale)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (knn_cuda.knn_topk.launches, ivf_cuda.ivf_topk.launches) == before
    for prefix in ("knn_topk", "ivf_topk"):
        lib = WgmmaLibrary(prefix)
        assert knn_cuda.route(lib, q, bank, prefix) == "wgmma"
        for depth in (3072, 3088, 3200):
            edge = torch.zeros(1, depth, dtype=torch.int8)
            assert knn_cuda.route(lib, edge, edge, prefix) == "wgmma"
    resident = wgmma_smem.smem_at(wgmma_smem.S8_FORM, d)
    assert (resident > 0) == (d <= 3072) and wgmma_smem.smem(wgmma_smem.S8_FORM, d) > 0


ASYM_DEPTH = 1280


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("form", ["asym", "asym_rows"])
def test_plain_asym_matches_pallas_knn(form, k):
    """K1 (e) and (e)+(d) at D = 1,280, where the card streams the queries:
    the plain version (bf16 queries on int8 codes widened exactly, f32
    sums) against `pallas_knn` in interpret mode on the same inputs, at
    K1's tolerance; and the exact f64 scores' order away from ties."""
    rng = np.random.default_rng(ASYM_DEPTH + k)
    q = torch.from_numpy(rng.normal(size=(64, ASYM_DEPTH)).astype(np.float32)).bfloat16()
    b = rng.integers(-127, 128, size=(1024, ASYM_DEPTH)).astype(np.int8)
    rs = (0.25 + rng.random(1024)).astype(np.float32) if form == "asym_rows" else None
    tv, ti = exact_knn(q, torch.from_numpy(b), k, valid_rows=1000,
                       row_scale=None if rs is None else torch.from_numpy(rs))
    jv, ji = pallas_knn(jnp.asarray(q.float().numpy()).astype(jnp.bfloat16), jnp.asarray(b), k, valid_rows=1000,
                        block_q=64, block_m=512, interpret=True,
                        row_scale=None if rs is None else jnp.asarray(rs[:, None]))
    s = np.ones(1024, np.float32) if rs is None else rs
    tol = 1e-5 * float(np.linalg.norm(q.float().numpy(), axis=1).max()
                       * (np.linalg.norm(b.astype(np.float32), axis=1) * s).max())
    tv, ti, jv, ji = tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji)
    np.testing.assert_allclose(np.sort(tv, 1), np.sort(jv, 1), rtol=0, atol=tol)
    exact = q.double().numpy() @ b[:1000].astype(np.float64).T * s[:1000].astype(np.float64)
    for r in range(tv.shape[0]):
        assert set(ti[r][tv[r] > tv[r, -1] + tol]) == set(ji[r][jv[r] > jv[r, -1] + tol]), r
        np.testing.assert_allclose(tv[r], exact[r, ti[r]], rtol=0, atol=tol)


@pytest.mark.parametrize("strategy", ["gather", "ring"])
@pytest.mark.parametrize("form", FORMS)
def test_two_shards_equal_unsharded(form, strategy):
    """K1 over a 2-shard bank mesh at D = 1,536 (a padded last shard):
    values, ids and labels bit for bit the unsharded search's."""
    rng = np.random.default_rng(5)
    q, b = sharp_codes(rng, 40, 1536), sharp_codes(rng, 601, 1536)
    assert_sharp(q, b)
    qt, bank = torch.from_numpy(q), torch.from_numpy(b)
    labels = torch.from_numpy(rng.random((601, 5)).astype(np.float32))
    rs = torch.from_numpy((0.25 + rng.random(601)).astype(np.float32)) if form == "int8_rows" else None
    v0, i0, l0 = knn_with_labels(qt, bank, labels, 30, valid_rows=590, row_scale=rs)
    mesh = make_mesh((2,), ("bank",), ["cpu", "cpu"])
    bs, ls, _ = shard_bank(bank, labels, mesh)
    fn = sharded_knn_with_labels if strategy == "gather" else ring_knn_with_labels
    v, i, lv = fn(qt, bs, ls, 30, mesh=mesh, valid_rows=590,
                  row_scale=None if rs is None else shard_rows(rs, mesh))
    assert torch.equal(v, v0) and torch.equal(i, i0) and torch.equal(lv, l0)


INPUT, PATCH, K = 32, 4, 5
ENGINE_RUNS = {
    "faiss int8 + reorder": ("faiss", {"use_int8": True, "num_reordering_candidates": 120}),
    "scann int8_rows": ("scann", {"quantization": "int8_rows"}),
    "ivf int8_rows, every leaf": ("ivf", {"quantization": "int8_rows", "num_leaves": 8,
                                          "num_leaves_to_search": 8}),
}


@pytest.fixture(scope="module")
def wide_engine(tmp_path_factory):
    """A VOC fixture and a ViT 1,280 wide (1 block of 16 heads of 80) in both
    packages, the JAX weights carried across."""
    root = str(tmp_path_factory.mktemp("voc_wide") / "voc")
    make_voc_fixture(root, n_train=12, n_val=6, size=(64, 48), colorize=True, seed=3,
                     class_pool=[1, 2, 3, 4, 5])
    jcfg = JConfig(PATCH, 1280, 1, 16, img_size=INPUT)
    params = JViT(jcfg).init(jax.random.PRNGKey(0))
    tvit = ViT(ViTConfig(PATCH, 1280, 1, 16, img_size=INPUT))
    tvit.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return root, (JViT(jcfg), params), tvit


@pytest.mark.parametrize("run", list(ENGINE_RUNS))
def test_wide_engine_matches_jax(wide_engine, run):
    root, jax_model, tvit = wide_engine
    assert tvit.config.head_dim == 80
    nn_method, nn_params = ENGINE_RUNS[run]
    common = dict(d_model=1280, patch_size=PATCH, dataset_name="voc", data_dir=root, batch_size=4,
                  input_size=INPUT, n_neighbours=K, num_workers=0, nn_method=nn_method)
    random.seed(1234)
    t = hbird_tpu_torch.hbird_evaluation(model=tvit, device="cpu", nn_params=dict(nn_params), **common)
    random.seed(1234)
    j = hbird_tpu.hbird_evaluation(model=jax_model, nn_params=dict(nn_params), **common)
    assert abs(t - j) <= 1e-4, (t, j)
