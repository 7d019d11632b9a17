"""K2 on the card: the probed-leaf CUDA kernel against its plain version.

Every test here needs a CUDA GPU (marker `cuda`) and skips without one:
the kernel has no CPU mode, and on the CPU the wrapper takes the plain
version (`ops/ivf.py::ivf_search_plain`), which `test_torch_ivf.py`
compares with the JAX package. The file imports neither JAX nor
`hbird_tpu`, so it runs on a GPU machine without them, from the
repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_ivf_cuda.py

Tolerance: values within 1e-5 · ||q|| · max_i(||b_i|| · s_i) (the same
exact products summed in another order; s_i is an int8 slot's scale, 1 for
float slabs and global int8 codes), for f32, bf16 and the asymmetric forms;
index sets equal on tie-free inputs. int8 x int8 scores are exact integers
and the row scale one f32 multiply, so the int8 forms equal the plain
version bit for bit, values and slots. On slabs of duplicated rows the
kernel's order is value descending, then slot ascending, exactly.
"""

import numpy as np
import pytest
import torch

from hbird_tpu_torch.ops import cuda_build, ivf, ivf_cuda, knn_cuda
from hbird_tpu_torch.ops.quantize import quantize_bank_int8, quantize_queries_int8

pytestmark = pytest.mark.cuda

RTOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K2 kernel has no CPU mode")
    return torch.device("cuda")


def _tree(n_slabs, cap, d, n_tiles, n_probe, block_q, seed, fill=None):
    """Random unit-norm slabs (padding rows zero), queries and probe lists."""
    rng = np.random.default_rng(seed)
    valid = rng.integers(0, cap + 1, n_slabs) if fill is None else np.asarray(fill)
    bank = rng.normal(size=(n_slabs * cap, d)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    bank[(np.arange(n_slabs * cap) % cap) >= np.repeat(valid, cap)] = 0.0
    q = rng.normal(size=(n_tiles * block_q, d)).astype(np.float32)
    lids = np.stack([rng.choice(n_slabs, n_probe, replace=False) for _ in range(n_tiles)])
    return q, bank, lids.astype(np.int32), valid.astype(np.int32)


def _run(dev, dtype, q, bank, lids, valid, k, cap, block_q):
    qt = torch.from_numpy(q).to(dev, dtype)
    bt = torch.from_numpy(bank).to(dev, dtype)
    lt, vt = torch.from_numpy(lids).to(dev), torch.from_numpy(valid).to(dev)
    before = ivf_cuda.ivf_topk.launches
    kv, ki = ivf_cuda.ivf_topk(qt, bt, lt, vt, k, cap=cap, block_q=block_q)
    pv, pi = ivf.ivf_search_plain(qt, bt, lt, vt, k, cap=cap)
    torch.cuda.synchronize()
    assert ivf_cuda.ivf_topk.launches == before + 1
    assert kv.dtype == torch.float32 and ki.dtype == torch.int64
    return kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu()


def _assert_agree(kv, ki, pv, pi, q, bank):
    tol = RTOL * float(np.linalg.norm(q, axis=1).max())
    finite = torch.isfinite(pv)
    assert torch.equal(torch.isfinite(kv), finite)
    assert (ki[~finite] == 0).all()
    assert ((kv - pv).abs()[finite] <= tol).all()
    assert torch.equal(torch.sort(ki, 1).values, torch.sort(pi, 1).values)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 30, 128])
@pytest.mark.parametrize("block_q", [64, 128, 256])
def test_kernel_matches_plain_version(cuda_device, dtype, k, block_q):
    cap = 384
    q, bank, lids, valid = _tree(12, cap, 64, 3, 5, block_q, seed=k + block_q)
    valid[lids[0, 0]] = 0  # an empty probed slab
    valid[lids[1, 0]] = 7  # a probed slab with fewer rows than k
    out = _run(cuda_device, dtype, q, bank, lids, valid, k, cap, block_q)
    _assert_agree(*out, q, bank)


@pytest.mark.parametrize("n_probe", [1, 12], ids=["one", "all"])
def test_probe_one_or_every_slab(cuda_device, n_probe):
    cap = 256
    q, bank, lids, valid = _tree(12, cap, 64, 4, n_probe, 128, seed=n_probe)
    out = _run(cuda_device, torch.bfloat16, q, bank, lids, valid, 30, cap, 128)
    _assert_agree(*out, q, bank)


def test_empty_probes_give_the_unfilled_slots(cuda_device):
    cap = 256
    q, bank, lids, valid = _tree(4, cap, 64, 2, 2, 64, seed=3, fill=[0, 0, 5, 0])
    lids[0] = [0, 1]  # tile 0: no valid row at all
    lids[1] = [3, 2]  # tile 1: 5 valid rows for k = 8
    kv, ki, pv, pi = _run(cuda_device, torch.float32, q, bank, lids, valid, 8, cap, 64)
    assert torch.isinf(kv[:64]).all() and (ki[:64] == 0).all()
    assert torch.isfinite(kv[64:, :5]).all() and torch.isinf(kv[64:, 5:]).all()
    assert ((ki[64:, :5] >= 2 * cap) & (ki[64:, :5] < 2 * cap + 5)).all()
    _assert_agree(kv, ki, pv, pi, q, bank)


def test_duplicated_rows_order_by_lowest_slot(cuda_device):
    """Every slab holds the same 100 rows: each score ties across slabs, so
    the order is value descending, then slot ascending, exactly."""
    cap, d = 128, 64
    rng = np.random.default_rng(7)
    base = rng.normal(size=(100, d)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    bank = np.zeros((3 * cap, d), np.float32)
    for s in range(3):
        bank[s * cap : s * cap + 100] = base
    q = base[:64]
    lids = np.array([[2, 0, 1]], np.int32)
    valid = np.full(3, 100, np.int32)
    kv, ki, pv, pi = _run(cuda_device, torch.bfloat16, q, bank, lids, valid, 30, cap, 64)
    assert torch.equal(ki, pi)
    assert (kv - pv).abs().max().item() <= RTOL * float(np.linalg.norm(q, axis=1).max())
    ordered = (kv[:, :-1] > kv[:, 1:]) | ((kv[:, :-1] == kv[:, 1:]) & (ki[:, :-1] < ki[:, 1:]))
    assert ordered.all()
    rows = torch.sort(ki % cap, 1).values  # 30 = 10 rows x 3 copies
    assert torch.equal(rows[:, 0::3], rows[:, 1::3]) and torch.equal(rows[:, 0::3], rows[:, 2::3])


@pytest.mark.parametrize("probe_mode", ["tile", "query"])
def test_search_on_the_card_matches_the_cpu(cuda_device, probe_mode):
    """ivf_search end to end (grouping, K2, per-query dedup) on the card
    and on the CPU (the plain version)."""
    rng = np.random.default_rng(11)
    centres = rng.normal(size=(8, 64)).astype(np.float32)
    rows = centres[rng.integers(0, 8, 3000)] + 0.3 * rng.normal(size=(3000, 64)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    n_leaves, cap = ivf.tree_layout(3000, 8)
    cent = torch.from_numpy(centres / np.linalg.norm(centres, axis=1, keepdims=True))
    choices, scores = ivf.assign_leaves(torch.from_numpy(rows), cent, return_scores=True)
    slots, fill = ivf.balanced_layout(choices, n_leaves, cap, scores=scores)
    bank, _, _ = ivf.build_ivf_arrays(torch.from_numpy(rows), None, slots, n_leaves, cap)
    lv = torch.from_numpy(fill.astype(np.int32))
    q = torch.from_numpy(rows[:500] + 0.05 * rng.normal(size=(500, 64)).astype(np.float32))
    args = dict(cap=cap, n_probe=2, block_q=128, probe_mode=probe_mode)
    cv, ci = ivf.ivf_search(q, bank, cent, lv, 30, **args)
    before = ivf_cuda.ivf_topk.launches
    gv, gi = ivf.ivf_search(q.to(cuda_device), bank.to(cuda_device), cent.to(cuda_device),
                            lv.to(cuda_device), 30, **args)
    torch.cuda.synchronize()
    assert ivf_cuda.ivf_topk.launches == before + 1
    tol = RTOL * float(q.norm(dim=1).max())
    assert (gv.cpu() - cv).abs().max().item() <= tol
    assert torch.equal(torch.sort(gi.cpu(), 1).values, torch.sort(ci, 1).values)


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros((128, 64), device=cuda_device)
    b = torch.zeros((512, 64), device=cuda_device)
    lids = torch.zeros((2, 1), dtype=torch.int32, device=cuda_device)
    lv = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 64"):
        ivf_cuda.ivf_topk(q, b, torch.zeros((4, 1), dtype=torch.int32, device=cuda_device),
                          lv, 4, cap=256, block_q=32)
    with pytest.raises(ValueError, match="contiguous"):
        ivf_cuda.ivf_topk(q, b.T.contiguous().T, lids, lv, 4, cap=256, block_q=64)
    with pytest.raises(ValueError, match="divisible by 8"):
        ivf_cuda.ivf_topk(q[:, :60].contiguous(), b[:, :60].contiguous(), lids, lv, 4,
                          cap=256, block_q=64)
    with pytest.raises(ValueError, match="on cpu"):
        ivf_cuda.ivf_topk(q, b.cpu(), lids, lv, 4, cap=256, block_q=64)
    with pytest.raises(ValueError, match="must be f32/f32"):
        ivf_cuda.ivf_topk(q.to(torch.int8), b, lids, lv, 4, cap=256, block_q=64)
    with pytest.raises(ValueError, match="row_scale requires"):
        ivf_cuda.ivf_topk(q, b, lids, lv, 4, cap=256, block_q=64,
                          row_scale=torch.ones(512, device=cuda_device))
    q8, b8 = q.to(torch.int8), b.to(torch.int8)
    with pytest.raises(ValueError, match="divisible by 16"):
        ivf_cuda.ivf_topk(q8[:, :56].contiguous(), b8[:, :56].contiguous(), lids, lv, 4,
                          cap=256, block_q=64)


def _int8_tree(form, d, block_q, n_probe, seed, dev):
    """_tree's slabs as int8 codes (per slot for the *_rows forms, padding
    slots scale 0) under the queries the form takes; with the value
    tolerance (0 where bit-exact)."""
    cap = 384
    q, bank, lids, valid = _tree(12, cap, d, 3, n_probe, block_q, seed=seed)
    valid[lids[0, 0]] = 0
    valid[lids[1, 0]] = 7
    codes, scale = quantize_bank_int8(torch.from_numpy(bank), per_row=form.endswith("rows"))
    rs = None
    if form.endswith("rows"):
        rs = torch.where(torch.from_numpy(bank).abs().amax(1, keepdim=True) > 0, scale, 0.0)
        rs = rs.reshape(-1)
    if form.startswith("int8"):
        qq, tol = quantize_queries_int8(torch.from_numpy(q))[0], 0.0
    else:
        qq = torch.from_numpy(q).bfloat16()
        s = rs if rs is not None else torch.ones(codes.shape[0])
        tol = RTOL * float(qq.float().norm(dim=1).max() * (codes.float().norm(dim=1) * s).max())
    put = lambda t: None if t is None else t.to(dev)
    return (put(qq), put(codes), put(torch.from_numpy(lids)), put(torch.from_numpy(valid)),
            put(rs), cap, tol)


@pytest.mark.parametrize("form", ["int8", "int8_rows", "asym", "asym_rows"])
@pytest.mark.parametrize("k", [1, 30, 128])
@pytest.mark.parametrize("block_q, n_probe, d", [(64, 1, 48), (128, 5, 80), (256, 12, 768)])
def test_int8_forms_match_plain_version(cuda_device, form, k, block_q, n_probe, d):
    """K2's int8 forms, with an empty probed slab and one with fewer rows
    than k; depths 48 and 80 end inside a staged depth chunk."""
    q, codes, lids, lv, rs, cap, tol = _int8_tree(form, d, block_q, n_probe, k + d, cuda_device)
    before = ivf_cuda.ivf_topk.forms[form]
    kv, ki = ivf_cuda.ivf_topk(q, codes, lids, lv, k, cap=cap, block_q=block_q, row_scale=rs)
    pv, pi = ivf.ivf_search_plain(q, codes, lids, lv, k, cap=cap, row_scale=rs)
    torch.cuda.synchronize()
    assert ivf_cuda.ivf_topk.forms[form] == before + 1
    if tol == 0.0:
        assert torch.equal(kv, pv) and torch.equal(ki, pi)
    else:
        finite = torch.isfinite(pv)
        assert torch.equal(torch.isfinite(kv), finite)
        assert ((kv - pv).abs()[finite] <= tol).all()
        assert torch.equal(torch.sort(ki, 1).values, torch.sort(pi, 1).values)


@pytest.mark.parametrize("form", ["int8", "int8_rows"])
def test_int8_ties_across_slabs_order_by_lowest_slot(cuda_device, form):
    """Codes in {-1, 0, 1} tie many ways, and the slabs are probed out of
    slot order (2, 0, 1): an equal score in a later slab carries a lower
    slot. The kernel equals the plain version's stable order exactly."""
    cap = 256
    gen = torch.Generator().manual_seed(5)
    codes = torch.randint(-1, 2, (3 * cap, 32), generator=gen, dtype=torch.int8)
    q = torch.randint(-1, 2, (128, 32), generator=gen, dtype=torch.int8)
    lids = torch.tensor([[2, 0, 1], [1, 2, 0]], dtype=torch.int32)
    lv = torch.tensor([200, 256, 131], dtype=torch.int32)
    rs = torch.full((3 * cap,), 0.5) if form == "int8_rows" else None
    args = [None if t is None else t.to(cuda_device) for t in (q, codes, lids, lv, rs)]
    kv, ki = ivf_cuda.ivf_topk(*args[:4], 100, cap=cap, block_q=64, row_scale=args[4])
    pv, pi = ivf.ivf_search_plain(*args[:4], 100, cap=cap, row_scale=args[4])
    torch.cuda.synchronize()
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


# The forms that run the wgmma kernel over probe splits.
WGMMA_FORMS = ["bf16", "asym", "asym_rows", "int8", "int8_rows"]


def _wgmma_tree(form, k, dev):
    """A tree of 40 slabs (cap 384, D = 768) with ragged leaf_valid, an empty
    slab, one with fewer rows than k, one filled to a tile edge and one id
    out of range in the probe lists; 44 tiles of 256 queries, 24 probes
    each (176 items of 64 queries: three probe splits fill the SMs): the form's queries and
    bank, the row scales (padding slots 0) and the value tolerance (0 where
    bit-exact)."""
    cap, n_slabs, block_q, n_probe = 384, 40, 256, 24
    rng = np.random.default_rng(k)
    fill = rng.integers(1, cap + 1, n_slabs)
    fill[:4] = [0, 9, 256, cap]
    q, bank, lids, valid = _tree(n_slabs, cap, 768, 44, n_probe, block_q, seed=k, fill=fill)
    lids[::3, 5] = n_slabs + 3  # out of range: contributes nothing
    for t in range(1, 44, 3):  # the edge slabs, each once
        lids[t] = np.concatenate([[0, 1, 2, 3], rng.choice(np.arange(4, n_slabs), n_probe - 4, replace=False)])
    bt = torch.from_numpy(bank)
    rs = None
    if form == "bf16":
        qq, bank_t = torch.from_numpy(q).bfloat16(), bt.bfloat16()
        tol = RTOL * float(np.linalg.norm(q, axis=1).max())
    else:
        bank_t, scale = quantize_bank_int8(bt, per_row=form.endswith("rows"))
        if form.endswith("rows"):
            rs = torch.where(bt.abs().amax(1, keepdim=True) > 0, scale, 0.0).reshape(-1)
        if form.startswith("int8"):
            qq, tol = quantize_queries_int8(torch.from_numpy(q))[0], 0.0
        else:
            qq = torch.from_numpy(q).bfloat16()
            s = rs if rs is not None else torch.ones(bank_t.shape[0])
            tol = RTOL * float(qq.float().norm(dim=1).max() * (bank_t.float().norm(dim=1) * s).max())
    put = lambda t: None if t is None else t.to(dev)
    return (put(qq), put(bank_t), put(torch.from_numpy(lids)), put(torch.from_numpy(valid)),
            put(rs), cap, block_q, tol)


@pytest.mark.parametrize("form", WGMMA_FORMS)
@pytest.mark.parametrize("k", [1, 30, 64, 120, 128])
def test_wgmma_forms_over_probe_splits(cuda_device, form, k):
    """K2's wgmma forms with empty, out-of-range, partly valid and
    tile-edge slabs, several probe splits in flight: bit for bit for int8
    and int8_rows; otherwise values within the tolerance and equal slot
    sets away from ties at the k-th score (the chip_smoke.py rule)."""
    q, bank, lids, lv, rs, cap, block_q, tol = _wgmma_tree(form, k, cuda_device)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    assert ivf_cuda.plan_probe_splits(q.shape[0], lids.shape[1], n_sm, k) > 1
    before = ivf_cuda.ivf_topk.forms[form if form != "bf16" else "dot"]
    kv, ki = ivf_cuda.ivf_topk(q, bank, lids, lv, k, cap=cap, block_q=block_q, row_scale=rs)
    plain_lids = torch.where(lids < lv.shape[0], lids, 0)  # slab 0 is empty
    pv, pi = ivf.ivf_search_plain(q, bank, plain_lids, lv, k + 1, cap=cap, row_scale=rs)
    torch.cuda.synchronize()
    assert ivf_cuda.ivf_topk.forms[form if form != "bf16" else "dot"] == before + 1
    nxt = pv[:, k]
    pv, pi = pv[:, :k], pi[:, :k]
    if tol == 0.0:
        assert torch.equal(kv, pv) and torch.equal(ki, pi)
    else:
        finite = torch.isfinite(pv)
        assert torch.equal(torch.isfinite(kv), finite) and (ki[~finite] == 0).all()
        assert ((kv - pv).abs()[finite] <= tol).all()
        # equal slot sets, except where the k-th and (k+1)-th plain scores lie
        # within twice the tolerance (the sums run in another order)
        same = (torch.sort(ki, 1).values == torch.sort(pi, 1).values).all(1)
        assert (same | (pv[:, -1] - nxt <= 2 * tol)).all()


def _f32_tree(k, d, dev):
    """An f32 tree of 40 slabs of cap 264 (not a multiple of 128: a slab's
    second tile box runs into the next slab's rows) at depth d, rows of
    norms 0.2-3.0 (real f32 values: the split's small parts are not 0),
    ragged leaf_valid with an empty slab, one of 5 rows, one cut at 128 and
    a full one, and an id out of range in every third tile's probe list;
    44 tiles of 256 queries, 24 probes each."""
    cap, n_slabs, block_q, n_probe = 264, 40, 256, 24
    rng = np.random.default_rng(100 + k + d)
    fill = rng.integers(1, cap + 1, n_slabs)
    fill[:4] = [0, 5, 128, cap]
    q, bank, lids, valid = _tree(n_slabs, cap, d, 44, n_probe, block_q, seed=k + d, fill=fill)
    bank *= rng.uniform(0.2, 3.0, (n_slabs * cap, 1)).astype(np.float32)
    lids[::3, 5] = n_slabs + 3  # out of range: contributes nothing
    for t in range(1, 44, 3):  # the edge slabs, each once
        lids[t] = np.concatenate([[3, 1, 0, 2], rng.choice(np.arange(4, n_slabs), n_probe - 4, replace=False)])
    tol = RTOL * float(np.linalg.norm(q, axis=1).max() * np.linalg.norm(bank, axis=1).max())
    put = lambda x: torch.from_numpy(x).to(dev)
    return put(q), put(bank), put(lids), put(valid), cap, block_q, tol


@pytest.mark.parametrize("d", [768, 72])
@pytest.mark.parametrize("k", [1, 30, 33, 64, 97, 120, 128])
def test_f32_runs_the_wgmma_kernel_over_probe_splits(cuda_device, k, d):
    """K2 f32 (3xTF32 on the wgmma kernel) at every select size and its
    edges, D = 768 and D = 72 (a partial 32-deep chunk), with empty,
    5-row, tile-edge and out-of-range slabs and several probe splits in
    flight: values within the tolerance, slot sets equal away from ties at
    the k-th score, every slot in its tile's probed valid rows."""
    q, bank, lids, lv, cap, block_q, tol = _f32_tree(k, d, cuda_device)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    assert ivf_cuda.plan_probe_splits(q.shape[0], lids.shape[1], n_sm, k) > 1
    lib = cuda_build.load("ivf_topk.cu", "ivf_topk_launch", ivf_cuda._ARGTYPES)
    assert knn_cuda.route(lib, q, bank, "ivf_topk") == "wgmma"
    before = ivf_cuda.ivf_topk.forms["f32"]
    kv, ki = ivf_cuda.ivf_topk(q, bank, lids, lv, k, cap=cap, block_q=block_q)
    plain_lids = torch.where(lids < lv.shape[0], lids, 0)  # slab 0 is empty
    pv, pi = ivf.ivf_search_plain(q, bank, plain_lids, lv, k + 1, cap=cap)
    torch.cuda.synchronize()
    assert ivf_cuda.ivf_topk.forms["f32"] == before + 1
    nxt = pv[:, k]
    pv, pi = pv[:, :k], pi[:, :k]
    finite = torch.isfinite(pv)
    assert torch.equal(torch.isfinite(kv), finite) and (ki[~finite] == 0).all()
    assert ((kv - pv).abs()[finite] <= tol).all()
    same = (torch.sort(ki, 1).values == torch.sort(pi, 1).values).all(1)
    assert (same | (pv[:, -1] - nxt <= 2 * tol)).all()
    slab = ki // cap
    tile_lids = plain_lids.long().repeat_interleave(block_q, 0)
    assert ((tile_lids[:, :, None] == slab[:, None, :]).any(1) & (ki % cap < lv.long()[slab]) | ~finite).all()


@pytest.mark.parametrize("splits", [1, 2, 5])
@pytest.mark.parametrize("form", ["bf16", "asym_rows"])
def test_wgmma_result_does_not_depend_on_the_probe_splits(cuda_device, monkeypatch, form, splits):
    """The same call with the probe lists cut 1, 2 or 5 ways: the same
    values and slots (the keys are unique, so the merge is exact)."""
    q, bank, lids, lv, rs, cap, block_q, _ = _wgmma_tree(form, 30, cuda_device)
    want = ivf_cuda.ivf_topk(q, bank, lids, lv, 30, cap=cap, block_q=block_q, row_scale=rs)
    monkeypatch.setattr(ivf_cuda, "plan_probe_splits", lambda *args: splits)
    got = ivf_cuda.ivf_topk(q, bank, lids, lv, 30, cap=cap, block_q=block_q, row_scale=rs)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
