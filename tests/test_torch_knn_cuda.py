"""K1 on the card: the CUDA kernel against its plain version.

Every test here needs a CUDA GPU (marker `cuda`) and skips without one:
the kernel has no CPU mode, and on the CPU the wrapper takes the plain
version, which `test_torch_knn.py` compares with the JAX package. The file
imports neither JAX nor `hbird_tpu`, so it runs on a GPU machine without
them, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_knn_cuda.py

Tolerance: values within 1e-5 · ||q|| · max_i(||b_i|| · s_i) (the same
exact products summed in another order, or for f32 the 3xTF32 products,
~21 bits of each operand; s_i is an int8 row's scale, 1 for float banks
and global int8 codes), for f32, bf16, l2 and the asymmetric forms; index
sets equal on tie-free inputs. Every form runs the wgmma kernel, f32, int8
and asym at every depth (their query chunks streamed in the ring where the
queries do not stay resident: asym past D = 1152), bf16 up to 1536. int8 x int8 scores are exact
integers below 2^24 and the row scale is one f32 multiply, so the int8 and
int8_rows forms equal the plain version bit for bit, values and indices. On
a bank of duplicated rows the kernel's order is value descending, then
index ascending, exactly.
"""

import numpy as np
import pytest
import torch

from hbird_tpu_torch.ops import cuda_build, knn_cuda
from hbird_tpu_torch.ops.knn import exact_knn, l2_bias
from hbird_tpu_torch.ops.quantize import quantize_bank_int8, quantize_queries_int8

pytestmark = pytest.mark.cuda

RTOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(n_q, m, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n_q, d)).astype(np.float32)
    b = rng.normal(size=(m, d)).astype(np.float32)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    return q, b


def _tol(q, b):
    return RTOL * float(np.linalg.norm(q, axis=1).max() * np.linalg.norm(b, axis=1).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 30, 128])
def test_kernel_matches_plain_version(cuda_device, dtype, k):
    q, b = _inputs(300, 5003, 64, seed=5)
    qt = torch.from_numpy(q).to(cuda_device, dtype)
    bt = torch.from_numpy(b).to(cuda_device, dtype)
    before = knn_cuda.knn_topk.launches
    kv, ki = knn_cuda.knn_topk(qt, bt, k, valid_rows=4900)
    pv, pi = exact_knn(qt, bt, k, valid_rows=4900)
    torch.cuda.synchronize()
    assert knn_cuda.knn_topk.launches == before + 1
    assert kv.dtype == torch.float32 and ki.dtype == torch.int64
    assert (kv - pv).abs().max().item() <= _tol(q, b)
    assert torch.equal(torch.sort(ki, 1).values, torch.sort(pi, 1).values)


def test_fewer_valid_rows_than_k(cuda_device):
    q, b = _inputs(70, 300, 64, seed=6)
    qt = torch.from_numpy(q).to(cuda_device, torch.bfloat16)
    bt = torch.from_numpy(b).to(cuda_device, torch.bfloat16)
    kv, ki = knn_cuda.knn_topk(qt, bt, 30, valid_rows=20)
    pv, pi = exact_knn(qt, bt, 30, valid_rows=20)
    torch.cuda.synchronize()
    assert torch.isinf(kv[:, 20:]).all() and (ki[:, 20:] == 0).all()
    assert (kv[:, :20] - pv[:, :20]).abs().max().item() <= _tol(q, b)
    assert torch.equal(torch.sort(ki[:, :20], 1).values, torch.sort(pi[:, :20], 1).values)


def test_duplicated_rows_order_by_lowest_index(cuda_device):
    q, b = _inputs(64, 1000, 64, seed=7)
    bank = torch.from_numpy(np.concatenate([b] * 3)).to(cuda_device, torch.bfloat16)
    qt = torch.from_numpy(q).to(cuda_device, torch.bfloat16)
    kv, ki = knn_cuda.knn_topk(qt, bank, 30)
    torch.cuda.synchronize()
    ordered = (kv[:, :-1] > kv[:, 1:]) | ((kv[:, :-1] == kv[:, 1:]) & (ki[:, :-1] < ki[:, 1:]))
    assert ordered.all()
    # 30 = 10 rows x 3 copies: every kept row keeps all three copies
    rows = torch.sort(ki % 1000, 1).values
    assert torch.equal(rows[:, 0::3], rows[:, 1::3]) and torch.equal(rows[:, 0::3], rows[:, 2::3])


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros((8, 64), device=cuda_device)
    b = torch.zeros((100, 64), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        knn_cuda.knn_topk(q, b.T.contiguous().T, 4)
    with pytest.raises(ValueError, match="divisible by 8"):
        knn_cuda.knn_topk(q[:, :60].contiguous(), b[:, :60].contiguous(), 4)
    with pytest.raises(ValueError, match="on cpu"):
        knn_cuda.knn_topk(q, b.cpu(), 4)
    with pytest.raises(ValueError, match="k must be"):
        knn_cuda.knn_topk(q, b, 129)
    q8, b8 = q.to(torch.int8), b.to(torch.int8)
    with pytest.raises(ValueError, match="divisible by 16"):
        knn_cuda.knn_topk(q8[:, :56].contiguous(), b8[:, :56].contiguous(), 4)
    with pytest.raises(ValueError, match="divisible by 16"):
        knn_cuda.knn_topk(q[:, :56].bfloat16().contiguous(), b8[:, :56].contiguous(), 4)
    with pytest.raises(ValueError, match="l2 requires"):
        knn_cuda.knn_topk(q8, b8, 4, distance="l2")
    with pytest.raises(ValueError, match="row_scale requires"):
        knn_cuda.knn_topk(q, b, 4, row_scale=torch.ones(100, device=cuda_device))


def _int8_inputs(form, n_q, m, d, seed, dev):
    """Codes of a unit-row bank (per row for the *_rows forms) and the
    queries the form takes: int8 codes, or bf16 for the asymmetric forms;
    with the row scales and the value tolerance (0 where bit-exact)."""
    q, b = _inputs(n_q, m, d, seed)
    codes, scale = quantize_bank_int8(torch.from_numpy(b), per_row=form.endswith("rows"))
    rs = scale.reshape(-1) if form.endswith("rows") else None
    if form.startswith("int8"):
        qq, tol = quantize_queries_int8(torch.from_numpy(q))[0], 0.0
    else:
        qq = torch.from_numpy(q).bfloat16()
        s = rs if rs is not None else torch.ones(m)
        tol = RTOL * float(qq.float().norm(dim=1).max() * (codes.float().norm(dim=1) * s).max())
    return qq.to(dev), codes.to(dev), None if rs is None else rs.to(dev), tol


@pytest.mark.parametrize("form", ["int8", "int8_rows", "asym", "asym_rows"])
@pytest.mark.parametrize("k", [1, 30, 120, 128])
@pytest.mark.parametrize("d", [48, 80, 768, 1024])
def test_int8_forms_match_plain_version(cuda_device, form, k, d):
    """K1 (c), (c)+(d), (e) and (e)+(d) at a ragged valid_rows; depths 48
    and 80 end inside a depth chunk, 1,024 is the widest exact int8 depth;
    k = 120 is the `faiss` int8 + reorder path's scan."""
    q, codes, rs, tol = _int8_inputs(form, 300, 5003, d, seed=k + d, dev=cuda_device)
    before = dict(knn_cuda.knn_topk.forms)
    kv, ki = knn_cuda.knn_topk(q, codes, k, valid_rows=4900, row_scale=rs)
    pv, pi = exact_knn(q, codes, k, valid_rows=4900, row_scale=rs)
    torch.cuda.synchronize()
    assert knn_cuda.knn_topk.forms[form] == before.get(form, 0) + 1
    assert bool((ki < 4900).all())
    if tol == 0.0:
        assert torch.equal(kv, pv) and torch.equal(ki, pi)
    else:
        assert (kv - pv).abs().max().item() <= tol
        assert torch.equal(torch.sort(ki, 1).values, torch.sort(pi, 1).values)


@pytest.mark.parametrize("form", ["int8", "int8_rows"])
def test_int8_ties_keep_the_lowest_index(cuda_device, form):
    """Codes in {-1, 0, 1} at D = 32 make integer scores tie many ways,
    within and across bank tiles: the kernel equals the plain version's
    stable order exactly."""
    gen = torch.Generator().manual_seed(9)
    q = torch.randint(-1, 2, (200, 32), generator=gen, dtype=torch.int8)
    codes = torch.randint(-1, 2, (3000, 32), generator=gen, dtype=torch.int8)
    rs = torch.full((3000,), 0.25) if form == "int8_rows" else None
    args = [t.to(cuda_device) if t is not None else None for t in (q, codes, rs)]
    kv, ki = knn_cuda.knn_topk(args[0], args[1], 100, valid_rows=2999, row_scale=args[2])
    pv, pi = exact_knn(args[0], args[1], 100, valid_rows=2999, row_scale=args[2])
    torch.cuda.synchronize()
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 30, 128])
def test_l2_matches_plain_version(cuda_device, dtype, k):
    """K1 (b) on rows of unequal norm (the l2 order differs from the dot
    order); the bias is the wrapper's, the same tensor both see."""
    rng = np.random.default_rng(20 + k)
    q = rng.normal(size=(300, 64)).astype(np.float32)
    b = (rng.normal(size=(5003, 64)) * rng.uniform(0.2, 3.0, (5003, 1))).astype(np.float32)
    qt = torch.from_numpy(q).to(cuda_device, dtype)
    bt = torch.from_numpy(b).to(cuda_device, dtype)
    form = "f32_l2" if dtype == torch.float32 else "l2"
    before = knn_cuda.knn_topk.forms[form]
    kv, ki = knn_cuda.knn_topk(qt, bt, k, valid_rows=4900, distance="l2")
    pv, pi = exact_knn(qt, bt, k, valid_rows=4900, distance="l2")
    torch.cuda.synchronize()
    assert knn_cuda.knn_topk.forms[form] == before + 1
    assert (kv - pv).abs().max().item() <= _tol(q, b)
    assert torch.equal(torch.sort(ki, 1).values, torch.sort(pi, 1).values)


# The forms of the wgmma kernel: bf16 dot and l2, f32 dot and l2 (3xTF32),
# int8 and int8_rows codes, bf16 queries on int8 codes (asym, asym_rows).
WGMMA_FORMS = ["dot", "l2", "f32", "f32_l2", "int8", "int8_rows", "asym", "asym_rows"]
# Every k of the card checks: each S (keys a lane) and its edges (chip_smoke.py).
CHECK_KS = (30, 33, 64, 96, 97, 120, 128)


def _form_args(form, q, b, dev, seed=0):
    """(queries, bank, knn_topk keyword arguments, exact, tol) of `form`
    from float inputs: bf16 for dot and l2, f32 for f32 and f32_l2; for
    the int8 forms the int8 codes of q and of b (per row, with its row
    scales, for *_rows), exact against the plain version; for asym and
    asym_rows the bf16 queries on those codes. Integer-valued inputs keep
    their values as codes (scaled per row by seeded scales for *_rows).
    tol: 1e-5 · ||q|| · max_i(||b_i|| · s_i) of the float inputs, or of
    the bf16 queries and the codes (times their row scales) for asym."""
    q, b = torch.as_tensor(q).float(), torch.as_tensor(b).float()
    if form in ("dot", "l2", "f32", "f32_l2"):
        kw = {"distance": "l2"} if form.endswith("l2") else {}
        dtype = torch.float32 if form.startswith("f32") else torch.bfloat16
        return q.to(dev, dtype), b.to(dev, dtype), kw, False, _tol(q.numpy(), b.numpy())
    rows = form.endswith("_rows")
    if bool((q == q.round()).all() and (b == b.round()).all()):
        qq, codes = q.to(torch.int8), b.to(torch.int8)
        gen = torch.Generator().manual_seed(seed)
        scale = 0.25 + torch.rand(b.shape[0], generator=gen)
    else:
        qq = quantize_queries_int8(q)[0]
        codes, scale = quantize_bank_int8(b, per_row=rows)
    kw = {"row_scale": scale.reshape(-1).to(dev)} if rows else {}
    if form.startswith("int8"):
        return qq.to(dev), codes.to(dev), kw, True, 0.0
    s = scale.reshape(-1) if rows else torch.ones(b.shape[0])
    qb = q.bfloat16()
    tol = RTOL * float(qb.float().norm(dim=1).max() * (codes.float().norm(dim=1) * s).max())
    return qb.to(dev), codes.to(dev), kw, False, tol


def _agree(kv, ki, pv, pi, exact, tol):
    """The kernel's (kv, ki) against the plain version's: bit for bit when
    `exact`, else the -inf slots, the values within `tol` and the index sets."""
    if exact:
        assert torch.equal(kv, pv) and torch.equal(ki, pi)
        return
    finite = torch.isfinite(pv)
    assert torch.equal(torch.isfinite(kv), finite) and (ki[~finite] == 0).all()
    assert (kv - pv).abs().where(finite, torch.zeros_like(kv)).max().item() <= tol
    assert torch.equal(torch.sort(ki, 1).values, torch.sort(pi, 1).values)


@pytest.mark.parametrize("form", WGMMA_FORMS)
@pytest.mark.parametrize("k", [1, 30, 128])
@pytest.mark.parametrize("n_q,m", [(333, 4999), (65, 129), (1, 1000)])
def test_wgmma_ragged_queries_and_bank(cuda_device, n_q, m, k, form):
    """The wgmma kernel (bf16 dot and l2, int8 and int8_rows) with Q and M
    multiples of no tile."""
    rng = np.random.default_rng(n_q + m + k)
    q = rng.normal(size=(n_q, 64)).astype(np.float32)
    b = (rng.normal(size=(m, 64)) * rng.uniform(0.5, 2.0, (m, 1))).astype(np.float32)
    qt, bt, kw, exact, tol = _form_args(form, q, b, cuda_device)
    before = knn_cuda.knn_topk.forms[form]
    kv, ki = knn_cuda.knn_topk(qt, bt, k, **kw)
    pv, pi = exact_knn(qt, bt, k, **kw)
    torch.cuda.synchronize()
    assert knn_cuda.knn_topk.forms[form] == before + 1
    _agree(kv, ki, pv, pi, exact, tol)


def _split_rows(n_q, valid, k):
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return knn_cuda.plan_splits(n_q, valid, n_sm, k)


@pytest.mark.parametrize("form", WGMMA_FORMS)
@pytest.mark.parametrize("where", ["k-1", "tile", "tile+1", "split", "split-1"])
def test_wgmma_valid_rows_at_edges(cuda_device, where, form):
    """valid_rows below k, on a 128-row tile edge and next to it, and on the
    edge of the first bank split the wrapper plans (several splits)."""
    q, b = _inputs(200, 20000, 64, seed=31)
    qt, bt, kw, exact, tol = _form_args(form, q, b, cuda_device)
    split_rows, splits = _split_rows(200, 20000, 30)
    assert splits > 1
    valid = {"k-1": 29, "tile": 1280, "tile+1": 1281, "split": split_rows,
             "split-1": split_rows - 1}[where]
    kv, ki = knn_cuda.knn_topk(qt, bt, 30, valid_rows=valid, **kw)
    pv, pi = exact_knn(qt, bt, 30, valid_rows=valid, **kw)
    torch.cuda.synchronize()
    assert bool((ki < valid).all())
    _agree(kv, ki, pv, pi, exact, tol)


@pytest.mark.parametrize("form", WGMMA_FORMS)
def test_wgmma_copies_in_two_splits_keep_the_lowest_index(cuda_device, form):
    """Two copies of a bank, each in its own split: of a row whose copies
    tie, the lower index is kept first; with k odd the (k+1)/2-th row
    keeps only its first copy. int8 codes may also tie across rows, so
    there the order is held to the plain version's bit for bit, and a
    second copy is kept only with its first."""
    q, b = _inputs(64, 3000, 64, seed=8)
    qt, bt, kw, exact, tol = _form_args(form, q, b, cuda_device)
    bank = torch.cat([bt, bt]).contiguous()
    if "row_scale" in kw:
        kw["row_scale"] = torch.cat([kw["row_scale"], kw["row_scale"]])
    split_rows, splits = _split_rows(64, 6000, 7)
    assert splits > 1 and split_rows <= 3000 + 128
    kv, ki = knn_cuda.knn_topk(qt, bank, 7, **kw)
    torch.cuda.synchronize()
    ordered = (kv[:, :-1] > kv[:, 1:]) | ((kv[:, :-1] == kv[:, 1:]) & (ki[:, :-1] < ki[:, 1:]))
    assert ordered.all()
    if exact:
        pv, pi = exact_knn(qt, bank, 7, **kw)
        assert torch.equal(kv, pv) and torch.equal(ki, pi)
        second = ki >= 3000
        first_kept = ((ki - 3000)[:, :, None] == ki[:, None, :]).any(2)
        assert not (second & ~first_kept).any()
    else:
        assert torch.equal(ki[:, 0::2][:, :4] % 3000, ki[:, 0::2][:, :4])  # first copies lead
        assert torch.equal(ki[:, 1::2] - 3000, ki[:, 0::2][:, :3])  # then their second copies
        assert bool((ki[:, 6] < 3000).all())


@pytest.mark.parametrize("form", WGMMA_FORMS)
@pytest.mark.parametrize("k", [1, 30, 128])
def test_wgmma_bank_of_one_row(cuda_device, k, form):
    q, b = _inputs(70, 1, 64, seed=k)
    qt, bt, kw, exact, tol = _form_args(form, q, b, cuda_device)
    kv, ki = knn_cuda.knn_topk(qt, bt, k, **kw)
    pv, pi = exact_knn(qt, bt, k, **kw)
    torch.cuda.synchronize()
    assert (ki == 0).all() and torch.isinf(kv[:, 1:]).all()
    _agree(kv, ki, pv, pi, exact, tol)


@pytest.mark.parametrize("distance", ["dot_product", "l2"])
@pytest.mark.parametrize("d", [1536, 1664])
def test_bf16_depth_the_queries_must_fit(cuda_device, d, distance):
    """D = 1536 (dinov2_vitg14's width) is the widest whose queries fit the
    wgmma kernel's shared memory (one ring stage per consumer); a wider
    bank (1,664, a converted checkpoint's width) streams its query chunks
    beside the bank chunks on the same kernel. Both run the wgmma kernel,
    hold against the plain version and count as their form."""
    q, b = _inputs(100, 700, d, seed=12)
    qt = torch.from_numpy(q).to(cuda_device, torch.bfloat16)
    bt = torch.from_numpy(b).to(cuda_device, torch.bfloat16)
    lib = cuda_build.load("knn_topk.cu", "knn_topk_launch", knn_cuda._ARGTYPES)
    assert knn_cuda.route(lib, qt, bt) == "wgmma"
    form = "l2" if distance == "l2" else "dot"
    before = knn_cuda.knn_topk.forms[form]
    kv, ki = knn_cuda.knn_topk(qt, bt, 30, distance=distance)
    pv, pi = exact_knn(qt, bt, 30, distance=distance)
    torch.cuda.synchronize()
    assert knn_cuda.knn_topk.forms[form] == before + 1
    assert (kv - pv).abs().max().item() <= _tol(q, b)
    assert torch.equal(torch.sort(ki, 1).values, torch.sort(pi, 1).values)


def _tie_dense_edge(n_q, m, d, k):
    """Integer entries in {-1, 0, 1} (scores exact in any order, tied many
    ways) and a valid_rows at most m that ends the last bank split the
    wrapper plans exactly, with several splits."""
    gen = torch.Generator().manual_seed(k + d)
    q = torch.randint(-1, 2, (n_q, d), generator=gen).float()
    b = torch.randint(-1, 2, (m, d), generator=gen).float()
    for tiles in range(m // 128, 0, -1):
        split_rows, splits = _split_rows(n_q, tiles * 128, k)
        if splits > 1 and (tiles * 128) % split_rows == 0:
            return q, b, tiles * 128, split_rows, splits
    raise AssertionError("no valid_rows on a split edge")


@pytest.mark.parametrize("form", WGMMA_FORMS)
@pytest.mark.parametrize("k", [1, 30, 120, 128])
def test_wgmma_ties_across_splits_bit_for_bit(cuda_device, k, form):
    """The split kernel's pruning under dense ties: Q = 10,000 queries (more
    64-query tiles than SMs, so items of several splits run at once) on a
    bank of integer entries in {-1, 0, 1}, whose scores, l2 biases and
    scaled int8 scores are exact, so the kernel must equal exact_knn bit for
    bit, values and indices; valid_rows on a split edge and one row past a
    tile edge."""
    q, b, edge, split_rows, splits = _tie_dense_edge(10000, 40960, 96, k)
    assert -(-10000 // 64) > torch.cuda.get_device_properties(0).multi_processor_count
    qt, bt, kw, _, _ = _form_args(form, q, b, cuda_device, seed=k)
    for valid in (edge, edge - 127):
        kv, ki = knn_cuda.knn_topk(qt, bt, k, valid_rows=valid, **kw)
        pv, pi = exact_knn(qt, bt, k, valid_rows=valid, **kw)
        torch.cuda.synchronize()
        assert torch.equal(kv, pv) and torch.equal(ki, pi), (valid, split_rows, splits)


@pytest.mark.parametrize("form", WGMMA_FORMS)
def test_wgmma_cuda_tensors_never_reach_the_plain_version(cuda_device, monkeypatch, form):
    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(knn_cuda, "exact_knn", plain)
    q, b = _inputs(100, 900, 64, seed=13)
    qt, bt, kw, _, _ = _form_args(form, q, b, cuda_device)
    before = knn_cuda.knn_topk.forms[form]
    knn_cuda.knn_topk(qt, bt, 5, **kw)
    torch.cuda.synchronize()
    assert knn_cuda.knn_topk.forms[form] == before + 1


@pytest.mark.parametrize("form", WGMMA_FORMS)
@pytest.mark.parametrize("k", [33, 64, 96, 97])
def test_wgmma_select_at_every_k_bit_for_bit(cuda_device, k, form):
    """The batched select at S = 2, 3 and 4 keys a lane beside the k of the
    test above: Q = 10,000 tie-dense queries (several splits in flight) on
    integer entries in {-1, 0, 1}, valid_rows on a split edge and one row
    past a tile edge, bit for bit against exact_knn."""
    q, b, edge, split_rows, splits = _tie_dense_edge(10000, 40960, 96, k)
    qt, bt, kw, _, _ = _form_args(form, q, b, cuda_device, seed=k)
    for valid in (edge, edge - 127):
        kv, ki = knn_cuda.knn_topk(qt, bt, k, valid_rows=valid, **kw)
        pv, pi = exact_knn(qt, bt, k, valid_rows=valid, **kw)
        torch.cuda.synchronize()
        assert torch.equal(kv, pv) and torch.equal(ki, pi), (valid, split_rows, splits)


@pytest.mark.parametrize("form", WGMMA_FORMS)
@pytest.mark.parametrize("k", [33, 64, 96, 97, 120])
@pytest.mark.parametrize("n_q,m", [(333, 4999), (65, 129), (1, 1000)])
def test_wgmma_ragged_at_every_k(cuda_device, n_q, m, k, form):
    """Q and M multiples of no tile at the select's larger sizes."""
    rng = np.random.default_rng(n_q + m + k)
    q = rng.normal(size=(n_q, 64)).astype(np.float32)
    b = (rng.normal(size=(m, 64)) * rng.uniform(0.5, 2.0, (m, 1))).astype(np.float32)
    qt, bt, kw, exact, tol = _form_args(form, q, b, cuda_device)
    kv, ki = knn_cuda.knn_topk(qt, bt, k, **kw)
    pv, pi = exact_knn(qt, bt, k, **kw)
    torch.cuda.synchronize()
    _agree(kv, ki, pv, pi, exact, tol)


@pytest.mark.parametrize("form", ["dot", "int8_rows"])
@pytest.mark.parametrize("k", [30, 128])
def test_wgmma_every_tile_beats_the_set(cuda_device, k, form):
    """Scores that rise along the bank (rows s_i times one vector, s_i
    increasing): every score of every tile beats its set's minimum, so the
    candidate buffers take a whole tile at a time and merge at every tile;
    exact scores, bit for bit against exact_knn."""
    m = 20000
    scale = torch.linspace(0.5, 2.0, m)
    if form == "dot":
        q = torch.ones(300, 64, device=cuda_device, dtype=torch.bfloat16)
        b = (torch.arange(1, m + 1)[:, None] * torch.ones(1, 64)).to(cuda_device, torch.bfloat16)
        kw = {}
    else:
        q = torch.ones(300, 64, device=cuda_device, dtype=torch.int8)
        b = torch.ones(m, 64, device=cuda_device, dtype=torch.int8)
        kw = {"row_scale": scale.to(cuda_device)}
    kv, ki = knn_cuda.knn_topk(q, b, k, **kw)
    pv, pi = exact_knn(q, b, k, **kw)
    torch.cuda.synchronize()
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


NEW_FORMS = ["f32", "f32_l2", "asym", "asym_rows"]


def _agree_away_from_ties(kv, ki, pv, pi, k, tol):
    """The kernel's (kv, ki) against the plain version's run with k + 1:
    the -inf slots, the values within `tol`, and the index sets equal
    except where the k-th and (k+1)-th plain scores lie within 2 · tol
    (K1's card rule, chip_smoke.py): these inputs are random, not tie-free,
    and at k = 120 of 5,003 rows neighbouring scores come close."""
    finite = torch.isfinite(pv[:, :k])
    assert torch.equal(torch.isfinite(kv), finite) and (ki[~finite] == 0).all()
    assert (kv - pv[:, :k]).abs().where(finite, torch.zeros_like(kv)).max().item() <= tol
    same = (torch.sort(ki, 1).values == torch.sort(pi[:, :k], 1).values).all(1)
    ambiguous = finite[:, -1] & ((pv[:, k - 1] - pv[:, k]) <= 2 * tol)
    assert bool((same | ambiguous).all())


@pytest.mark.parametrize("form", NEW_FORMS)
@pytest.mark.parametrize("k", CHECK_KS)
@pytest.mark.parametrize("d", [768, 784])
def test_f32_and_asym_on_wgmma_at_every_k(cuda_device, d, k, form):
    """K1 f32 (3xTF32) and asym(_rows) (codes widened in shared memory) on
    the wgmma kernel at every k of CHECK_KS, at D = 768 and at 784 (half a
    chunk past a multiple of 32 f32 and of 64 bf16: zero-filled depth
    scores 0), with valid_rows = 0, 1, M - 1 and a ragged cut, on rows of
    unequal norm (the l2 and dot orders differ); index sets held away from
    ties at the k-th score."""
    rng = np.random.default_rng(k + d)
    q = rng.normal(size=(300, d)).astype(np.float32)
    b = (rng.normal(size=(5003, d)) * rng.uniform(0.2, 3.0, (5003, 1)) / np.sqrt(d)).astype(np.float32)
    qt, bt, kw, _, tol = _form_args(form, q, b, cuda_device)
    lib = cuda_build.load("knn_topk.cu", "knn_topk_launch", knn_cuda._ARGTYPES)
    assert knn_cuda.route(lib, qt, bt) == "wgmma"
    for valid in (0, 1, 5002, 4900):
        before = knn_cuda.knn_topk.forms[form]
        kv, ki = knn_cuda.knn_topk(qt, bt, k, valid_rows=valid, **kw)
        pv, pi = exact_knn(qt, bt, k + 1, valid_rows=valid, **kw)
        torch.cuda.synchronize()
        assert knn_cuda.knn_topk.forms[form] == before + 1
        assert bool((ki < max(valid, 1)).all())
        _agree_away_from_ties(kv, ki, pv, pi, k, tol)


@pytest.mark.parametrize("form", ["asym", "asym_rows"])
@pytest.mark.parametrize("d", [1152, 1168, 1536])
def test_asym_depth_the_queries_must_fit(cuda_device, d, form):
    """asym keeps two widened tiles per consumer beside its bf16 queries:
    D = 1152 is the widest whose queries stay resident in the wgmma
    kernel's shared memory; at 1,168 and 1,536 (dinov2_vitg14's width) the
    same kernel streams each query chunk beside its codes (a smaller
    request, chosen by shape). Both hold against the plain version and
    count as their form. f32 keeps no queries resident: every depth runs
    the wgmma kernel."""
    q, b = _inputs(100, 700, d, seed=d)
    qt, bt, kw, _, tol = _form_args(form, q, b, cuda_device)
    lib = cuda_build.load("knn_topk.cu", "knn_topk_launch", knn_cuda._ARGTYPES)
    assert knn_cuda.route(lib, qt, bt) == "wgmma"
    resident = knn_cuda.wgmma_smem(lib, "knn_topk", 1152, 3)
    assert (knn_cuda.wgmma_smem(lib, "knn_topk", d, 3) == resident) == (d <= 1152)
    assert knn_cuda.route(lib, qt.float(), qt.float()) == "wgmma"
    before = knn_cuda.knn_topk.forms[form]
    kv, ki = knn_cuda.knn_topk(qt, bt, 30, **kw)
    pv, pi = exact_knn(qt, bt, 30, **kw)
    torch.cuda.synchronize()
    assert knn_cuda.knn_topk.forms[form] == before + 1
    _agree(kv, ki, pv, pi, False, tol)
