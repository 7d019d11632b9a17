"""K2 on the card: the probed-leaf CUDA kernel against its plain version.

Every test here needs a CUDA GPU (marker `cuda`) and skips without one:
the kernel has no CPU mode, and on the CPU the wrapper takes the plain
version (`ops/ivf.py::ivf_search_plain`), which `test_torch_ivf.py`
compares with the JAX package. The file imports neither JAX nor
`hbird_tpu`, so it runs on a GPU machine without them, from the
repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_ivf_cuda.py

Tolerance: values within 1e-5 · ||q|| · max||b|| (the same exact products
summed in another order); index sets equal on tie-free inputs; on slabs of
duplicated rows the kernel's order is value descending, then slot
ascending, exactly.
"""

import numpy as np
import pytest
import torch

from hbird_tpu_torch.ops import ivf, ivf_cuda

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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ivf_cuda.ivf_topk(q.to(torch.int8), b.to(torch.int8), lids, lv, 4, cap=256, block_q=64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ivf_cuda.ivf_topk(q, b, lids, lv, 4, cap=256, block_q=64, row_scale=torch.ones(512))
