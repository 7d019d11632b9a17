"""The bank-sharded search on the card: 4 shards on one card against
unsharded K1, and the leaf-sharded tree against the unmeshed tree (K2).

Every test needs a CUDA GPU (marker `cuda`) and skips without one; the
file imports neither JAX nor `hbird_tpu`. From the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_parallel_cuda.py

The shards share the card (a port mesh may repeat a device). Checks:
- without reorder, int8_rows (k = 30) equals unsharded K1 bit for bit,
  values and ids; the float forms (bf16 dot, l2) keep K1's tolerance,
  1e-5·||q||·max||b||, with ids equal on tie-free inputs; labels equal;
- with reorder (int8 codes, 120 candidates), each shard reorders its own
  candidates before the merge, so the pool holds the unsharded one: every
  id re-scores to its value, and the sorted values are at least the
  unsharded run's, position by position, within the tolerance;
- K1 launches 4 times a call (gather) and 16 (ring), in the form asked for;
- the tree built over 4 shards (parallel/sharded_ivf.py): the host layout
  is the unmeshed build exactly (centroids, slots, perm, slabs); the device
  layout places every row in the same leaf on these tie-free rows; with
  every leaf probed the meshed search equals the unmeshed one (int8_rows
  bit for bit; bf16 and asym_rows at K2's tolerance, ids equal) and K2
  launches 4 times a call;
- K2 refuses a slab view that does not start on 16 bytes (its TMA reads),
  and `shard_ivf_state` hands it an aligned copy instead.
"""

import numpy as np
import pytest
import torch

from hbird_tpu_torch.nn import NearestNeighborSearchApprox
from hbird_tpu_torch.ops import ivf_cuda, knn_cuda
from hbird_tpu_torch.ops.knn import knn_with_labels
from hbird_tpu_torch.ops.quantize import quantize_bank_int8, quantize_queries_int8
from hbird_tpu_torch.parallel import make_mesh, ring_knn_with_labels, shard_bank, sharded_knn_with_labels
from hbird_tpu_torch.parallel.sharded_ivf import shard_ivf_state, sharded_ivf_knn_with_labels
from hbird_tpu_torch.parallel.sharded_knn import shard_rows

pytestmark = pytest.mark.cuda

RTOL = 1e-5
N = 4
STRATEGIES = {"gather": (sharded_knn_with_labels, N), "ring": (ring_knn_with_labels, N * N)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _inputs(dev, m=20003, d=64, n_q=700, seed=9):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.normal(size=(n_q, d)).astype(np.float32)
    lab = torch.from_numpy(rng.random((m, 7)).astype(np.float32)).to(dev)
    return torch.from_numpy(x).to(dev), torch.from_numpy(q).to(dev), lab


def _form(form, x, q):
    if form in ("dot", "l2"):
        return q.to(torch.bfloat16), x.to(torch.bfloat16), None, "l2" if form == "l2" else "dot_product"
    codes, scale = quantize_bank_int8(x, per_row=form == "int8_rows")
    qc, _ = quantize_queries_int8(q)
    return qc, codes, scale if form == "int8_rows" else None, "dot_product"


@pytest.mark.parametrize("strategy", list(STRATEGIES))
@pytest.mark.parametrize("form", ["dot", "l2", "int8_rows"])
def test_shards_on_one_card_match_unsharded_k1(cuda_device, form, strategy):
    x, q, lab = _inputs(cuda_device)
    qt, bank, rs, distance = _form(form, x, q)
    k, valid = 30, x.shape[0] - 3
    v0, i0, l0 = knn_with_labels(qt, bank, lab, k, valid_rows=valid, distance=distance, row_scale=rs)
    mesh = make_mesh((N,), ("bank",), [cuda_device] * N)
    bs, ls, _ = shard_bank(bank, lab, mesh)
    fn, launches = STRATEGIES[strategy]
    before, forms = knn_cuda.knn_topk.launches, knn_cuda.knn_topk.forms[form]
    v, i, lv = fn(qt, bs, ls, k, mesh=mesh, valid_rows=valid, distance=distance,
                  row_scale=shard_rows(rs, mesh) if rs is not None else None)
    torch.cuda.synchronize()
    assert knn_cuda.knn_topk.launches - before == launches
    assert knn_cuda.knn_topk.forms[form] - forms == launches
    if form == "int8_rows":
        assert torch.equal(v, v0) and torch.equal(i, i0)
    else:
        tol = RTOL * float(torch.linalg.vector_norm(q, dim=1).max())
        assert (v - v0).abs().max().item() <= tol and torch.equal(i, i0)
    assert torch.equal(lv, l0)


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_reordered_shards_rescore_and_dominate(cuda_device, strategy):
    x, q, lab = _inputs(cuda_device, seed=10)
    qc, codes, _, _ = _form("int8", x, q)
    rb, rq = x.to(torch.bfloat16), q.to(torch.bfloat16)
    k, c = 30, 120
    v0, _, _ = knn_with_labels(qc, codes, lab, k, rerank_bank=rb, rerank_queries=rq, rerank_candidates=c)
    mesh = make_mesh((N,), ("bank",), [cuda_device] * N)
    bs, ls, valid = shard_bank(codes, lab, mesh)
    fn, launches = STRATEGIES[strategy]
    before = knn_cuda.knn_topk.launches
    v, i, lv = fn(qc, bs, ls, k, mesh=mesh, valid_rows=valid, rerank_bank=shard_rows(rb, mesh),
                  rerank_queries=rq, rerank_candidates=c)
    torch.cuda.synchronize()
    assert knn_cuda.knn_topk.launches - before == launches
    tol = RTOL * float(torch.linalg.vector_norm(q, dim=1).max())
    rescored = torch.einsum("qd,qkd->qk", rq.float(), rb[i].float())
    assert (rescored - v).abs().max().item() <= tol
    assert (v - v0 >= -tol).all()
    assert torch.equal(lv, lab[i])


TREE_FORMS = {"bf16": {}, "int8_rows": {"quantization": "int8_rows"},
              "asym_rows": {"quantization": "int8_asym", "dimensions_per_block": 4}}


@pytest.mark.parametrize("form", list(TREE_FORMS))
def test_meshed_tree_on_one_card_matches_the_unmeshed_tree(cuda_device, form):
    x, q, lab = _inputs(cuda_device, m=30000, seed=11)
    common = dict(n_neighbors=30, use_tree=True, num_leaves=64, label_memory=lab, device=cuda_device,
                  **TREE_FORMS[form])
    mesh = make_mesh((N,), ("bank",), [cuda_device] * N)
    one = NearestNeighborSearchApprox(x, **common)
    meshed = NearestNeighborSearchApprox(x, mesh=mesh, **common)
    for part in ("centroids", "slots", "perm", "leaf_valid"):
        assert torch.equal(getattr(meshed, part), getattr(one, part)), part
    assert torch.equal(torch.cat(meshed.bank), one.bank) and torch.equal(torch.cat(meshed.labels), one.labels)
    dev = NearestNeighborSearchApprox(x, mesh=mesh, tree_build_layout="device", **common)
    assert torch.equal(dev.leaf_valid, one.leaf_valid)
    slots = torch.cat(dev.slots)[: x.shape[0]]
    assert torch.equal(slots // one._cap, one.slots // one._cap)  # tie-free rows: the same leaves
    for tree in (one, meshed):
        tree.num_leaves_to_search = one._n_leaves
    before = ivf_cuda.ivf_topk.launches
    v, i, lv = meshed.search_with_labels(q)
    torch.cuda.synchronize()
    assert ivf_cuda.ivf_topk.launches - before == N
    v0, i0, l0 = one.search_with_labels(q)
    if form == "int8_rows":
        assert torch.equal(v, v0) and torch.equal(i, i0)
    else:
        tol = RTOL * float(torch.linalg.vector_norm(q, dim=1).max()) * 1.01
        assert (v - v0).abs().max().item() <= tol and torch.equal(i, i0)
    assert torch.equal(lv, l0)


def test_k2_refuses_a_misaligned_slab_view(cuda_device):
    x, q, lab = _inputs(cuda_device, m=4096, seed=12)
    cap = 256
    flat = x.to(torch.bfloat16).reshape(-1)
    view = flat[4:].narrow(0, 0, 4095 * 64).view(4095, 64)[: 15 * cap]  # starts 8 bytes into the allocation
    lv = torch.full((15,), cap, dtype=torch.int32, device=cuda_device)
    qb = q[:256].to(torch.bfloat16)
    lids = torch.arange(4, dtype=torch.int32, device=cuda_device)[None].repeat(4, 1)
    with pytest.raises(ValueError, match="16-byte"):
        ivf_cuda.ivf_topk(qb, view, lids, lv, 10, cap=cap, block_q=64)
    mesh = make_mesh((1,), ("bank",), [cuda_device])
    bank, labels, _ = shard_ivf_state(view, lab[: 15 * cap], mesh, cap=cap)
    assert bank[0].data_ptr() % 16 == 0 and torch.equal(bank[0], view)
    v, i, _ = sharded_ivf_knn_with_labels(qb, bank, labels, torch.randn(15, 64, device=cuda_device), lv, 10,
                                          cap=cap, n_probe=4, block_q=64)
    assert torch.isfinite(v).all()
