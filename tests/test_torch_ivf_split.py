"""The probe splits of K2's wgmma kernel and their merge, on the CPU.

On the card K2's bf16, int8 and asym forms run K1's persistent wgmma kernel
(ops/csrc/wgmma_topk.cuh) over (probe split, 64-query tile) items: each
query tile's probe list is cut into `plan_probe_splits` ranges, a range is
walked slab by slab in probe order in 128-row tiles up to each slab's
leaf_valid (empty slabs and ids outside [0, n_slabs) skipped), consumer w
takes the walk's tiles w, w + 2, ..., and each keeps a partial top set with
the batched select; a second pass emits the k best of the 2 · splits sets
by value descending, then slot ascending. Held here:
- `plan_probe_splits`: the fewest splits whose rounds of items keep at
  least 90% of the SMs busy, where a split count the plan may take does,
  at most one per MIN_PROBES_PER_SPLIT probes;
- that walk and merge in plain torch (`split_walk` below, with
  test_torch_knn_select.py's emulation of the select) bit for bit against
  the port's plain version `ivf_search_plain` on tie-dense int8 codes with
  empty, underfilled and out-of-range slabs, and on a JAX-built tree (its
  centroids and slots handed to the port) against the JAX package's
  `pallas_ivf_knn` (interpret mode) and `ivf_search_xla` on tie-free
  inputs within the K2 tolerance (1e-5 · ||q|| · max ||b||) with equal
  slot sets.
The kernel against the plain version on the card: test_torch_ivf_cuda.py.
"""

import numpy as np
import pytest
import torch

from hbird_tpu.ops import ivf as jivf
from hbird_tpu_torch.ops import ivf, ivf_cuda
from hbird_tpu_torch.ops.knn import dot_scores
from hbird_tpu_torch.ops.knn_cuda import MIN_FILL

from test_torch_ivf import Tree, _assert_same_topk, _tol
from test_torch_knn_select import NONE, SelectSet, key_index, key_value, make_keys


def slab_tiles(lids_row, leaf_valid, cap, p0, p1):
    """(first slot, valid columns) of the 128-row tiles of probes [p0, p1)."""
    n_slabs = leaf_valid.shape[0]
    out = []
    for s in lids_row[p0:p1].tolist():
        if not 0 <= s < n_slabs:
            continue
        valid = min(max(int(leaf_valid[s]), 0), cap)
        out += [(s * cap + m0, valid - m0) for m0 in range(0, valid, 128)]
    return out


def split_walk(q, bank, leaf_ids, leaf_valid, k, cap, splits, row_scale=None):
    """K2's wgmma kernel in plain torch: per query tile, the probe splits'
    walks, two partial sets each (tiles w, w + 2, ...), sharing their
    published minimum, then the k best of their top-(32·S) sets."""
    tiles, n_probe = leaf_ids.shape
    block_q = q.shape[0] // tiles
    per = -(-n_probe // splits) if n_probe else 1
    s = -(-k // 32)
    vals, idx = [], []
    for t in range(tiles):
        qt = q[t * block_q:(t + 1) * block_q]
        walks, sets = [], []
        for p0 in range(0, max(n_probe, 1), per):
            seq = slab_tiles(leaf_ids[t], leaf_valid, cap, p0, min(n_probe, p0 + per))
            for w in range(2):
                walks.append(seq[w::2])
                sets.append(SelectSet(block_q, s))
        pub = torch.full((block_q,), NONE, dtype=torch.int64)
        for step in range(max(len(w) for w in walks)):
            for walk, st in zip(walks, sets):
                if step < len(walk):
                    row0, n_cols = walk[step]
                    rows = torch.arange(row0, row0 + min(128, n_cols))
                    sc = dot_scores(qt, bank[rows])
                    if row_scale is not None:
                        sc = sc * row_scale[rows]
                    st.add_tile(make_keys(sc, rows.expand(block_q, -1)), pub)
                    pub = torch.maximum(pub, st.minimum())
        for st in sets:
            st.flush(1, pub)
        best = torch.sort(torch.cat([st.top[:, :32 * s] for st in sets], 1), 1, descending=True)
        best = best.values[:, :k]
        v = key_value(best)
        vals.append(v)
        idx.append(torch.where(torch.isfinite(v), key_index(best), torch.zeros_like(best)))
    return torch.cat(vals), torch.cat(idx)


def _fill(n_q, splits, n_sm):
    items = -(-n_q // 64) * splits
    return items / (-(-items // n_sm) * n_sm)


def test_plan_of_the_main_tree():
    """22,016 queries (344 items of 64) on 132 SMs, 32 probes: one split
    leaves 13% of the SMs' rounds idle, three fill 97.7%."""
    assert ivf_cuda.plan_probe_splits(22016, 32, 132, 30) == 3
    assert ivf_cuda.plan_probe_splits(22016, 0, 132, 30) == 1
    assert ivf_cuda.plan_probe_splits(64 * 132, 32, 132, 30) == 1  # one full round


@pytest.mark.parametrize("n_sm", [132, 114, 78])
@pytest.mark.parametrize("k", [1, 30, 128])
def test_plan_fills_the_card(n_sm, k):
    rng = np.random.default_rng(n_sm + k)
    for n_q, n_probe in [(64, 1), (256, 32), (22016, 32), (4096, 8), (22016, 3),
                         *zip(64 * rng.integers(1, 600, 15), rng.integers(0, 80, 15))]:
        n_q, n_probe = int(n_q), int(n_probe)
        splits = ivf_cuda.plan_probe_splits(n_q, n_probe, n_sm, k)
        per = -(-n_probe // splits) if n_probe else 1
        assert splits == (-(-n_probe // per) if n_probe else 1)  # every split walks probes
        options = sorted({-(-n_probe // -(-n_probe // w))
                          for w in range(1, max(1, n_probe // ivf_cuda.MIN_PROBES_PER_SPLIT) + 1)}
                         if n_probe else {1})
        full = [s for s in options if _fill(n_q, s, n_sm) >= MIN_FILL]
        if full:
            assert splits == full[0]
        else:
            assert _fill(n_q, splits, n_sm) == max(_fill(n_q, s, n_sm) for s in options)


@pytest.mark.parametrize("k", [1, 30, 64, 120, 128])
@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("scaled", [False, True], ids=["int8", "int8_rows"])
def test_split_walk_equals_plain_version_on_ties(scaled, splits, k):
    """Codes in {-1, 0, 1} (integer scores tie many ways across slabs probed
    out of slot order), ragged leaf_valid with an empty slab, one with fewer
    rows than k and one id out of range: bit for bit the plain version."""
    gen = torch.Generator().manual_seed(k + 10 * splits)
    n_slabs, cap, d, block_q = 7, 384, 16, 64
    bank = torch.randint(-1, 2, (n_slabs * cap, d), generator=gen, dtype=torch.int8)
    lv = torch.tensor([384, 0, 200, 9, 301, 129, 128], dtype=torch.int32)
    q = torch.randint(-1, 2, (2 * block_q, d), generator=gen, dtype=torch.int8)
    lids = torch.tensor([[4, 1, 0, 2, 6, 3], [5, 3, 9, 2, 0, 1]], dtype=torch.int32)
    rs = 0.25 + torch.rand(n_slabs * cap, generator=gen) if scaled else None
    kv, ki = split_walk(q, bank, lids, lv, k, cap, splits, row_scale=rs)
    pv, pi = ivf.ivf_search_plain(q, bank, lids.clamp(0, n_slabs - 1).where(lids < n_slabs, 1),
                                  lv, k, cap=cap, row_scale=rs)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


@pytest.fixture(scope="module")
def tree():
    return Tree()


@pytest.mark.parametrize("k", [30, 128])
@pytest.mark.parametrize("splits", [1, 3])
def test_split_walk_matches_jax_on_its_tree(tree, splits, k):
    """A JAX-built tree, the JAX centroids handed over (the port's probe
    lists equal JAX's): the split walk's values and slot sets against
    pallas_ivf_knn (interpret) and ivf_search_xla."""
    qj, qt = tree.queries(128, seed=k)
    lids_t = ivf.select_block_leaves(qt, tree.tc, 6, 64)
    lids_j = jivf.select_block_leaves(qj, tree.jc, 6, 64)
    np.testing.assert_array_equal(lids_t.numpy(), np.asarray(lids_j))
    tv, ti = split_walk(qt, tree.tbank, lids_t, tree.tlv, k, tree.cap, splits)
    tol = _tol(qt.numpy(), tree.tbank.numpy())
    xv, xi = jivf.ivf_search_xla(qj, tree.jbank, lids_j, tree.jlv, k, cap=tree.cap)
    _assert_same_topk(tv, ti, xv, xi, tol)
    pv, pi = jivf.pallas_ivf_knn(qj, tree.jbank, lids_j, tree.jlv, k, cap=tree.cap, block_q=64,
                                 interpret=True)
    _assert_same_topk(tv, ti, pv, pi, tol)
