"""K2 f32's 3xTF32 walk, emulated in torch, against the f32 numerics.

On the card K2's f32 form runs K1's persistent wgmma kernel
(hbird_tpu_torch/ops/csrc/wgmma_topk.cuh, form `F32`) over (probe split,
64-query tile) items: each query tile's probe list is cut into splits, a
split walks its slabs in probe order in 128-row tiles up to each slab's
leaf_valid (empty slabs and ids outside [0, n_slabs) skipped), consumer w
takes tiles w, w + 2, ..., and every tile is scored in 3xTF32: each operand
split into big = tf32(x) and small = tf32(x - big) (tests/tf32_emulation.py),
each 32-deep depth chunk taking small·big + big·small + big·big in a fresh
accumulator, the chunks added in f32 in depth order (D % 32 != 0: the last
chunk's missing depths are TMA's zero fill, which adds nothing). The
batched select keeps each set's keys under "value descending, then slot
ascending". `tf32_walk` below is that walk on the CPU, with
test_torch_knn_select.py's emulation of the select.

Held, on seeded numpy inputs (unit rows, and rows scaled by 0.2-3.0;
ragged leaf_valid with an empty slab, one of 5 rows and one cut at a tile
edge; cap = 264, not a multiple of 128; D = 72 and 768), against the port's
f32 `ivf_search_plain`, the JAX package's `pallas_ivf_knn` (the TPU kernel,
interpret mode) and `ivf_search_xla`: values within 1e-5 · ||q|| · max
||b||, K2's f32 tolerance on the card, and equal slot sets (tie-free
inputs). A single TF32 pass (big·big alone) misses that tolerance.

The plan (`plan_probe_splits`) and scratch (`wgmma_scratch`) are the other
forms' for f32 (form 0): checked at the main tree's shape here; the
launches on the card in tests/test_torch_ivf_cuda.py.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hbird_tpu.ops import ivf as jivf
from hbird_tpu_torch.ops import ivf, ivf_cuda, knn_cuda

from test_torch_ivf_split import slab_tiles
from test_torch_knn_select import NONE, SelectSet, key_index, key_value, make_keys
from test_torch_knn_tf32 import scores_3xtf32

RTOL = 1e-5
N_SLABS, CAP, BLOCK_Q, N_TILES, N_PROBE = 9, 264, 64, 2, 6


def tf32_walk(q, bank, leaf_ids, leaf_valid, k, cap, splits, passes=3):
    """K2 f32's wgmma kernel in plain torch: per query tile, the probe
    splits' walks in probe order, two partial sets each (tiles w, w + 2,
    ...), each 128-row tile scored in 3xTF32 (`passes=1`: big·big alone),
    the sets sharing their published minimum; then the k best of their
    top-(32·S) sets, value descending, then slot ascending."""
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
                    sc = scores_3xtf32(qt, bank[rows], passes)
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


def _tree(d, scaled, seed):
    """Normal queries; unit slab rows (or scaled by 0.2-3.0), padding rows
    zero; slab 0 empty, slab 1 of 5 rows, slab 2 cut at 128 (a tile edge),
    slab 3 full, the rest ragged; each tile probes slab 0 and five others
    out of slot order."""
    rng = np.random.default_rng(seed)
    fill = rng.integers(1, CAP + 1, N_SLABS)
    fill[:4] = [0, 5, 128, CAP]
    bank = rng.normal(size=(N_SLABS * CAP, d)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    if scaled:
        bank = (bank * rng.uniform(0.2, 3.0, (N_SLABS * CAP, 1))).astype(np.float32)
    bank[(np.arange(N_SLABS * CAP) % CAP) >= np.repeat(fill, CAP)] = 0.0
    q = rng.normal(size=(N_TILES * BLOCK_Q, d)).astype(np.float32)
    lids = np.stack([np.concatenate([[0], rng.permutation(np.arange(1, N_SLABS))[:N_PROBE - 1]])[::-1]
                     for _ in range(N_TILES)]).astype(np.int32)
    return q, bank, lids, fill.astype(np.int32)


def _tol(q, bank):
    return RTOL * float(np.linalg.norm(q, axis=1).max() * np.linalg.norm(bank, axis=1).max())


def _agree(v, i, ov, oi, tol):
    ov, oi = np.asarray(ov), np.asarray(oi).astype(np.int64)
    finite = np.isfinite(ov)
    np.testing.assert_array_equal(np.isfinite(v.numpy()), finite)
    assert np.abs(v.numpy()[finite] - ov[finite]).max() <= tol
    np.testing.assert_array_equal(np.sort(np.where(finite, i.numpy(), -1), 1),
                                  np.sort(np.where(finite, oi, -1), 1))


@pytest.mark.parametrize("k", [30, 128])
@pytest.mark.parametrize("scaled", [False, True], ids=["unit", "scaled"])
@pytest.mark.parametrize("d", [72, 768])
def test_3xtf32_walk_matches_f32_and_the_tpu_kernel(d, scaled, k):
    """Three probe splits (two probes each), every edge slab probed: the
    emulated walk against the port's f32 plain version, pallas_ivf_knn
    (interpret) and ivf_search_xla."""
    q, bank, lids, fill = _tree(d, scaled, seed=d + k + scaled)
    tq, tb, tl, tf = (torch.from_numpy(x) for x in (q, bank, lids, fill))
    tol = _tol(q, bank)
    v, i = tf32_walk(tq, tb, tl, tf, k, CAP, splits=3)
    assert (i[torch.isfinite(v)] % CAP < tf.long()[i[torch.isfinite(v)] // CAP]).all()
    _agree(v, i, *ivf.ivf_search_plain(tq, tb, tl, tf, k, cap=CAP), tol)
    jq, jb, jl, jf = (jnp.asarray(x) for x in (q, bank, lids, fill))
    _agree(v, i, *jivf.ivf_search_xla(jq, jb, jl, jf, k, cap=CAP), tol)
    _agree(v, i, *jivf.pallas_ivf_knn(jq, jb, jl, jf, k, cap=CAP, block_q=BLOCK_Q, interpret=True), tol)


@pytest.mark.parametrize("splits", [1, 2, 6])
def test_3xtf32_walk_does_not_depend_on_the_probe_splits(splits):
    """The keys are unique, so any cut of the probe lists gives the same
    values and slots, bit for bit."""
    q, bank, lids, fill = (torch.from_numpy(x) for x in _tree(72, True, seed=3))
    want = tf32_walk(q, bank, lids, fill, 64, CAP, splits=3)
    got = tf32_walk(q, bank, lids, fill, 64, CAP, splits=splits)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("scaled", [False, True], ids=["unit", "scaled"])
def test_one_tf32_pass_misses_the_f32_tolerance(scaled):
    """At D = 768, big·big alone misses 1e-5 · ||q|| · max ||b|| on the
    probed top-30 values; the three passes stay inside it."""
    q, bank, lids, fill = _tree(768, scaled, seed=40 + scaled)
    tq, tb, tl, tf = (torch.from_numpy(x) for x in (q, bank, lids, fill))
    tol = _tol(q, bank)
    pv, _ = ivf.ivf_search_plain(tq, tb, tl, tf, 30, cap=CAP)
    for passes, within in ((3, True), (1, False)):
        v, i = tf32_walk(tq, tb, tl, tf, 30, CAP, splits=1, passes=passes)
        exact = torch.einsum("qd,qkd->qk", tq.double(), tb.double()[i])
        err = (v.double() - exact).abs().max().item()
        assert (err <= tol / 10) if within else (err > tol), (passes, err, tol)
        assert ((v - pv).abs().max().item() <= tol) == within


@pytest.mark.parametrize("k", [30, 64, 128])
def test_f32_plans_the_wgmma_kernels_items(monkeypatch, k):
    """Form 0 (f32) runs the wgmma kernel with the other forms' plan and
    scratch, which take no form: the main tree's 22,016 queries (86 tiles
    of 256, 32 probes) on 132 SMs cut each probe list 3 ways, 344 · 3
    items; two partial sets of 32 · ceil(k / 32) keys per split and query,
    under MAX_PARTS_BYTES; one CTA's select scratch for each SM."""
    assert knn_cuda.FORMS[torch.float32, torch.float32] == 0
    splits = ivf_cuda.plan_probe_splits(22016, 32, 132, k)
    assert splits == 3
    items = 22016 // ivf_cuda.BLOCK * splits
    assert items == 1032 and items / (-(-items // 132) * 132) >= knn_cuda.MIN_FILL
    s = -(-k // 32)
    work_keys = 8 * 16 * (32 * (4 if s == 3 else s) + 160)  # wgmma_topk.cuh's work_keys(k)
    lib = types.SimpleNamespace(ivf_topk_work_keys=_CFunction(lambda kk: work_keys if kk == k else -1))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(multi_processor_count=132))
    parts, thr, work, ctas = knn_cuda.wgmma_scratch(lib, "ivf_topk", 22016, splits, k, "cpu")
    assert tuple(parts.shape) == (22016, 6, 32 * s) == knn_cuda.parts_shape(22016, splits, k)
    assert parts.numel() * 8 <= knn_cuda.MAX_PARTS_BYTES and parts.dtype == torch.int64
    assert tuple(thr.shape) == (22016,) and not thr.any()
    assert ctas == 132 and work.numel() == 132 * work_keys


class _CFunction:
    """A stand-in for a ctypes function: callable, with settable
    argtypes and restype."""

    def __init__(self, fn):
        self.fn, self.argtypes, self.restype = fn, None, None

    def __call__(self, *args):
        return self.fn(*args)
