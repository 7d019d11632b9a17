"""The plan and the split merge of K1's wgmma kernel, on the CPU.

K1's bf16 forms (dot and l2) and int8 forms (int8, int8_rows) run one
persistent wgmma kernel over (bank split, 64-query tile) items and merge
the splits' partial top sets in a second pass. What the CPU can reach is
checked here:
- `plan_splits` (one plan for both element types: the same items and
  tiles): the splits cover the valid rows in 128-row tiles, the last round
  of items keeps at least 90% of the SMs busy where some split count can,
  and the scratch stays bounded, at every k the kernel takes;
- the scheme of the two passes, in plain torch (`split_topk_plain` below):
  each split's exact top set, then the k best of the partial sets by value
  descending, then index ascending. On tie-dense inputs (small integer
  entries, so every score is exact whatever the summation order) it equals
  `exact_knn` exactly, values and indices, for every split size,
  valid_rows, k and distance, and on int8 codes with and without row
  scales; on tie-free inputs it agrees with the JAX package's `exact_knn`
  within the K1 tolerance (1e-5 · ||q|| · max ||b||) with equal index sets,
  and on int8 codes with `pallas_knn` (the TPU kernel, in interpret mode)
  as value multisets.
The kernel's own pruning (a partial set drops keys below another set's
published minimum) is held to `exact_knn` bit for bit on tie-dense inputs
on the card, in `test_torch_knn_cuda.py`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hbird_tpu.ops.knn import exact_knn as jax_exact_knn
from hbird_tpu.ops.knn_pallas import pallas_knn
from hbird_tpu_torch.ops import knn_cuda
from hbird_tpu_torch.ops.knn import exact_knn

RTOL = 1e-5


def split_topk_plain(queries, bank, k, split_rows, *, valid_rows=None, distance="dot_product",
                     row_scale=None):
    """The exact top-k of each split's valid rows, then the k best of the
    partial sets, value descending, then index ascending."""
    valid = bank.shape[0] if valid_rows is None else int(valid_rows)
    vals, idx = [], []
    for r0 in range(0, valid, split_rows):
        r1 = min(valid, r0 + split_rows)
        v, i = exact_knn(queries, bank[r0:r1], k, distance=distance,
                         row_scale=None if row_scale is None else row_scale[r0:r1])
        vals.append(v)
        idx.append(torch.where(torch.isfinite(v), i + r0, torch.zeros_like(i)))
    if not vals:
        return exact_knn(queries, bank, k, valid_rows=0, distance=distance, row_scale=row_scale)
    v, i = torch.cat(vals, dim=1), torch.cat(idx, dim=1)
    i, order = torch.sort(i, dim=1, stable=True)
    v = torch.gather(v, 1, order)
    v, order = torch.sort(v, dim=1, descending=True, stable=True)
    return v[:, :k], torch.gather(i, 1, order)[:, :k]


def _tie_dense(n_q, m, d, seed, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randint(-1, 2, (n_q, d), generator=gen).to(dtype)
    b = torch.randint(-1, 2, (m, d), generator=gen).to(dtype)
    return q, b


def test_plan_of_the_main_shapes():
    """Q = 21,904 on 132 SMs: 343 query tiles; one or two splits leave 13%
    of the SMs' rounds idle (343 items in 3 rounds, 686 in 6); three give
    1,029 items in 8 rounds, 97.4% busy. k = 120 is the `faiss` int8 +
    reorder path's scan."""
    for k in (30, 120):
        assert knn_cuda.plan_splits(21904, 87616, 132, k) == (229 * 128, 3)
        assert knn_cuda.plan_splits(21904, 1024000, 132, k) == (2667 * 128, 3)
    assert knn_cuda.plan_splits(21904, 0, 132, 30) == (128, 1)
    assert knn_cuda.plan_splits(64 * 132, 87616, 132, 30)[1] == 1  # one full round


def _fill(n_q, splits, n_sm):
    items = -(-n_q // 64) * splits
    return items / (-(-items // n_sm) * n_sm)


@pytest.mark.parametrize("n_sm", [132, 114, 78])
@pytest.mark.parametrize("k", [1, 30, 120, 128])
def test_plan_covers_the_valid_rows_and_fills_the_card(n_sm, k):
    """Every plan covers exactly the valid rows in 128-row tiles and keeps
    its scratch bounded; where a split count the plan may take fills 90% of
    the SMs' rounds, the plan takes the fewest such."""
    rng = np.random.default_rng(n_sm + k)
    for n_q, valid in [(1, 1), (64, 127), (300, 4900), (21904, 87616), (4096, 299000),
                       *zip(rng.integers(1, 40000, 20), rng.integers(1, 2_000_000, 20))]:
        n_q, valid = int(n_q), int(valid)
        split_rows, splits = knn_cuda.plan_splits(n_q, valid, n_sm, k)
        assert split_rows % 128 == 0 and split_rows >= 128
        assert (splits - 1) * split_rows < valid <= splits * split_rows
        shape = knn_cuda.parts_shape(n_q, splits, k)
        assert shape == (n_q, 2 * splits, 32 * (-(-k // 32)))
        assert splits == 1 or np.prod(shape) * 8 <= knn_cuda.MAX_PARTS_BYTES
        tiles = -(-valid // 128)
        options = sorted({-(-tiles // -(-tiles // s))
                          for s in range(1, max(1, tiles // knn_cuda.MIN_TILES_PER_SPLIT) + 1)})
        options = [s for s in options
                   if s == 1 or np.prod(knn_cuda.parts_shape(n_q, s, k)) * 8 <= knn_cuda.MAX_PARTS_BYTES]
        full = [s for s in options if _fill(n_q, s, n_sm) >= knn_cuda.MIN_FILL]
        if full:
            assert splits == full[0]
        else:
            assert _fill(n_q, splits, n_sm) == max(_fill(n_q, s, n_sm) for s in options)


@pytest.mark.parametrize("distance", ["dot_product", "l2"])
@pytest.mark.parametrize("k", [1, 30, 128])
@pytest.mark.parametrize("split_rows", [128, 256, 640, 4096])
def test_split_merge_equals_exact_knn_on_ties(split_rows, k, distance):
    """Integer entries in {-1, 0, 1}: scores are exact and tie many ways,
    within and across splits; the merge of the splits' top sets gives
    exact_knn's values and indices exactly."""
    q, b = _tie_dense(40, 3001, 32, seed=split_rows + k)
    for valid in (3001, 2999, split_rows, split_rows + 1, 17):
        kv, ki = split_topk_plain(q, b, k, split_rows, valid_rows=valid, distance=distance)
        pv, pi = exact_knn(q, b, k, valid_rows=valid, distance=distance)
        assert torch.equal(kv, pv) and torch.equal(ki, pi), (valid, split_rows)


def test_split_merge_keeps_the_lowest_copy_across_splits():
    """Four copies of 500 rows, each in another split: of tied rows the
    lowest index comes first, and a copy is kept only with every lower one."""
    q, b = _tie_dense(30, 500, 32, seed=3, dtype=torch.bfloat16)
    bank = b.repeat(4, 1)
    kv, ki = split_topk_plain(q, bank, 45, 500)
    pv, pi = exact_knn(q, bank, 45)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    copy, row = ki // 500, ki % 500
    for c in range(1, 4):
        lower = ((row[:, :, None] == row[:, None, :]) & (copy[:, None, :] == c - 1)).any(2)
        assert not ((copy == c) & ~lower).any()


@pytest.mark.parametrize("distance", ["dot_product", "l2"])
def test_split_merge_matches_jax_exact_knn(distance):
    """Tie-free normal inputs against hbird_tpu.ops.knn.exact_knn."""
    rng = np.random.default_rng(21)
    q = rng.normal(size=(50, 64)).astype(np.float32)
    b = (rng.normal(size=(2000, 64)) * rng.uniform(0.5, 2.0, (2000, 1))).astype(np.float32)
    tv, ti = split_topk_plain(torch.from_numpy(q), torch.from_numpy(b), 30, 384,
                                       valid_rows=1900, distance=distance)
    jv, ji = jax_exact_knn(jnp.asarray(q), jnp.asarray(b), 30, distance=distance, valid_rows=1900)
    tol = RTOL * float(np.linalg.norm(q, axis=1).max() * np.linalg.norm(b, axis=1).max())
    assert np.abs(tv.numpy() - np.asarray(jv)).max() <= tol
    assert np.array_equal(np.sort(ti.numpy(), 1), np.sort(np.asarray(ji), 1))


def _int8_tie_dense(n_q, m, d, seed):
    """int8 codes in {-2, ..., 2} (integer scores tie many ways) and
    seeded row scales in [0.25, 1.25)."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randint(-2, 3, (n_q, d), generator=gen, dtype=torch.int8)
    b = torch.randint(-2, 3, (m, d), generator=gen, dtype=torch.int8)
    return q, b, 0.25 + torch.rand(m, generator=gen)


@pytest.mark.parametrize("form", ["int8", "int8_rows"])
@pytest.mark.parametrize("k", [1, 30, 120, 128])
@pytest.mark.parametrize("split_rows", [128, 256, 640, 4096])
def test_int8_split_merge_equals_exact_knn_on_ties(split_rows, k, form):
    """int8 codes: integer scores (times one f32 row scale) are exact and
    tie many ways within and across splits; the merge of the splits' top
    sets gives exact_knn's values and indices exactly."""
    q, b, scale = _int8_tie_dense(40, 3001, 32, seed=split_rows + k)
    rs = scale if form == "int8_rows" else None
    for valid in (3001, 2999, split_rows, split_rows + 1, 17):
        kv, ki = split_topk_plain(q, b, k, split_rows, valid_rows=valid, row_scale=rs)
        pv, pi = exact_knn(q, b, k, valid_rows=valid, row_scale=rs)
        assert torch.equal(kv, pv) and torch.equal(ki, pi), (valid, split_rows)


@pytest.mark.parametrize("form", ["int8", "int8_rows"])
@pytest.mark.parametrize("k", [1, 30, 120, 128])
def test_int8_split_merge_matches_pallas_knn(k, form):
    """The two-pass scheme on tie-dense int8 codes against the TPU kernel
    (`pallas_knn`, interpret mode) on the same codes and scales: the same
    values as multisets (the kernels may order tied rows otherwise)."""
    q, b, scale = _int8_tie_dense(16, 700, 32, seed=k)
    rs = scale if form == "int8_rows" else None
    kv, _ = split_topk_plain(q, b, k, 256, valid_rows=650, row_scale=rs)
    jv, _ = pallas_knn(jnp.asarray(q.numpy()), jnp.asarray(b.numpy()), k, valid_rows=650,
                       row_scale=None if rs is None else jnp.asarray(rs.numpy()[:, None]),
                       block_q=8, block_m=256, interpret=True)
    np.testing.assert_array_equal(np.sort(kv.numpy(), 1), np.sort(np.asarray(jv), 1))
