"""The batched select of K1's and K2's wgmma kernel, emulated on the CPU.

The kernel (hbird_tpu_torch/ops/csrc/wgmma_topk.cuh) keeps each query's
running top set sorted in scratch memory and only its minimum key in
registers. A tile's keys above the row's floor (the set's minimum, or the
minimum another partial set of the query published, if larger) are
buffered; once a row holds FLUSH_AT (32) keys, or at the item's end, the
buffer is merged into the set in chunks of 32: each chunk sorted by a
bitonic network, reversed, folded into the set's last 32 keys by an
elementwise max, and the set put in order by a bitonic merge of P = 32·S
keys (128 at S = 3). `batched_select` below runs that same network on the
same 64-bit keys, in the kernel's order of work: bank splits, two partial
sets a split (consumer w takes the split's 128-row tiles w, w + 2, ...),
each set's top-(32·S) merged by value descending, then index ascending.

Held here, at k in {33, 64, 96, 97, 120, 128} (S = 2, 3 and 4):
- bit for bit to `exact_knn` on tie-dense integer inputs (every score
  exact), for bf16 dot and l2, int8 and int8_rows, with the partial sets
  pruning by each other's published minimum in one order of timing and
  without it, at several split sizes and valid_rows; and on int8 codes at
  D = 1,536 whose exact sums pass 2^24 and round to f32 once (the
  kernel's s32 accumulators), so equal f32 values are dense;
- to the TPU kernel (`pallas_knn`, interpret mode) as value multisets on
  tie-dense int8 codes (the TPU kernel may order tied rows otherwise);
- the network itself: a merge keeps exactly the top P of the set and the
  chunk, sorted, whatever the chunk's order.
The kernel against the plain version on the card: test_torch_knn_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hbird_tpu.ops.knn_pallas import pallas_knn
from hbird_tpu_torch.ops.knn import dot_scores, exact_knn, l2_bias

FLUSH_AT = 32
KS = [33, 64, 96, 97, 120, 128]
NONE = -(2**63)  # the kernel's key 0: below every key


def make_keys(scores, cols):
    """The kernel's unique 64-bit keys (order-preserving f32 bits above the
    complemented column), shifted into int64's signed order."""
    u = (scores + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    ordv = torch.where(u >= 2**31, (~u) & 0xFFFFFFFF, u | 2**31)
    return (ordv - 2**31) * 2**32 + ((~cols) & 0xFFFFFFFF)


def key_value(keys):
    ordv = (keys >> 32) + 2**31
    u = torch.where(ordv >= 2**31, ordv & 0x7FFFFFFF, (~ordv) & 0xFFFFFFFF)
    return u.to(torch.int32).view(torch.float32)


def key_index(keys):
    return (~keys) & 0xFFFFFFFF


EMPTY = int(make_keys(torch.tensor([float("-inf")]), torch.tensor([0]))[0])


def _cx(x, j, keep_max):
    idx = torch.arange(x.shape[1])
    o = x[:, idx ^ j]
    return torch.where(keep_max, torch.maximum(x, o), torch.minimum(x, o))


def sort32_desc(x):
    """The kernel's bitonic sort of one key a lane (x: (R, 32))."""
    lane = torch.arange(32)
    size = 2
    while size <= 32:
        j = size // 2
        while j:
            x = _cx(x, j, ((lane & j) == 0) == (((lane & size) == 0) | (size == 32)))
            j //= 2
        size *= 2
    return x


def merge_desc(t):
    """A bitonic sequence of P keys (t: (R, P)) sorted descending."""
    e = torch.arange(t.shape[1])
    j = t.shape[1] // 2
    while j:
        t = _cx(t, j, (e & j) == 0)
        j //= 2
    return t


def merge_chunk(t, x):
    """Merge 32 keys a row into the sorted sets t (the kernel's merge_chunk)."""
    x = sort32_desc(x).flip(1)
    t = t.clone()
    t[:, -32:] = torch.maximum(t[:, -32:], x)
    return merge_desc(t)


def tile_scores(q, b, rows, distance, row_scale):
    """Scores of `rows` as the kernel's epilogue gives them (f32 sums of
    float products; int8 x int8 the exact integer sum rounded to f32 once;
    then one f32 rounding for the row scale or the l2 bias)."""
    s = dot_scores(q, b[rows])
    if row_scale is not None:
        s = s * row_scale[rows]
    if distance == "l2":
        s = s - l2_bias(b)[rows]
    return s


class SelectSet:
    """One partial set of each query: the sorted set (P keys), its buffer
    (BUF keys, `cnt` of them filled) and the flushes, in the kernel's order."""

    BUF = 160

    def __init__(self, n_q, s):
        self.p = 32 * (4 if s == 3 else s)
        self.top = torch.full((n_q, self.p), EMPTY, dtype=torch.int64)
        self.buf = torch.full((n_q, self.BUF), NONE, dtype=torch.int64)
        self.cnt = torch.zeros(n_q, dtype=torch.int64)

    def minimum(self):
        return self.top[:, -1]

    def add_tile(self, keys, floor):
        """Append each row's keys above its floor, in column order, to its
        buffer; merge the buffers that reached FLUSH_AT."""
        mask = keys > torch.maximum(self.minimum(), floor)[:, None]
        pos = self.cnt[:, None] + torch.cumsum(mask, 1) - 1
        r, c = mask.nonzero(as_tuple=True)
        self.buf[r, pos[r, c]] = keys[r, c]
        self.cnt += mask.sum(1)
        assert int(self.cnt.max()) <= self.BUF
        self.flush(FLUSH_AT, floor)

    def flush(self, at, floor):
        """Merge the buffers of the rows holding at least `at` keys, 32 at a
        time, each chunk's keys at or below the set's current floor dropped."""
        rows = (self.cnt >= at).nonzero(as_tuple=True)[0]
        if rows.numel() == 0:
            return
        t, b, n = self.top[rows], self.buf[rows], self.cnt[rows]
        col = torch.arange(32)
        for j in range(self.BUF // 32):
            lo = torch.maximum(t[:, -1], floor[rows])
            x = b[:, 32 * j:32 * j + 32]
            x = torch.where((x > lo[:, None]) & (col < n[:, None] - 32 * j), x, NONE)
            if (x != NONE).any():  # a row with none merges to itself
                t = merge_chunk(t, x)
        self.top[rows] = t
        self.buf[rows] = NONE
        self.cnt[rows] = 0


def batched_select(q, b, k, split_rows, *, valid_rows=None, distance="dot_product",
                   row_scale=None, share=True):
    """The wgmma kernel's result in plain torch: the valid rows cut into
    splits, two partial sets a split over its 128-row tiles w, w + 2, ...,
    the sets of a query sharing their published minimum (`share`: the sets
    advance one tile each in turn, each publishing after its tile), then
    the k best of the partial sets' top-(32·S), value descending, index
    ascending."""
    n_q = q.shape[0]
    valid = b.shape[0] if valid_rows is None else valid_rows
    s = -(-k // 32)
    walks, sets = [], []
    for r0 in range(0, max(valid, 1), split_rows):
        r1 = min(valid, r0 + split_rows)
        tiles = list(range(r0, r1, 128))
        for w in range(2):
            walks.append(tiles[w::2])
            sets.append(SelectSet(n_q, s))
    pub = torch.full((n_q,), NONE, dtype=torch.int64)
    for step in range(max(len(w) for w in walks)):
        for walk, st in zip(walks, sets):
            if step < len(walk):
                rows = torch.arange(walk[step], min(walk[step] + 128, valid))
                keys = make_keys(tile_scores(q, b, rows, distance, row_scale), rows.expand(n_q, -1))
                st.add_tile(keys, pub if share else torch.full_like(pub, NONE))
                if share:
                    pub = torch.maximum(pub, st.minimum())
    for st in sets:
        st.flush(1, pub if share else torch.full_like(pub, NONE))
    parts = torch.cat([st.top[:, :32 * s] for st in sets], dim=1)
    best = torch.sort(parts, dim=1, descending=True).values[:, :k]
    vals = key_value(best)
    idx = torch.where(torch.isfinite(vals), key_index(best), torch.zeros_like(best))
    return vals, idx


def _tie_dense(form, n_q, m, d, seed):
    """Integer entries in {-1, 0, 1} (scores exact in any order, tied many
    ways): bf16 for dot and l2, int8 codes with seeded row scales for
    int8_rows."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randint(-1, 2, (n_q, d), generator=gen)
    b = torch.randint(-1, 2, (m, d), generator=gen)
    kw = {"distance": "l2"} if form == "l2" else {}
    if form in ("dot", "l2"):
        return q.bfloat16(), b.bfloat16(), kw
    if form == "int8_rows":
        kw["row_scale"] = 0.25 + torch.rand(m, generator=gen)
    return q.to(torch.int8), b.to(torch.int8), kw


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("form", ["dot", "l2", "int8", "int8_rows"])
def test_batched_select_equals_exact_knn_on_ties(form, k):
    """Tie-dense inputs, two bank splits (one ending off a tile edge), the
    sets sharing their minimum and not: exactly exact_knn's values and
    indices."""
    q, b, kw = _tie_dense(form, 24, 1100, 16, seed=k)
    for valid, split_rows, share in ((1100, 640, True), (1037, 512, False), (300, 384, True)):
        kv, ki = batched_select(q, b, k, split_rows, valid_rows=valid, share=share, **kw)
        pv, pi = exact_knn(q, b, k, valid_rows=valid, **kw)
        assert torch.equal(kv, pv) and torch.equal(ki, pi), (valid, split_rows, share)


def wide_codes(n, d, gen, low=126):
    """int8 codes of magnitude low..127, every 7th column negated: at D =
    1,536 each exact score lies above 2^24 (so half of them are odd and
    round to f32), and a few thousand f32 values hold every score."""
    sign = torch.where(torch.arange(d) % 7 == 0, -1, 1)
    return (torch.randint(low, 128, (n, d), generator=gen) * sign).to(torch.int8)


@pytest.mark.parametrize("k", [33, 120])
@pytest.mark.parametrize("form", ["int8", "int8_rows"])
def test_batched_select_equals_exact_knn_on_wide_int8(form, k):
    """D = 1,536 (12 of the kernel's 128-deep chunks), scores that round
    once from past 2^24, so f32 ties are dense: exactly exact_knn's values
    and indices, over two splits, the sets sharing their minimum."""
    gen = torch.Generator().manual_seed(k)
    q, b = wide_codes(24, 1536, gen), wide_codes(1100, 1536, gen)
    kw = {"row_scale": 0.25 + torch.rand(1100, generator=gen)} if form == "int8_rows" else {}
    exact = q.long() @ b.long().T
    assert int(exact.min()) > 2**24 and (exact % 2 == 1).any()
    # tie-dense, and the rounding to f32 merges distinct sums
    assert len(torch.unique(exact.float())) < len(torch.unique(exact)) < exact.numel() // 4
    kv, ki = batched_select(q, b, k, 640, valid_rows=1037, **kw)
    pv, pi = exact_knn(q, b, k, valid_rows=1037, **kw)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


@pytest.mark.parametrize("k", KS)
def test_batched_select_fewer_valid_rows_than_k(k):
    """A split with fewer valid rows than k: the unfilled slots are (-inf, 0)."""
    q, b, kw = _tie_dense("int8", 8, 300, 16, seed=k + 1)
    kv, ki = batched_select(q, b, k, 128, valid_rows=k - 20, **kw)
    pv, pi = exact_knn(q, b, k, valid_rows=k - 20, **kw)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    assert torch.isinf(kv[:, k - 20:]).all() and (ki[:, k - 20:] == 0).all()


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("form", ["int8", "int8_rows"])
def test_batched_select_matches_pallas_knn(form, k):
    """Tie-dense int8 codes (in {-2, ..., 2}) against the TPU kernel in
    interpret mode: the same values as multisets."""
    gen = torch.Generator().manual_seed(7 * k)
    q = torch.randint(-2, 3, (16, 32), generator=gen, dtype=torch.int8)
    b = torch.randint(-2, 3, (700, 32), generator=gen, dtype=torch.int8)
    rs = 0.25 + torch.rand(700, generator=gen) if form == "int8_rows" else None
    kv, _ = batched_select(q, b, k, 256, valid_rows=650, row_scale=rs)
    jv, _ = pallas_knn(jnp.asarray(q.numpy()), jnp.asarray(b.numpy()), k, valid_rows=650,
                       row_scale=None if rs is None else jnp.asarray(rs.numpy()[:, None]),
                       block_q=8, block_m=256, interpret=True)
    np.testing.assert_array_equal(np.sort(kv.numpy(), 1), np.sort(np.asarray(jv), 1))


@pytest.mark.parametrize("p", [32, 64, 128])
def test_merge_chunk_keeps_the_top_of_set_and_chunk(p):
    """The network: a sorted set of P unique keys merged with 32 keys in any
    order (some of them none) is the top P of the union, sorted."""
    gen = torch.Generator().manual_seed(p)
    for _ in range(20):
        keys = torch.randperm(10_000, generator=gen)[:p + 32].to(torch.int64) * 7 - 30_000
        t = torch.sort(keys[:p], descending=True).values[None]
        x = keys[p:].clone()
        x[torch.rand(32, generator=gen) < 0.3] = NONE
        got = merge_chunk(t, x[None])[0]
        want = torch.sort(torch.cat([t[0], x]), descending=True).values[:p]
        assert torch.equal(got, want)


def test_keys_order_by_value_then_lower_index():
    """make_keys orders by value, then by lower column; -0 equals +0."""
    v = torch.tensor([1.5, 1.5, -2.0, 0.0, -0.0, float("-inf")])
    c = torch.tensor([7, 3, 0, 5, 2, 9])
    keys = make_keys(v, c)
    order = torch.argsort(keys, descending=True)
    assert order.tolist() == [1, 0, 4, 3, 2, 5]
    assert torch.equal(key_value(keys), v + 0.0) and torch.equal(key_index(keys), c)
    assert EMPTY > NONE and int(keys[5]) < EMPTY
