"""The streamed query chunks of K1's and K2's wgmma kernel, emulated on the CPU.

Where an item's 64 queries do not fit in shared memory (bf16 past D =
1,536, bf16 queries on int8 codes past 1,152, int8 x int8 past 3,072), the
kernel
(hbird_tpu_torch/ops/csrc/wgmma_topk.cuh, `Streamed<F>`) loads the item's
query chunk c into every ring stage beside chunk c of the bank tile, for
every tile. `run_item` plays one item in the kernel's order of work, in
either layout: the producer fills the two consumers' rings chunk by chunk,
the consumers' tiles in turn (consumer w takes the item's tiles w, w + 2,
...), the queries loaded once for the item (resident) or into each stage
(streamed); each consumer reads its stages in order, checks that a stage
holds the tile and chunk it scores, widens asym's codes exactly to bf16 and
adds each chunk's k16 products (int8: k32, exact integers) to the tile's
sum, chunk after chunk. Held here, for bf16 dot and l2, asym(_rows) and
int8(_rows):
- streamed and resident give every tile's sums bit for bit, on float
  queries too: the same products in the same order, only the place the
  query chunk is read from differs (D = 1,288: a partial last chunk);
- on integer inputs both equal the plain versions (`exact_knn`,
  `ivf_search_plain`) bit for bit, values and indices, for K1's bank
  splits and K2's probed ragged slabs, at D = 1,280 and 3,200 (bf16: 1,672,
  a partial last chunk past the resident edge);
- the rings: a streamed consumer holds a stage until its chunk's products
  are done while it waits for the next (asym widens chunk c + 1 under
  chunk c's products; bf16 and int8 free chunk c once chunk c + 1's
  products are issued), so a ring of one stage deadlocks and two suffice,
  which `stages_for` requires; resident asym releases each stage once
  widened, and bf16 and int8 on one stage take the kernel's one-stage
  path, so one suffices there;
- the shared memory (tests/wgmma_smem.py, the header's formula): the
  streamed forms fit at every depth with four stages a ring, the resident
  ones only up to D = 1,536 (bf16), 1,152 (asym) and 3,072 (int8), and every stage keeps the 1,024-byte alignment
  of the query chunk's swizzle.
The kernel against the plain version on the card: chip_smoke.py phases 2-3.
"""

import collections

import numpy as np
import pytest
import torch

import wgmma_smem
from hbird_tpu_torch.ops.ivf import ivf_search_plain
from hbird_tpu_torch.ops.knn import exact_knn

BQH, BMH = 64, 128
# form: (depth elements of a 128-byte chunk, of a wgmma k step)
CHUNKS = {"bf16": (64, 16), "asym": (64, 16), "int8": (128, 32)}


def box(x, r0, n_rows, c0, n_cols):
    """A TMA box of x: rows [r0, r0 + n_rows) and columns [c0, c0 +
    n_cols), zero past either end."""
    out = x.new_zeros((n_rows, n_cols))
    part = x[r0:r0 + n_rows, c0:c0 + n_cols]
    out[:part.shape[0], :part.shape[1]] = part
    return out


def chunk_products(acc, qc, bc, base, step):
    """One chunk's wgmma products added to the tile's sums, k step by k
    step: bf16 rows (asym's codes widened to bf16, exact) and f32 sums;
    int8 exact integer sums."""
    for k0 in range(0, qc.shape[1], step):
        a, b = qc[:, k0:k0 + step], bc[:, k0:k0 + step]
        if base == "int8":
            acc = acc + a.long() @ b.long().T
        else:
            acc = acc + a.float() @ b.to(torch.bfloat16).float().T
    return acc


def run_item(queries, bank, q_row0, tiles, base, streamed):
    """One item: the 64 queries from q_row0 against the 128-row tiles
    starting at `tiles`, in the kernel's order of work. Returns {tile's
    first row: its (64, 128) sums}, converted to f32 once."""
    dk, step = CHUNKS[base]
    n_chunks = -(-queries.shape[1] // dk)
    resident = None if streamed else [box(queries, q_row0, BQH, c * dk, dk) for c in range(n_chunks)]
    rings = [collections.deque(), collections.deque()]
    for i in range(0, len(tiles), 2):  # the producer: two tiles at a time, chunk by chunk, in turn
        for c in range(n_chunks):
            for w, row0 in enumerate(tiles[i:i + 2]):
                stage = {"tile": row0, "chunk": c, "codes": box(bank, row0, BMH, c * dk, dk)}
                if streamed:
                    stage["queries"] = box(queries, q_row0, BQH, c * dk, dk)
                rings[w].append(stage)
    sums = {}
    for w in (0, 1):
        for row0 in tiles[w::2]:
            acc = torch.zeros((BQH, BMH), dtype=torch.int64 if base == "int8" else torch.float32)
            for c in range(n_chunks):
                stage = rings[w].popleft()
                assert (stage["tile"], stage["chunk"]) == (row0, c)
                qc = stage["queries"] if streamed else resident[c]
                acc = chunk_products(acc, qc, stage["codes"], base, step)
            sums[row0] = acc.float()
    assert not rings[0] and not rings[1]
    return sums


def topk(scores, cols, k):
    """The k best of each row: value descending, then column ascending;
    unfilled slots (-inf, 0)."""
    order = torch.argsort(cols, dim=1, stable=True)
    scores, cols = torch.gather(scores, 1, order), torch.gather(cols, 1, order)
    v, o = torch.sort(scores, dim=1, descending=True, stable=True)
    i = torch.gather(cols, 1, o)
    pad = max(0, k - v.shape[1])
    v = torch.cat([v, torch.full((v.shape[0], pad), float("-inf"))], 1)[:, :k]
    i = torch.cat([i, torch.zeros((i.shape[0], pad), dtype=torch.int64)], 1)[:, :k]
    return v, torch.where(torch.isinf(v), 0, i)


def k1_streamed(queries, bank, k, valid, split_rows, base, row_scale=None, bias=None):
    """K1 over Flat items (64-query tile, bank split of split_rows), the
    queries streamed; columns past `valid` never selected. The epilogue:
    times `row_scale` or minus `bias` (l2), when given."""
    n_q = queries.shape[0]
    scores = torch.full((n_q, valid), float("-inf"))
    for q0 in range(0, n_q, BQH):
        for r0 in range(0, valid, split_rows):
            end = min(valid, r0 + split_rows)
            for row0, s in run_item(queries, bank, q0, list(range(r0, end, BMH)), base, True).items():
                n = min(BMH, end - row0)
                t = s[:, :n] if row_scale is None else s[:, :n] * row_scale[row0:row0 + n]
                t = t if bias is None else t - bias[row0:row0 + n]
                scores[q0:q0 + BQH, row0:row0 + n] = t[:n_q - q0]
    return topk(scores, torch.arange(valid).expand(n_q, -1), k)


def k2_streamed(queries, bank, lids, lv, k, cap, block_q, base, row_scale=None):
    """K2 over Slabs items (64-query tile, all its tile's probes), the
    queries streamed: each probed slab's tiles up to its leaf_valid."""
    n_q = queries.shape[0]
    scores, slots = [[] for _ in range(n_q)], [[] for _ in range(n_q)]
    for q0 in range(0, n_q, BQH):
        tiles, n_cols = [], {}
        for s in lids[q0 // block_q].tolist():
            if 0 <= s < lv.shape[0]:
                for m0 in range(0, int(lv[s]), BMH):
                    tiles.append(s * cap + m0)
                    n_cols[s * cap + m0] = min(BMH, int(lv[s]) - m0)
        for row0, sm in run_item(queries, bank, q0, tiles, base, True).items():
            n = n_cols[row0]
            t = sm[:, :n] if row_scale is None else sm[:, :n] * row_scale[row0:row0 + n]
            for r in range(BQH):
                scores[q0 + r].append(t[r])
                slots[q0 + r].append(torch.arange(row0, row0 + n))
    width = max(sum(len(x) for x in row) for row in slots)
    v = torch.full((n_q, width), float("-inf"))
    i = torch.full((n_q, width), 2**40, dtype=torch.int64)  # pads sort last among -inf
    for r in range(n_q):
        if slots[r]:
            row_v, row_i = torch.cat(scores[r]), torch.cat(slots[r])
            v[r, :row_v.shape[0]], i[r, :row_i.shape[0]] = row_v, row_i
    return topk(v, i, k)


def integer_inputs(base, n_q, m, d, rng):
    """Queries and bank rows whose every sum is exact: bf16 queries in
    [-8, 8] on bf16 rows in [-16, 16] or on int8 codes (asym; |sum| < 2^24
    up to D = 16,000); int8 codes of magnitude 120-127 with every 7th
    column negated (past 2^24 at D = 1,280: one rounding of the exact
    integer)."""
    if base == "bf16":
        q = torch.from_numpy(rng.integers(-8, 9, size=(n_q, d)).astype(np.float32)).bfloat16()
        return q, torch.from_numpy(rng.integers(-16, 17, size=(m, d)).astype(np.float32)).bfloat16()
    if base == "int8":
        sign = np.where(np.arange(d) % 7 == 0, -1, 1)
        q, b = (rng.integers(120, 128, size=(n, d)) * sign for n in (n_q, m))
        return torch.from_numpy(q.astype(np.int8)), torch.from_numpy(b.astype(np.int8))
    q = torch.from_numpy(rng.integers(-8, 9, size=(n_q, d)).astype(np.float32)).bfloat16()
    return q, torch.from_numpy(rng.integers(-127, 128, size=(m, d)).astype(np.int8))


# form: the kernel form it runs (bf16 dot and l2 both run Bf16)
BASE = {"dot": "bf16", "l2": "bf16", "asym": "asym", "asym_rows": "asym", "int8": "int8",
        "int8_rows": "int8"}
# (form, depth) of the plain-version checks: asym and int8 at 1,280 and
# 3,200, bf16 at 1,672 (past the resident edge, a partial last chunk)
DEPTHS = [(form, d) for form in ("asym", "asym_rows", "int8", "int8_rows") for d in (1280, 3200)]
BF16_DEPTH = 1672


@pytest.mark.parametrize("form", ["dot", "asym", "asym_rows", "int8", "int8_rows"])
def test_streamed_tiles_equal_resident(form):
    """Every tile's sums of one item, streamed against resident, bit for
    bit: normal bf16 queries (bf16 and asym; the f32 sums round) on normal
    bf16 rows or full-range codes, D = 1,288 (a partial last chunk), 5
    tiles (the last one short)."""
    base = BASE[form]
    rng = np.random.default_rng(7)
    d = 1288
    if base == "int8":
        q = torch.from_numpy(rng.integers(-128, 128, size=(BQH, d)).astype(np.int8))
    else:
        q = torch.from_numpy(rng.normal(size=(BQH, d)).astype(np.float32)).bfloat16()
    if base == "bf16":
        bank = torch.from_numpy(rng.normal(size=(600, d)).astype(np.float32)).bfloat16()
    else:
        bank = torch.from_numpy(rng.integers(-128, 128, size=(600, d)).astype(np.int8))
    tiles = list(range(0, 600, BMH))
    streamed = run_item(q, bank, 0, tiles, base, True)
    resident = run_item(q, bank, 0, tiles, base, False)
    assert streamed.keys() == resident.keys() == set(tiles)
    for row0 in tiles:
        assert torch.equal(streamed[row0], resident[row0])
    if base != "int8":  # the f32 sums do round: the check can tell another order
        exact = q.double() @ bank[:BMH].double().T
        assert not torch.equal(streamed[0], exact.float()[:, :BMH])


@pytest.mark.parametrize("form, d", DEPTHS + [("dot", BF16_DEPTH), ("l2", BF16_DEPTH)])
def test_streamed_k1_equals_plain(form, d):
    """K1 with streamed queries on integer inputs: 2 query tiles (the last
    partial) over 2 bank splits with invalid rows past 650, k = 30, bit for
    bit the plain version's values and indices (l2: minus the wrapper's
    bias, exact on integer rows)."""
    from hbird_tpu_torch.ops.knn import l2_bias

    base = BASE[form]
    rng = np.random.default_rng(d)
    q, bank = integer_inputs(base, 100, 700, d, rng)
    rs = torch.from_numpy((0.25 + rng.random(700)).astype(np.float32)) if form.endswith("_rows") else None
    bias = l2_bias(bank) if form == "l2" else None
    distance = "l2" if form == "l2" else "dot_product"
    kv, ki = k1_streamed(q, bank, 30, 650, 384, base, rs, bias)
    pv, pi = exact_knn(q, bank, 30, valid_rows=650, row_scale=rs, distance=distance)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


@pytest.mark.parametrize("form, d", DEPTHS + [("dot", BF16_DEPTH)])
def test_streamed_k2_equals_plain(form, d):
    """K2 with streamed queries on integer inputs: 2 query tiles of 64
    probing 4 of 6 ragged slabs of cap 256 (one empty, one id out of
    range), k = 30, bit for bit the plain version's values and slots."""
    base = BASE[form]
    rng = np.random.default_rng(2 * d)
    cap, lv = 256, torch.tensor([256, 131, 0, 200, 5, 256], dtype=torch.int32)
    q, bank = integer_inputs(base, 128, 6 * cap, d, rng)
    bank[(torch.arange(6 * cap) % cap) >= lv.long().repeat_interleave(cap)] = 0
    rs = torch.from_numpy((0.25 + rng.random(6 * cap)).astype(np.float32)) if form.endswith("_rows") else None
    lids = torch.tensor([[3, 0, 2, 5], [1, 4, 9, 0]], dtype=torch.int32)
    kv, ki = k2_streamed(q, bank, lids, lv, 30, cap, 64, base, rs)
    in_range = torch.where(lids < 6, lids, 2)  # the plain version indexes with the ids: an empty slab
    pv, pi = ivf_search_plain(q, bank, in_range, lv, 30, cap=cap, row_scale=rs)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


def tile_schedule(form, n_chunks, stages):
    """A consumer's stage operations for one tile: ('take', c) waits for
    chunk c's stage, ('free', c) hands it back to the producer.
    - streamed asym: chunk c + 1's codes are widened under chunk c's
      products, and chunk c's stage (its query chunk) is freed once they
      are done;
    - resident asym: a stage is freed once its codes are widened;
    - bf16 and int8 (resident or streamed): chunk c's stage is freed once
      chunk c + 1's products are issued and c's done (wgmma_wait<1>), or
      at once with one stage (the kernel's one-stage path; a form named
      "pipelined" keeps the wgmma_wait<1> schedule on any ring)."""
    pipelined = stages > 1 or form.endswith("pipelined")
    ops = []
    for c in range(n_chunks):
        if form == "streamed asym":
            ops += [("take", 0)] if c == 0 else []
            ops += [("take", c + 1)] if c + 1 < n_chunks else []
            ops.append(("free", c))
        elif form == "resident asym" or not pipelined:
            ops += [("take", c), ("free", c)]
        else:
            ops += [("take", c)] + ([("free", c - 1)] if c > 0 else [])
    if form != "streamed asym" and form != "resident asym" and pipelined:
        ops.append(("free", n_chunks - 1))
    return ops


def ring_completes(form, n_tiles, n_chunks, stages):
    """The producer and the two consumers of one item on rings of
    `stages`: the producer fills ring w's next stage only while the ring
    has a stage neither filled nor held; True if every tile is scored,
    False on a deadlock."""
    producer = [w for i in range(0, n_tiles, 2) for _ in range(n_chunks) for w in range(min(2, n_tiles - i))]
    consumers = [[op for _ in range(w, n_tiles, 2) for op in tile_schedule(form, n_chunks, stages)]
                 for w in (0, 1)]
    filled, held, at = [0, 0], [0, 0], [0, 0]
    while producer or at[0] < len(consumers[0]) or at[1] < len(consumers[1]):
        moved = False
        if producer and filled[producer[0]] + held[producer[0]] < stages:
            filled[producer.pop(0)] += 1
            moved = True
        for w in (0, 1):
            if at[w] < len(consumers[w]):
                op, _ = consumers[w][at[w]]
                if op == "free":
                    held[w] -= 1
                elif filled[w]:
                    filled[w], held[w] = filled[w] - 1, held[w] + 1
                else:
                    continue
                at[w] += 1
                moved = True
        if not moved:
            return False
    return True


@pytest.mark.parametrize("form, stages, completes", [
    ("streamed asym", 1, False), ("streamed asym", 2, True), ("streamed asym", 4, True),
    ("resident asym", 1, True), ("streamed int8", 1, True), ("streamed int8", 2, True),
    ("streamed bf16, pipelined", 1, False), ("streamed bf16", 1, True), ("streamed bf16", 2, True),
    ("streamed bf16", 4, True),
])
def test_ring_stages_a_streamed_form_needs(form, stages, completes):
    """A streamed asym consumer holds two stages at once: one ring stage
    deadlocks, two complete (stages_for gives a streamed form at least
    two, and the streamed forms fit four). So does a streamed bf16 or int8
    consumer on its pipelined schedule (chunk c's stage held until chunk c
    + 1's products are issued); on one stage the kernel takes its one-stage
    path, which completes. Resident asym completes on one."""
    assert ring_completes(form, 5, 20, stages) == completes
    assert ring_completes(form, 1, 3, stages) == completes


@pytest.mark.parametrize("form", [wgmma_smem.BF16_FORM, wgmma_smem.ASYM_FORM, wgmma_smem.S8_FORM])
def test_streamed_forms_fit_every_depth(form):
    """The header's formula: resident queries fit up to D = 1,536 (bf16),
    1,152 (asym) and 3,072 (int8), and stay resident wherever they fit;
    streamed, every depth takes the same 197,888 bytes,
    four stages a ring; so the library reports a size at every depth (each
    multiple of 8, of 16 with int8 codes, to 4,096 and past); stages and
    rings keep 1,024-byte alignment, so the query chunk at a stage's start
    keeps its 128-byte swizzle's."""
    edge = {wgmma_smem.BF16_FORM: 1536, wgmma_smem.ASYM_FORM: 1152, wgmma_smem.S8_FORM: 3072}[form]
    step = 16 if form == wgmma_smem.S8_FORM or form == wgmma_smem.ASYM_FORM else 8
    for d in range(step, max(4097, 20 * edge), step):
        assert (wgmma_smem.smem_at(form, d) > 0) == (d <= edge), d
        assert wgmma_smem.smem_at(form, d, streamed=True) == 197_888
        assert wgmma_smem.smem(form, d) == (wgmma_smem.smem_at(form, d) if d <= edge else 197_888), d
    stage = wgmma_smem.FORMS[form][1] + wgmma_smem.Q_CHUNK
    assert stage % 1024 == 0 and wgmma_smem.Q_CHUNK % 1024 == 0
    assert 197_888 == (wgmma_smem.SMEM_ALIGN + wgmma_smem.FORMS[form][2] + wgmma_smem.BAR_BYTES
                       + 2 * wgmma_smem.MAX_STAGES * stage)
