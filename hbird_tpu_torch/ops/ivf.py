"""IVF (leaf-partitioned) approximate kNN: ScaNN's tree() in PyTorch.

Counterpart of hbird_tpu/ops/ivf.py (the build, the search, and the plain
version of its TPU kernel `_ivf_kernel`; the kernel itself is K2,
ops/ivf_cuda.py). The reference's ScaNN backend prunes the scan with a
k-means tree, `tree(num_leaves=512, num_leaves_to_search=32)` (reference
hbird/nn/search_scann.py:26-27):

- **Spherical k-means** on a row sample trains `num_leaves` centroids
  (bank rows are unit-norm, so dot == cosine).
- **Capacity-balanced layout**: every leaf owns exactly `cap` bank slots.
  Rows go to their best leaf with free space, else their next choices,
  else any leaf with room, so the bank reorders into a dense
  (n_leaves * cap, D) array where leaf i is rows [i*cap, (i+1)*cap) and
  the first `leaf_valid[i]` of them are real.
- **Block-level probing**: queries are processed in tiles of `block_q`
  (sorted by primary leaf, so a tile shares leaf affinity); each tile
  scans the union top-`n_probe` leaves by per-tile max centroid score.
  Per-query probing (`probe_mode='query'`) scans each query's own leaves.
- **Search**: K2 (`ivf_topk`) on CUDA tensors, `ivf_search_plain` on CPU
  tensors.
- **Streamed build** (`build_tree_streamed`): the same tree from a
  re-iterable stream of row windows (a .bankdir read from disk), in three
  passes, so the device holds the slabs and one window, never the flat bank.

Results order by value descending, then IVF slot ascending (the JAX
package's XLA path breaks ties by probe order, its Pallas kernel by carry
slot). Wherever the JAX package takes `lax.top_k` or `argsort` over leaves
or candidates, this module takes a stable sort or the first maximum.
There is no jit here, so the JAX package's compile-shape bucketing
(padded assignment blocks, dummy per-query tiles) has no counterpart.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from hbird_tpu_torch.utils.logging import get_logger

NEG_INF = float("-inf")
_SENTINEL = 2**62  # id of invalid candidates in _dedup_topk; no slot reaches it


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextmanager
def phase_seconds(times: Optional[Dict[str, float]], name: str, device: torch.device):
    """Add the wall time of the block (device work included) to times[name]."""
    if times is None:
        yield
        return
    _sync(device)
    t0 = time.perf_counter()
    yield
    _sync(device)
    times[name] = times.get(name, 0.0) + time.perf_counter() - t0


# ----------------------------------------------------------------------
# Build: centroids, balanced assignment, layout
# ----------------------------------------------------------------------
_ONEHOT_ELEMS = 1 << 26  # largest one-hot block of _leaf_sums (256 MB of f32)


def _leaf_sums(x: torch.Tensor, assign: torch.Tensor, n_leaves: int):
    """Per-leaf sums of the rows of x and member counts, as one-hot
    products over row blocks of at most _ONEHOT_ELEMS entries, added in
    block order: the same bits in every run on the card, where index_add_
    adds with atomics in no fixed order (and k-means would drift between
    runs)."""
    step = max(1, _ONEHOT_ELEMS // n_leaves)
    sums = torch.zeros((n_leaves, x.shape[1]), dtype=torch.float32, device=x.device)
    cnt = torch.zeros(n_leaves, dtype=torch.float32, device=x.device)
    for i in range(0, x.shape[0], step):
        a = assign[i : i + step]
        onehot = torch.zeros((a.shape[0], n_leaves), dtype=torch.float32, device=x.device)
        onehot.scatter_(1, a[:, None], 1.0)
        sums += onehot.T @ x[i : i + step]
        cnt += onehot.sum(dim=0)
    return sums, cnt


def _new_centroids(sums, cnt, c, spherical):
    """Mean of each leaf's members (empty leaves keep their centroid)."""
    cnt = cnt[:, None]
    newc = torch.where(cnt > 0, sums / torch.clamp(cnt, min=1.0), c)
    if spherical:
        newc = newc / torch.clamp(torch.linalg.vector_norm(newc, dim=1, keepdim=True), min=1e-12)
    return newc


def train_centroids(
    sample: torch.Tensor,
    n_leaves: int,
    *,
    iters: int = 12,
    generator: Optional[torch.Generator] = None,
    init=None,
    spherical: bool = True,
) -> torch.Tensor:
    """Lloyd's k-means on a row sample (matmul assign, then `_leaf_sums`'
    one-hot update, which repeats bit for bit on the card).

    The initial centroids are `n_leaves` sample rows: `init` (row indices)
    when given, else drawn from `generator` (a CPU generator; without
    replacement unless the sample has fewer rows than leaves, like
    `jax.random.choice`). spherical=True re-normalizes centroids each
    iteration. Empty leaves keep their previous centroid.
    """
    sample = sample.float()
    s_n = sample.shape[0]
    if init is None:
        if s_n >= n_leaves:
            init = torch.randperm(s_n, generator=generator)[:n_leaves]
        else:
            init = torch.randint(s_n, (n_leaves,), generator=generator)
    init = torch.as_tensor(np.array(init), dtype=torch.int64, device=sample.device)
    c = sample[init]
    for _ in range(iters):
        a = torch.argmax(sample @ c.T, dim=1)
        c = _new_centroids(*_leaf_sums(sample, a, n_leaves), c, spherical)
    return c


def refine_centroids_balanced(
    sample: torch.Tensor,
    centroids: torch.Tensor,
    *,
    slack: float,
    rounds: int = 2,
    spherical: bool = True,
) -> torch.Tensor:
    """Capacity-aware k-means refinement: each round re-fits every centroid
    to the members its leaf would actually hold under the capacity
    constraint (score-priority balanced placement on the sample)."""
    n_leaves = centroids.shape[0]
    s_n = sample.shape[0]
    cap_s = max(1, int(np.ceil(s_n * slack / n_leaves)))
    sample = sample.float()
    c = centroids
    for _ in range(rounds):
        choices, scores = assign_leaves(sample, c, n_choices=3, return_scores=True)
        slots, _fill = balanced_layout(choices, n_leaves, cap_s, scores=scores)
        leaf = torch.as_tensor(slots // cap_s, dtype=torch.int64, device=sample.device)
        c = _new_centroids(*_leaf_sums(sample, leaf, n_leaves), c, spherical)
    return c


def _assign_block(rows: torch.Tensor, c_t: torch.Tensor, a: int):
    """Top-`a` leaf ids + scores for one row block, by iterated argmax (the
    first maximum on ties, as jnp.argmax)."""
    s = rows.float() @ c_t
    ids, tops = [], []
    for _ in range(a):
        top = torch.argmax(s, dim=1)
        ids.append(top)
        tops.append(torch.gather(s, 1, top[:, None])[:, 0])
        s.scatter_(1, top[:, None], NEG_INF)
    return torch.stack(ids, dim=1), torch.stack(tops, dim=1)


def assign_leaves(
    bank: torch.Tensor,
    centroids: torch.Tensor,
    n_choices: int = 3,
    block_rows: int = 1 << 18,
    return_scores: bool = False,
):
    """Top-`n_choices` leaf preferences per bank row: (M, A) int32 numpy
    (+ the matching (M, A) f32 centroid scores when `return_scores`),
    computed blockwise on the bank's device."""
    c_t = centroids.float().T
    a = min(n_choices, centroids.shape[0])
    m = bank.shape[0]
    out = np.empty((m, a), np.int32)
    sc = np.empty((m, a), np.float32)
    for i in range(0, m, block_rows):
        ids, scores = _assign_block(bank[i : i + block_rows], c_t, a)
        out[i : i + ids.shape[0]] = ids.cpu().numpy()
        sc[i : i + ids.shape[0]] = scores.cpu().numpy()
    return (out, sc) if return_scores else out


def balanced_layout(
    choices: np.ndarray,
    n_leaves: int,
    cap: int,
    scores: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Place every row into a leaf slot honoring per-leaf capacity.

    choices: (M, A) per-row leaf preferences (best first).
    scores: optional (M, A) centroid scores. When given, an overfull leaf
        keeps its HIGHEST-scoring members and spills its weakest — the
        spilled rows are exactly those whose next choice is nearly as
        good, so the recall cost of capacity pressure is minimized.
    Returns (slots (M,) int64 in [0, n_leaves*cap), leaf_fill (n_leaves,)).
    Requires n_leaves * cap >= M. Rows that fit none of their choices go
    to arbitrary leaves with room (they are still found whenever that
    leaf is probed; the recall effect is measured, not assumed).
    """
    m, n_choice = choices.shape
    assert n_leaves * cap >= m, (n_leaves, cap, m)
    slot = np.full(m, -1, np.int64)
    fill = np.zeros(n_leaves, np.int64)
    unplaced = np.arange(m)

    def place(rows: np.ndarray, leaf: np.ndarray, respect_room: bool,
              prio: Optional[np.ndarray] = None):
        nonlocal unplaced
        if prio is not None:
            order = np.lexsort((-prio, leaf))  # by leaf, strongest first
        else:
            order = np.argsort(leaf, kind="stable")
        ls = leaf[order]
        starts = np.searchsorted(ls, np.arange(n_leaves))
        rank = np.arange(ls.size) - starts[ls]
        ok = rank < (cap - fill)[ls] if respect_room else np.ones(ls.size, bool)
        rows_ok = rows[order[ok]]
        lf = ls[ok]
        slot[rows_ok] = lf * cap + fill[lf] + rank[ok]
        fill[:] += np.bincount(lf, minlength=n_leaves)
        return rows[order[~ok]]

    for a in range(n_choice):
        if unplaced.size == 0:
            break
        unplaced = place(
            unplaced,
            choices[unplaced, a],
            respect_room=True,
            prio=scores[unplaced, a] if scores is not None else None,
        )
    if unplaced.size:
        room = (cap - fill).clip(min=0)
        spill_leaf = np.repeat(np.arange(n_leaves), room)[: unplaced.size]
        leftover = place(unplaced, spill_leaf, respect_room=False)
        assert leftover.size == 0
    return slot, fill


def build_ivf_arrays(
    bank: torch.Tensor,
    labels: Optional[torch.Tensor],
    slots: np.ndarray,
    n_leaves: int,
    cap: int,
):
    """Copy rows into the dense leaf layout with `index_copy_` into
    preallocated tensors (peak: the bank plus its slabs).

    Returns (ivf_bank (n_leaves*cap, D), ivf_labels (f32) or None, perm
    (n_leaves*cap,) int64 original row id, -1 for padding). Padding slots
    stay zero; leaf_valid masks them.
    """
    m, d = bank.shape
    n_slots = n_leaves * cap
    dev = bank.device
    slots_t = torch.as_tensor(slots, dtype=torch.int64, device=dev)
    ivf_bank = torch.zeros((n_slots, d), dtype=bank.dtype, device=dev).index_copy_(
        0, slots_t, bank
    )
    ivf_labels = None
    if labels is not None:
        ivf_labels = torch.zeros(
            (n_slots, labels.shape[1]), dtype=torch.float32, device=dev
        ).index_copy_(0, slots_t, labels.float())
    perm = torch.full((n_slots,), -1, dtype=torch.int64, device=dev).index_copy_(
        0, slots_t, torch.arange(m, device=dev)
    )
    return ivf_bank, ivf_labels, perm


def tree_layout(n_rows: int, num_leaves: int, slack: float = 1.3) -> Tuple[int, int]:
    """(n_leaves, cap) for a bank of n_rows: per-leaf capacity sized with
    `slack` headroom (capacity/mean-leaf-size; higher = fewer rows pushed
    off their best leaf, more padded scan), rounded up to 256 rows."""
    num_leaves = max(1, min(num_leaves, n_rows))
    cap = _round_up(max(1, int(np.ceil(n_rows * slack / num_leaves))), 256)
    return num_leaves, cap


def full_bank_lloyd(
    bank: torch.Tensor,
    centroids: torch.Tensor,
    *,
    iters: int = 2,
    block_rows: int = 1 << 18,
    spherical: bool = True,
) -> torch.Tensor:
    """Lloyd's k-means over the full bank, blockwise: upgrades
    sample-trained centroids when the sample is a small fraction of the
    bank. The (rows, n_leaves) score block never exceeds block_rows x
    n_leaves."""
    n_leaves, d = centroids.shape
    c = centroids.float()
    m = bank.shape[0]
    for _ in range(iters):
        sums = torch.zeros((n_leaves, d), dtype=torch.float32, device=c.device)
        cnt = torch.zeros(n_leaves, dtype=torch.float32, device=c.device)
        for i in range(0, m, block_rows):
            x = bank[i : i + block_rows].float()
            blk_sums, blk_cnt = _leaf_sums(x, torch.argmax(x @ c.T, dim=1), n_leaves)
            sums += blk_sums
            cnt += blk_cnt
        c = _new_centroids(sums, cnt, c, spherical)
    return c


def build_tree_streamed(
    slab_stream,
    n_rows: int,
    num_leaves: int,
    *,
    slack: float = 1.3,
    n_choices: int = 3,
    kmeans_iters: int = 12,
    refine_rounds: int = 2,
    sample_rows: int = 131072,
    seed: int = 0,
    mesh=None,
):
    """The tree's arrays from a re-iterable stream of row windows, without
    the flat bank: three passes over the stream.

    1. Sample: the rows the flat build samples (the same numpy draw over
       global rows, in the same order), then k-means (its init from a CPU
       generator seeded with `seed`) and the capacity refinement.
    2. Assign: each window's top `n_choices` leaves, then the host greedy
       layout over all rows.
    3. Scatter: each window copied into the preallocated slabs.

    `slab_stream` is a zero-argument callable returning an iterator of
    (rows (n, D), labels (n, C) or None) tensors in the tree's store dtype,
    identical on every call (windows read from disk again, or a seeded
    generator), on the device that builds the tree: it holds the slabs and
    one window, never the flat bank. `mesh` is not ported yet (the next slice).

    Returns dict(ivf_bank, ivf_labels, centroids, perm, slots, leaf_fill
    (tensors on the device; perm, slots int64, leaf_fill int32), cap,
    n_leaves, valid_rows, build_seconds (wall time of each stage)).
    """
    if mesh is not None:
        from hbird_tpu_torch.nn.search_base import NEXT_SLICE, not_ported

        raise not_ported("the meshed streamed tree build", NEXT_SLICE)
    n_leaves, cap = tree_layout(n_rows, num_leaves, slack=slack)
    n_slots = n_leaves * cap
    times: Dict[str, float] = {}

    # Pass 1: the sample, in the order of the draw.
    sel = np.random.default_rng(seed).choice(n_rows, min(sample_rows, n_rows), replace=False)
    sample = None
    pos = 0
    for rows, _ in slab_stream():
        n = rows.shape[0]
        if sample is None:
            dev = rows.device
            sample = torch.empty((sel.size, rows.shape[1]), dtype=torch.float32, device=dev)
        hit = np.nonzero((sel >= pos) & (sel < pos + n))[0]
        if hit.size:
            sample[torch.as_tensor(hit, device=dev)] = rows[torch.as_tensor(sel[hit] - pos, device=dev)].float()
        pos += n
    if pos != n_rows:
        raise ValueError(f"slab_stream yielded {pos} rows, n_rows says {n_rows}")
    with phase_seconds(times, "kmeans", dev):
        centroids = train_centroids(
            sample, n_leaves, iters=kmeans_iters, generator=torch.Generator().manual_seed(seed)
        )
    if refine_rounds > 0:
        with phase_seconds(times, "refine", dev):
            centroids = refine_centroids_balanced(sample, centroids, slack=slack, rounds=refine_rounds)
    del sample

    # Pass 2: leaf choices per window, then the layout over all rows.
    choices = np.empty((n_rows, n_choices), np.int32)
    scores = np.empty((n_rows, n_choices), np.float32)
    pos = 0
    with phase_seconds(times, "assign", dev):
        for rows, _ in slab_stream():
            n = rows.shape[0]
            choices[pos : pos + n], scores[pos : pos + n] = assign_leaves(
                rows, centroids, n_choices=n_choices, return_scores=True
            )
            pos += n
    with phase_seconds(times, "layout", dev):
        slots, fill = balanced_layout(choices, n_leaves, cap, scores=scores)
    del choices, scores

    # Pass 3: each window into its slots.
    slots_t = torch.as_tensor(slots, dtype=torch.int64, device=dev)
    ivf_bank = ivf_labels = None
    pos = 0
    with phase_seconds(times, "scatter", dev):
        for rows, labs in slab_stream():
            n = rows.shape[0]
            sl = slots_t[pos : pos + n]
            if ivf_bank is None:
                ivf_bank = torch.zeros((n_slots, rows.shape[1]), dtype=rows.dtype, device=dev)
            ivf_bank.index_copy_(0, sl, rows)
            if labs is not None:
                if ivf_labels is None:
                    ivf_labels = torch.zeros((n_slots, labs.shape[1]), dtype=torch.float32, device=dev)
                ivf_labels.index_copy_(0, sl, labs.to(dev).float())
            pos += n
    if ivf_labels is None:
        ivf_labels = torch.zeros((n_slots, 1), dtype=torch.float32, device=dev)
    perm = torch.full((n_slots,), -1, dtype=torch.int64, device=dev)
    perm[slots_t] = torch.arange(n_rows, device=dev)
    return dict(
        ivf_bank=ivf_bank,
        ivf_labels=ivf_labels,
        centroids=centroids,
        perm=perm,
        slots=slots_t,
        leaf_fill=torch.as_tensor(fill, dtype=torch.int32, device=dev),
        cap=cap,
        n_leaves=n_leaves,
        valid_rows=n_rows,
        build_seconds=times,
    )


# ----------------------------------------------------------------------
# Search: block-level leaf selection + probed-leaf scan
# ----------------------------------------------------------------------
def _top_leaves(scores: torch.Tensor, n: int) -> torch.Tensor:
    """Indices of the n largest per row, largest first, lowest index on
    ties (lax.top_k's order)."""
    return torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :n]


def select_block_leaves(
    q_pad: torch.Tensor, centroids: torch.Tensor, n_probe: int, block_q: int
) -> torch.Tensor:
    """Top-`n_probe` leaves per query TILE by the tile's max centroid
    score: (n_tiles, n_probe) int32. q_pad rows must be a multiple of
    block_q."""
    n_leaves = centroids.shape[0]
    n_probe = min(n_probe, n_leaves)
    qc = q_pad.float() @ centroids.float().T  # (Q, K)
    qb = qc.reshape(-1, block_q, n_leaves).amax(dim=1)  # (tiles, K)
    return _top_leaves(qb, n_probe).to(torch.int32)


def coherent_query_order(q: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Stable order grouping queries by their top-1 leaf (block-level
    probing needs leaf-coherent query tiles)."""
    top1 = torch.argmax(q.float() @ centroids.float().T, dim=1)
    return torch.sort(top1, stable=True).indices


def tile_coherence(queries: torch.Tensor, centroids: torch.Tensor, block_q: int) -> float:
    """Mean distinct primary leaves per (sorted) query tile — the quantity
    that governs block-probing recall: a tile whose queries span more
    primary leaves than `n_probe` cannot cover every query's best leaf."""
    top1 = np.sort(
        torch.argmax(queries.float() @ centroids.float().T, dim=1).cpu().numpy()
    )
    pad = (-top1.size) % block_q
    if pad:
        top1 = np.concatenate([top1, np.full(pad, top1[-1])])
    tiles = top1.reshape(-1, block_q)
    distinct = (np.diff(tiles, axis=1) != 0).sum(axis=1) + 1
    return float(distinct.mean())


def tile_probe_inputs(
    queries: torch.Tensor,
    centroids: torch.Tensor,
    *,
    n_probe: int,
    block_q: int,
    sort_queries: bool = True,
):
    """What tile probing hands the scan: the queries grouped by primary
    leaf and edge-padded to a multiple of block_q, their (n_tiles, n_probe)
    leaf ids, and the inverse order (None when unsorted)."""
    inv = None
    if sort_queries:
        order = coherent_query_order(queries, centroids)
        inv = torch.argsort(order)
        queries = queries[order]
    q_n = queries.shape[0]
    pad = _round_up(q_n, block_q) - q_n
    if pad:
        # Edge padding (repeat the last query): zero rows would vote score 0
        # for every leaf in the last tile's shortlist.
        queries = torch.cat([queries, queries[-1:].expand(pad, -1)])
    lids = select_block_leaves(queries, centroids, n_probe, block_q)
    return queries.contiguous(), lids, inv


def ivf_search_plain(
    queries: torch.Tensor,
    ivf_bank: torch.Tensor,
    leaf_ids: torch.Tensor,
    leaf_valid: torch.Tensor,
    k: int,
    *,
    cap: int,
    row_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K2 (counterpart of ivf_search_xla): per query
    tile, gather the valid rows of the probed slabs in slot order, take f32
    products (bf16 and int8 inputs widened; int8 x int8 sums are exact
    integers), multiply each by its slot's `row_scale` when given, and keep
    the top k by a stable sort (value descending, then slot ascending).
    queries rows must be a multiple of the leaf_ids tile count.

    Returns (values (Q, k) f32, IVF slot ids (Q, k) int64); unfilled slots
    are (-inf, 0).
    """
    q_n, _ = queries.shape
    tiles = leaf_ids.shape[0]
    block_q = q_n // max(tiles, 1)
    dev = queries.device
    lids = leaf_ids.to(torch.int64)
    lv = leaf_valid.to(torch.int64)
    col_local = torch.arange(cap, device=dev)
    scale = None if row_scale is None else row_scale.reshape(-1).float()
    out_v = torch.full((q_n, k), NEG_INF, dtype=torch.float32, device=dev)
    out_i = torch.zeros((q_n, k), dtype=torch.int64, device=dev)
    for t in range(tiles):
        slabs = lids[t]
        cols = (slabs[:, None] * cap + col_local)[col_local < lv[slabs][:, None]]
        cols = torch.sort(cols).values
        q_t = queries[t * block_q : (t + 1) * block_q].float()
        scores = q_t @ ivf_bank[cols].float().T
        if scale is not None:
            scores = scores * scale[cols]
        sv, order = torch.sort(scores, dim=1, descending=True, stable=True)
        n = min(k, cols.numel())
        rows = slice(t * block_q, (t + 1) * block_q)
        out_v[rows, :n] = sv[:, :n]
        out_i[rows, :n] = cols[order[:, :n]]
    return out_v, out_i


def ivf_search(
    queries: torch.Tensor,
    ivf_bank: torch.Tensor,
    centroids: torch.Tensor,
    leaf_valid: torch.Tensor,
    k: int,
    *,
    cap: int,
    n_probe: int,
    block_q: int = 256,
    sort_queries: bool = True,
    probe_mode: str = "tile",
    row_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full IVF search: (group) -> probe -> scan (K2) -> (ungroup).

    Queries may be int8 codes or bf16 against an int8 tree, with the
    per-slot `row_scale` of its int8_rows slabs; leaves are chosen from the
    queries as handed in, cast to f32.

    probe_mode:
    - 'tile' (default): the union-shortlist block probing above — correct
      recall at engine query density (leaf-coherent tiles).
    - 'query': true per-query probing (ScaNN's leaves_to_search semantics)
      — every query scans its own top `n_probe` leaves.
    - 'auto': measure tile coherence and pick. (The JAX package resolves
      'auto' to 'tile' under jit; the engine passes 'tile' itself.)

    Returns (values (Q, k) f32, indices (Q, k) int64 in IVF layout).
    """
    from hbird_tpu_torch.ops.ivf_cuda import ivf_topk

    if probe_mode == "auto":
        coh = tile_coherence(queries, centroids, block_q)
        # A tile's shortlist has n_probe slots; leave headroom for
        # secondary leaves (a query's neighbours are rarely all in its
        # primary leaf).
        probe_mode = "query" if coh > max(2.0, n_probe / 2) else "tile"
        if probe_mode == "query":
            # Per-query probing materializes each query once per probed
            # leaf plus per-leaf tile padding; above 1 GB a low-coherence
            # query set stays on tile probing with a warning.
            dup_rows = (
                queries.shape[0] * min(n_probe, centroids.shape[0])
                + centroids.shape[0] * block_q
            )
            dup_bytes = dup_rows * queries.shape[1] * 4
            log = get_logger(__name__)
            if dup_bytes > 1 << 30:
                probe_mode = "tile"
                log.warning(
                    "ivf_search: low tile coherence (%.1f distinct primary "
                    "leaves/tile vs n_probe=%d) but the query set is too large "
                    "for per-query probing (%.1f GB duplicated); staying on tile "
                    "probing — recall may be diluted. Split the query set or "
                    "pass probe_mode='query' explicitly.",
                    coh, n_probe, dup_bytes / 2**30,
                )
            else:
                log.info(
                    "ivf_search: low tile coherence (%.1f distinct primary "
                    "leaves/tile vs n_probe=%d) — switching to per-query probing.",
                    coh, n_probe,
                )
    if probe_mode == "query":
        return ivf_search_per_query(
            queries, ivf_bank, centroids, leaf_valid, k,
            cap=cap, n_probe=n_probe, block_q=block_q, row_scale=row_scale,
        )
    if probe_mode != "tile":
        raise ValueError(f"probe_mode must be 'tile', 'query' or 'auto': {probe_mode!r}")
    q_n = queries.shape[0]
    q_pad, lids, inv = tile_probe_inputs(
        queries, centroids, n_probe=n_probe, block_q=block_q, sort_queries=sort_queries
    )
    vals, idx = ivf_topk(
        q_pad, ivf_bank, lids, leaf_valid, k, cap=cap, block_q=block_q, row_scale=row_scale
    )
    vals, idx = vals[:q_n], idx[:q_n]
    if inv is not None:
        vals, idx = vals[inv], idx[inv]
    return vals, idx


def ivf_search_per_query(
    queries: torch.Tensor,
    ivf_bank: torch.Tensor,
    centroids: torch.Tensor,
    leaf_valid: torch.Tensor,
    k: int,
    *,
    cap: int,
    n_probe: int,
    block_q: int = 128,
    row_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query probing: every query scans exactly its top-`n_probe`
    leaves. The (query, leaf) probe pairs are grouped by leaf on the host,
    each leaf's queries padded to `block_q` tiles, and K2 runs with one slab
    per tile; per-query results are regathered, deduplicated and top-k'd.
    """
    from hbird_tpu_torch.ops.ivf_cuda import ivf_topk

    q_n, _ = queries.shape
    dev = queries.device
    if q_n == 0:
        return (
            torch.zeros((0, k), dtype=torch.float32, device=dev),
            torch.zeros((0, k), dtype=torch.int64, device=dev),
        )
    n_leaves = centroids.shape[0]
    t = min(n_probe, n_leaves)
    kk = min(k, 128)
    q_leaves, _ = _assign_block(queries, centroids.float().T, t)
    q_leaves = q_leaves.cpu().numpy()

    # ---- host grouping: (query, leaf) pairs -> leaf-major padded tiles.
    pair_q = np.repeat(np.arange(q_n, dtype=np.int64), t)
    pair_l = q_leaves.reshape(-1)
    order = np.argsort(pair_l, kind="stable")
    sorted_l = pair_l[order]
    uniq, counts = np.unique(sorted_l, return_counts=True)
    tiles_per_leaf = -(-counts // block_q)  # ceil
    tile_leaf = np.repeat(uniq, tiles_per_leaf).astype(np.int32)
    group_sizes = tiles_per_leaf * block_q
    group_starts = np.concatenate(([0], np.cumsum(group_sizes)))[:-1]
    count_starts = np.concatenate(([0], np.cumsum(counts)))[:-1]
    leaf_of_sorted = np.searchsorted(uniq, sorted_l)
    rank = np.arange(sorted_l.size) - count_starts[leaf_of_sorted]
    pos_sorted = group_starts[leaf_of_sorted] + rank
    total = int(group_sizes.sum())
    q_sel = np.zeros(total, np.int64)  # padding rows re-scan query 0
    q_sel[pos_sorted] = pair_q[order]
    pair_pos = np.empty(pair_q.size, np.int64)
    pair_pos[order] = pos_sorted

    q_grouped = queries[torch.as_tensor(q_sel, device=dev)].contiguous()
    lids = torch.as_tensor(tile_leaf[:, None], device=dev)  # (T, 1): one slab per tile
    vals, idx = ivf_topk(
        q_grouped, ivf_bank, lids, leaf_valid, kk, cap=cap, block_q=block_q, row_scale=row_scale
    )

    # ---- regather per query, dedup, final top-k.
    pp = torch.as_tensor(pair_pos, device=dev)
    cand_vals = vals[pp].reshape(q_n, t * kk)
    cand_idx = idx[pp].reshape(q_n, t * kk)
    return _dedup_topk(cand_vals, cand_idx, k)


def _dedup_topk(cand_vals: torch.Tensor, cand_idx: torch.Tensor, k: int):
    """Top-k over candidate sets that may repeat bank rows (equal scores):
    keep the first occurrence of each idx, mask the rest to -inf."""
    # Invalid fillers (-inf with idx 0) must not collide with a real row-0
    # candidate in the dedup grouping: give them an id no slot reaches.
    cand_idx = torch.where(
        torch.isfinite(cand_vals), cand_idx, torch.full_like(cand_idx, _SENTINEL)
    )
    order = torch.sort(cand_idx, dim=1, stable=True).indices
    si = torch.gather(cand_idx, 1, order)
    sv = torch.gather(cand_vals, 1, order)
    dup = torch.cat(
        [torch.zeros_like(si[:, :1], dtype=torch.bool), si[:, 1:] == si[:, :-1]], dim=1
    )
    sv = torch.where(dup, torch.full_like(sv, NEG_INF), sv)
    sel = _top_leaves(sv, k)
    vals = torch.gather(sv, 1, sel)
    idx = torch.gather(si, 1, sel)
    # Trailing -inf slots: clamp the sentinel back to slot 0.
    idx = torch.where(idx >= _SENTINEL, torch.zeros_like(idx), idx)
    return vals, idx
