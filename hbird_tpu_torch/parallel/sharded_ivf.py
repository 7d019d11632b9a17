"""The leaf-sharded IVF tree over a bank mesh: its build, and K2 once per shard.

Counterpart of hbird_tpu/parallel/sharded_ivf.py. The tree's leaf slabs
(ops/ivf.py: leaf i is slots [i·cap, (i+1)·cap)) split over the mesh's
'bank' axis into whole-leaf shards: shard s owns leaves [s·Ls, (s+1)·Ls)
(Ls = n_leaves / p, the tree geometry rounds n_leaves up to a multiple of
p) and its slab is slots [s·Ls·cap, (s+1)·Ls·cap). Shards are lists of
tensors, one per device of the axis (a device may repeat, parallel/mesh.py),
as in parallel/sharded_knn.py.

The search (`sharded_ivf_knn_with_labels`):
- the queries are put in coherent order by the replicated centroids and
  edge-padded to whole tiles;
- each shard picks its own top-`l_p` leaves per query tile among its
  centroids ('split': ceil(n_probe / p) each, so the total scan stays about
  n_probe slabs; 'full': min(n_probe, Ls) each, a superset of the unmeshed
  shortlist) and runs K2 (ops/ivf_cuda.py::ivf_topk) on its slab, with
  local leaf ids and its own row scales; every shard is launched before any
  result moves;
- the per-shard (Q, k) sets merge under the port's one tie rule (value
  descending, then slot ascending) and each label row comes from the shard
  that owns its winner (parallel/sharded_knn.py: merge_topk, fetch_labels).

The build (`build_ivf_sharded`), with nothing O(M) beyond a row shard on any
device:
1. `sharded_kmeans`: Lloyd's over the full bank, per-shard sums and counts
   (padding rows left out) added in shard order (the JAX package's psum;
   ops/ivf.py::full_bank_lloyd is its one-device twin);
2. `sharded_assign_leaves`: each row's top `n_choices` leaves, per shard;
3. the slot layout: 'host' gathers the (M, A) choices and scores and runs
   the unmeshed build's greedy (ops/ivf.py::balanced_layout): its slots are
   the unmeshed build's. 'device' keeps them sharded
   (`sharded_balanced_layout`): a per-leaf score threshold by 32 counting
   passes, exact ties by row id, and within each leaf the slots in
   shard-major order; leaf membership equals the greedy's on tie-free
   scores;
4. `ring_scatter_build`: p steps; at step s shard j takes, from the rows of
   shard (j - s) mod p, those whose slot falls in its slab (copies between
   cards when the devices differ; none when they repeat).

The shards hold slab views of one allocation when they share a device. K2
reads its slabs through TMA, which needs a 16-byte-aligned base:
`shard_ivf_state` copies a shard whose view does not start on one.

On a mesh over several processes (parallel/distributed.py::process_mesh)
a process holds its own shards and None for the others'. The cross-shard
steps then run as collectives where the JAX package's shard_maps have
them: per-shard results (candidate sets, k-means sums and counts, leaf
choices, counting-pass counts) are all-gathered and combined in shard
order, so every process computes what one process holding every shard
would; label rows (and any row taken by global id) are a masked sum over
the group; the ring's cross-process steps are paired sends and receives.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from hbird_tpu_torch.ops.ivf import (
    NEG_INF,
    _assign_block,
    _new_centroids,
    _round_up,
    balanced_layout,
    coherent_query_order,
    lloyd_sums,
    phase_seconds,
    select_block_leaves,
    slab_rows,
)
from hbird_tpu_torch.parallel import distributed
from hbird_tpu_torch.parallel.sharded_knn import (
    first_shard,
    gather_parts,
    local_valid_rows,
    merge_topk,
    shard_rows,
    spans_processes,
    take,
)

Shards = List[Optional[torch.Tensor]]  # None: another process's shard
SHARD_PROBES = ("split", "full")
LAYOUTS = ("host", "device")


def _total(parts: Sequence[Optional[torch.Tensor]], home, mesh=None) -> torch.Tensor:
    """Sum of per-shard tensors on `home`, added in shard order (the JAX
    package's psum, in one order on every process)."""
    out = None
    for t in gather_parts(parts, home, mesh):
        out = t.clone() if out is None else out + t
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a copy of it when its data does not start on 16 bytes (a
    view into a larger allocation), as K2's TMA reads need."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def row_shards(x, mesh, rows: int, bank_axis: str = "bank") -> Shards:
    """`x` (a tensor of at most `rows` rows, zero-padded to `rows`; or a
    list of shards, kept) as one shard of rows / p rows per device of the
    mesh's bank axis (None for another process's)."""
    if isinstance(x, (list, tuple)):
        return list(x)
    if x.shape[0] < rows:
        x = torch.cat([x, x.new_zeros((rows - x.shape[0],) + tuple(x.shape[1:]))])
    return shard_rows(x, mesh, bank_axis, block=1)


def shard_ivf_state(ivf_bank, ivf_labels, mesh, bank_axis: str = "bank", *, cap: int, row_scale=None):
    """Prebuilt leaf-contiguous slabs (a saved or streamed tree) as whole-
    leaf shards over the mesh's bank axis: (bank, labels, row_scale) lists
    (row_scale None when not given). Lists of shards pass through (moved to
    the mesh's devices). A leaf count the axis does not divide raises."""
    devices = mesh.axis_devices(bank_axis)
    p = len(devices)
    if isinstance(ivf_bank, (list, tuple)):
        n_slots = len(ivf_bank) * first_shard(ivf_bank).shape[0]
    else:
        n_slots = ivf_bank.shape[0]
    if n_slots % cap or (n_slots // cap) % p:
        raise ValueError(
            f"a tree of {n_slots // cap} leaves does not split into whole leaves over the mesh's "
            f"{bank_axis!r} axis ({p}): its leaf count must divide by the axis size"
        )

    def place(x, dtype=None):
        if x is None:
            return None
        parts = list(x) if isinstance(x, (list, tuple)) else list(torch.as_tensor(x).chunk(p))
        if len(parts) != p:
            raise ValueError(f"{len(parts)} shards for a bank axis of {p}")
        out = []
        for t, dev in zip(parts, devices):
            if dev is None or t is None:  # another process's shard
                out.append(None)
                continue
            t = t.to(dev)
            out.append(_aligned((t if dtype is None else t.to(dtype)).contiguous()))
        return out

    rs = None if row_scale is None else [None if s is None else s.reshape(-1, 1)
                                         for s in place(row_scale, torch.float32)]
    return place(ivf_bank), place(ivf_labels, torch.float32), rs


# ----------------------------------------------------------------------
# Search
# ----------------------------------------------------------------------
def probes_per_shard(n_probe: int, p: int, local_leaves: int, shard_probe: str) -> int:
    """Leaves each shard probes per query tile: 'split' ceil(n_probe / p),
    'full' n_probe, each at least 1 and at most the shard's leaves."""
    if shard_probe not in SHARD_PROBES:
        raise ValueError(f"shard_probe must be 'split' or 'full': {shard_probe!r}")
    per_shard = n_probe if shard_probe == "full" else -(-n_probe // p)
    return min(max(1, per_shard), local_leaves)


def sharded_ivf_knn_with_labels(
    queries: torch.Tensor,
    ivf_bank: Shards,
    ivf_labels: Shards,
    centroids: torch.Tensor,
    leaf_valid: torch.Tensor,
    k: int,
    *,
    mesh=None,
    bank_axis: str = "bank",
    cap: int,
    n_probe: int,
    block_q: int = 256,
    sort_queries: bool = True,
    shard_probe: str = "split",
    row_scale: Optional[Shards] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tree search over whole-leaf shards, K2 once per shard.

    Args:
        queries: (Q, D), as K2 takes them (the slabs' form).
        ivf_bank / ivf_labels / row_scale: lists of p shards of
            (n_leaves / p · cap) slots (`shard_ivf_state`, `build_ivf_sharded`).
        centroids: (n_leaves, D); leaf_valid: (n_leaves,) real rows per leaf,
            on the queries' device.
        shard_probe: 'split' or 'full' (see `probes_per_shard`).

    Returns:
        values (Q, k) f32, global IVF slot ids (Q, k) int64, labels
        (Q, k, C) f32, on the queries' device; unfilled slots are (-inf, 0).
    """
    from hbird_tpu_torch.ops.ivf_cuda import ivf_topk

    p = len(ivf_bank)
    n_leaves = centroids.shape[0]
    local_slots = first_shard(ivf_bank).shape[0]
    if mesh is not None and mesh.shape.get(bank_axis, p) != p:
        raise ValueError(f"{p} shards for a bank axis of {mesh.shape[bank_axis]}")
    if n_leaves % p or local_slots != n_leaves // p * cap:
        raise ValueError(f"{p} shards of {local_slots} slots are not whole leaves of {n_leaves} x {cap}")
    local_leaves = n_leaves // p
    l_p = probes_per_shard(n_probe, p, local_leaves, shard_probe)
    home = queries.device
    q_n = queries.shape[0]
    inv = None
    if sort_queries:
        order = coherent_query_order(queries, centroids)
        inv = torch.argsort(order)
        queries = queries[order]
    pad = _round_up(q_n, block_q) - q_n
    if pad and q_n:
        # Edge padding: zero rows would vote score 0 for every leaf.
        queries = torch.cat([queries, queries[-1:].expand(pad, -1)])
    queries = queries.contiguous()
    vals_s, idx_s = [None] * p, [None] * p
    q_at = {}
    for j in range(p):  # every shard launched before any result moves
        if ivf_bank[j] is None:
            continue
        dev = ivf_bank[j].device
        if dev not in q_at:
            q_at[dev] = queries.to(dev)
        q = q_at[dev]
        lo = j * local_leaves
        lids = select_block_leaves(q, centroids[lo : lo + local_leaves].to(dev), l_p, block_q)
        vals, idx = ivf_topk(
            q, ivf_bank[j], lids, leaf_valid[lo : lo + local_leaves].to(dev), k, cap=cap,
            block_q=block_q, row_scale=None if row_scale is None else row_scale[j],
        )
        vals_s[j], idx_s[j] = vals, idx + j * local_slots
    if q_n == 0:
        vals = torch.full((0, k), NEG_INF, dtype=torch.float32, device=home)
        idx = torch.zeros((0, k), dtype=torch.int64, device=home)
    else:
        cand_v = torch.cat(gather_parts(vals_s, home, mesh), dim=1)
        cand_i = torch.cat(gather_parts(idx_s, home, mesh), dim=1)
        vals, idx = merge_topk(cand_v, cand_i, k, index_ordered=True)
    vals, idx = vals[:q_n], idx[:q_n]
    if inv is not None:
        vals, idx = vals[inv], idx[inv]
    labels = torch.zeros(idx.shape + (first_shard(ivf_labels).shape[1],), dtype=torch.float32, device=home)
    return vals, idx, take(ivf_labels, idx, mesh, out=labels)


# ----------------------------------------------------------------------
# Build
# ----------------------------------------------------------------------
def sharded_kmeans(
    bank: Shards,
    init_centroids: torch.Tensor,
    mesh=None,
    *,
    iters: int = 4,
    valid_rows: Optional[int] = None,
    spherical: bool = True,
    block_rows: int = 1 << 18,
) -> torch.Tensor:
    """Lloyd's k-means over the full row-sharded bank: each shard's sums and
    counts of its real rows (padding rows carry no weight), added in shard
    order on the centroids' device. Returns (n_leaves, D) f32 centroids."""
    rows = first_shard(bank).shape[0]
    m = len(bank) * rows if valid_rows is None else int(valid_rows)
    home = init_centroids.device
    c = init_centroids.float()
    for _ in range(iters):
        sums, cnts = [None] * len(bank), [None] * len(bank)
        for j, x in enumerate(bank):
            if x is not None:
                sums[j], cnts[j] = lloyd_sums(x[: local_valid_rows(m, j, rows)], c.to(x.device),
                                              block_rows=block_rows)
        c = _new_centroids(_total(sums, home, mesh), _total(cnts, home, mesh), c, spherical)
    return c


def sharded_assign_leaves(
    bank: Shards,
    centroids: torch.Tensor,
    mesh=None,
    *,
    n_choices: int = 3,
    chunk_rows: int = 1 << 16,
    replicate_out: bool = True,
):
    """Top-`n_choices` leaf ids and scores of every row (padding rows
    included), shard by shard in chunks of `chunk_rows`.

    Returns host (R, A) int32 choices and (R, A) f32 scores in global row
    order, or with replicate_out=False lists of per-shard (rows, A) int64 /
    f32 tensors on the shards' devices (the 'device' layout's input)."""
    a = min(n_choices, centroids.shape[0])
    ids, scores = [None] * len(bank), [None] * len(bank)
    for j, x in enumerate(bank):
        if x is None:
            continue
        c_t = centroids.float().T.to(x.device)
        blocks = [_assign_block(x[i : i + chunk_rows], c_t, a) for i in range(0, x.shape[0], chunk_rows)]
        ids[j] = torch.cat([b[0] for b in blocks])
        scores[j] = torch.cat([b[1] for b in blocks])
    if not replicate_out:
        return ids, scores
    cpu = torch.device("cpu")
    return (torch.cat(gather_parts(ids, cpu, mesh)).numpy().astype(np.int32),
            torch.cat(gather_parts(scores, cpu, mesh)).numpy().astype(np.float32))


def _f32_sortkey(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving key of f32 values (no NaNs) in [0, 2^32), as int64:
    key(a) > key(b) iff a > b (the sign-flip trick)."""
    b = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(b >= 0x80000000, (~b) & 0xFFFFFFFF, b | 0x80000000)


def _occurrence_index(mask: torch.Tensor, leaf: torch.Tensor, n_leaves: int) -> torch.Tensor:
    """Rank of each masked row among the masked rows of its leaf, in row
    order (any value on unmasked rows)."""
    n = leaf.shape[0]
    key = torch.where(mask, leaf, torch.full_like(leaf, n_leaves))
    order = torch.sort(key, stable=True).indices
    sk = key[order]
    starts = torch.searchsorted(sk, torch.arange(n_leaves + 1, device=leaf.device))
    occ_sorted = torch.arange(n, device=leaf.device) - starts[sk]
    return torch.zeros(n, dtype=torch.int64, device=leaf.device).scatter_(0, order, occ_sorted)


def _count(mask: torch.Tensor, leaf: torch.Tensor, n_leaves: int) -> torch.Tensor:
    """Rows of each leaf where `mask` holds (int64, exact)."""
    return torch.zeros(n_leaves, dtype=torch.int64, device=leaf.device).index_add_(0, leaf, mask.to(torch.int64))


def sharded_balanced_layout(
    choices: Shards,
    scores: Shards,
    n_leaves: int,
    cap: int,
    mesh=None,
    *,
    valid_rows: int,
) -> Tuple[Shards, np.ndarray]:
    """Capacity-bounded slots for every row with the choices and scores
    left on their shards: the 'device' layout.

    For each choice pass, a per-leaf admission threshold on the scores'
    order keys (32 counting passes, each per-shard counts added over the
    shards) admits the strongest `cap - fill` candidates of every leaf at
    once; exact ties at the threshold are admitted by ascending global row
    id (a second search over row ids). Within a leaf the admitted rows take
    slots in shard-major order: the fill, then the earlier shards'
    admissions, then the row's rank in its shard. Rows that fit none of
    their choices spill to leaves with room, in global row order. Leaf
    membership equals ops/ivf.py::balanced_layout's on tie-free scores.

    Args:
        choices / scores: per-shard (rows, A) (`sharded_assign_leaves`
            with replicate_out=False); padding rows included.
        valid_rows: the real rows M (rows from M on get slot -1).

    Returns (slots: per-shard (rows,) int64, -1 on padding rows; leaf_fill
    (n_leaves,) int64 numpy).
    """
    p = len(choices)
    local = first_shard(choices).shape[0]
    a = first_shard(choices).shape[1]
    m = int(valid_rows)
    if n_leaves * cap < m:
        raise ValueError(f"{n_leaves} leaves of {cap} slots cannot hold {m} rows")
    home = first_shard(choices).device
    mine = [j for j in range(p) if choices[j] is not None]
    devs = {j: choices[j].device for j in mine}
    grow = {j: j * local + torch.arange(local, device=devs[j]) for j in mine}
    placed = {j: grow[j] >= m for j in mine}  # padding rows are never candidates
    slot = {j: torch.full((local,), -1, dtype=torch.int64, device=devs[j]) for j in mine}
    fill = torch.zeros(n_leaves, dtype=torch.int64, device=home)

    def count(masks, leaves):
        """Per-shard counts per leaf (None for other processes' shards)."""
        return [_count(masks[j], leaves[j], n_leaves) if j in masks else None for j in range(p)]

    def at(t, j, index):
        return t.to(devs[j])[index]

    for pass_a in range(a):
        leaf = {j: choices[j][:, pass_a] for j in mine}
        key = {j: _f32_sortkey(scores[j][:, pass_a]) for j in mine}
        cand = {j: ~placed[j] for j in mine}
        room = torch.clamp(cap - fill, min=0)
        # Stage 1: the smallest theta per leaf with count(key > theta) <= room.
        lo = torch.zeros(n_leaves, dtype=torch.int64, device=home)
        hi = torch.full((n_leaves,), 0xFFFFFFFF, dtype=torch.int64, device=home)
        for _ in range(32):
            mid = lo + ((hi - lo) >> 1)
            cnt = _total(count({j: cand[j] & (key[j] > at(mid, j, leaf[j])) for j in mine}, leaf), home, mesh)
            ok = cnt <= room
            lo, hi = torch.where(ok, lo, mid + 1), torch.where(ok, mid, hi)
        above = {j: cand[j] & (key[j] > at(lo, j, leaf[j])) for j in mine}
        tie = {j: cand[j] & (key[j] == at(lo, j, leaf[j])) for j in mine}
        n_above = _total(count(above, leaf), home, mesh)
        need = torch.minimum(room - n_above, _total(count(tie, leaf), home, mesh))
        # Stage 2: the smallest row-id cutoff per leaf admitting `need` ties.
        lo = torch.zeros(n_leaves, dtype=torch.int64, device=home)
        hi = torch.full((n_leaves,), p * local, dtype=torch.int64, device=home)
        for _ in range(32):
            mid = lo + ((hi - lo) >> 1)
            g = _total(count({j: tie[j] & (grow[j] < at(mid, j, leaf[j])) for j in mine}, leaf), home, mesh)
            ok = g >= need
            lo, hi = torch.where(ok, lo, mid + 1), torch.where(ok, mid, hi)
        acc = {j: above[j] | (tie[j] & (grow[j] < at(lo, j, leaf[j]))) for j in mine}
        # Slots: the fill, the earlier shards' admissions, the local rank.
        per_shard = gather_parts(count(acc, leaf), home, mesh)
        base = fill.clone()
        for j in range(p):
            if j in acc:
                occ = _occurrence_index(acc[j], leaf[j], n_leaves)
                slot[j] = torch.where(acc[j], leaf[j] * cap + at(base, j, leaf[j]) + occ, slot[j])
                placed[j] = placed[j] | acc[j]
            base += per_shard[j]
        fill = fill + n_above + need

    # Spill: the rows left go to leaves with room, in global row order.
    room = torch.clamp(cap - fill, min=0)
    rc = torch.cumsum(room, 0)
    left = gather_parts([(~placed[j]).sum().reshape(1) if j in placed else None for j in range(p)], home, mesh)
    spilled = [None] * p
    start = 0
    for j in range(p):
        if j in placed:
            un = ~placed[j]
            u = un.to(torch.int64)
            gpos = start + torch.cumsum(u, 0) - u
            rc_j, room_j, fill_j = rc.to(devs[j]), room.to(devs[j]), fill.to(devs[j])
            leaf_sp = torch.clamp(torch.searchsorted(rc_j, gpos, right=True), 0, n_leaves - 1)
            offset = gpos - (rc_j[leaf_sp] - room_j[leaf_sp])
            slot[j] = torch.where(un, leaf_sp * cap + fill_j[leaf_sp] + offset, slot[j])
            spilled[j] = _count(un, leaf_sp, n_leaves)
        start += int(left[j])
    fill = fill + _total(spilled, home, mesh)
    return [slot.get(j) for j in range(p)], fill.cpu().numpy().astype(np.int64)


def ring_scatter_build(
    bank: Shards,
    labels: Shards,
    slots,
    n_slots: int,
    mesh=None,
    *,
    with_perm: bool = False,
):
    """Row-sharded rows and labels into the slot layout, slab-sharded over
    the same devices, without gathering the bank: p steps; at step s shard j
    takes from shard (j - s) mod p the rows whose slot falls in its slab
    (on a mesh over several processes, a paired send and receive when the
    two shards' processes differ). Slots of -1 (padding) never place.

    `slots` is a host (M,) array (padded with -1 to the shards' rows) or a
    list of per-shard (rows,) tensors (`sharded_balanced_layout`).

    Returns (slab shards, label shards (f32)), and with `with_perm` the
    per-slab (n_slots / p,) int64 original row ids (-1 on empty slots).
    """
    p = len(bank)
    if n_slots % p:
        raise ValueError(f"{n_slots} slots do not split over {p} shards")
    local = n_slots // p
    first, first_lab = first_shard(bank), first_shard(labels)
    r, d, c = first.shape[0], first.shape[1], first_lab.shape[1]
    if not isinstance(slots, (list, tuple)):
        s = np.full(p * r, -1, np.int64)
        s[: len(slots)] = np.asarray(slots, np.int64)
        slots = [None if x is None else torch.as_tensor(s[j * r : (j + 1) * r], device=x.device)
                 for j, x in enumerate(bank)]
    owner = (lambda j: int(mesh.ranks[j])) if spans_processes(mesh) else (lambda j: 0)
    slabs = [None if x is None else torch.zeros((local, d), dtype=x.dtype, device=x.device) for x in bank]
    lslabs = [None if x is None else torch.zeros((local, c), dtype=torch.float32, device=x.device) for x in bank]
    perm = [None if x is None else torch.full((local,), -1, dtype=torch.int64, device=x.device) for x in bank]
    specs = [(first.dtype, (d,)), (torch.float32, (c,)), (torch.int64, ()), (torch.int64, ())]
    for step in range(p):
        for j in range(p):
            src = (j - step) % p
            if bank[src] is None and slabs[j] is None:
                continue
            if bank[src] is not None:  # this process holds the rows: select those bound for slab j
                sel, loc = slab_rows(slots[src], j * local, local)
                if sel is None:
                    sel = loc = torch.zeros(0, dtype=torch.int64, device=bank[src].device)
                block = [bank[src][sel], labels[src][sel].float(), loc, sel + src * r]
                if slabs[j] is None:
                    distributed.send_rows(block, owner(j))
                    continue
            else:  # another process holds them
                block = distributed.recv_rows(specs, owner(src), slabs[j].device)
                if block is None:
                    continue
            rows, labs, loc, gids = (t.to(slabs[j].device) for t in block)
            if loc.numel():
                slabs[j].index_copy_(0, loc, rows)
                lslabs[j].index_copy_(0, loc, labs)
                perm[j].index_copy_(0, loc, gids)
    return (slabs, lslabs, perm) if with_perm else (slabs, lslabs)


def build_ivf_sharded(
    bank,
    labels,
    centroids: torch.Tensor,
    n_leaves: int,
    cap: int,
    mesh,
    *,
    bank_axis: str = "bank",
    n_choices: int = 3,
    valid_rows: Optional[int] = None,
    layout: str = "host",
    times: Optional[dict] = None,
):
    """The tree's slabs from a row-sharded bank, over the mesh's bank axis.

    Args:
        bank: (M, D) tensor (sharded here, padded to a multiple of p rows;
            on a mesh over several processes each gives the same bank and
            keeps its own shards) or a list of row shards with
            `valid_rows` real rows.
        labels: (M or R, C) tensor, list of shards, or None (zeros).
        centroids: (n_leaves, D), trained (n_leaves a multiple of p).
        layout: 'host' (the unmeshed greedy's slots) or 'device'
            (`sharded_balanced_layout`; nothing O(M) leaves the shards).
        times: a dict that gets the wall time of each stage (assign,
            layout, scatter), device work included.

    Returns dict(ivf_bank, ivf_labels (shard lists), centroids, perm, slots,
    leaf_fill (numpy int64), valid_rows). 'host': perm (n_slots,) and slots
    (M,) int64 tensors on the centroids' device (on every process);
    'device': perm per slab shard and slots per row shard (R rows, -1 on
    padding).
    """
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be 'host' or 'device': {layout!r}")
    p = mesh.shape[bank_axis]
    if n_leaves % p:
        raise ValueError(f"{n_leaves} leaves do not split over the mesh's {bank_axis!r} axis ({p})")
    if isinstance(bank, (list, tuple)):
        bank_s = list(bank)
        rows = len(bank_s) * first_shard(bank_s).shape[0]
        m = rows if valid_rows is None else int(valid_rows)
    else:
        m = bank.shape[0] if valid_rows is None else int(valid_rows)
        bank_s = shard_rows(bank, mesh, bank_axis, block=1)
        rows = len(bank_s) * first_shard(bank_s).shape[0]
    if labels is None:
        labels = torch.zeros((m, 1), dtype=torch.float32, device=first_shard(bank_s).device)
    labels_s = row_shards(labels, mesh, rows, bank_axis)
    home = centroids.device
    n_slots = n_leaves * cap
    timed = (lambda name: phase_seconds(times, name, home))
    if layout == "device":
        with timed("assign"):
            choices, scores = sharded_assign_leaves(bank_s, centroids, mesh, n_choices=n_choices,
                                                    replicate_out=False)
        with timed("layout"):
            slots, fill = sharded_balanced_layout(choices, scores, n_leaves, cap, mesh, valid_rows=m)
        del choices, scores
        with timed("scatter"):
            ivf_bank, ivf_labels, perm = ring_scatter_build(bank_s, labels_s, slots, n_slots, mesh, with_perm=True)
        return dict(ivf_bank=ivf_bank, ivf_labels=ivf_labels, centroids=centroids, perm=perm, slots=slots,
                    leaf_fill=fill, valid_rows=m)
    with timed("assign"):
        choices, scores = sharded_assign_leaves(bank_s, centroids, mesh, n_choices=n_choices)
    with timed("layout"):
        slots, fill = balanced_layout(choices[:m], n_leaves, cap, scores=scores[:m])
    del choices, scores
    with timed("scatter"):
        ivf_bank, ivf_labels = ring_scatter_build(bank_s, labels_s, slots, n_slots, mesh)
    slots_t = torch.as_tensor(slots, dtype=torch.int64, device=home)
    perm = torch.full((n_slots,), -1, dtype=torch.int64, device=home)
    perm[slots_t] = torch.arange(m, device=home)
    return dict(ivf_bank=ivf_bank, ivf_labels=ivf_labels, centroids=centroids, perm=perm, slots=slots_t,
                leaf_fill=fill, valid_rows=m)
