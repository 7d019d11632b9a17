"""Bank-sharded exact kNN with the neighbour-label fetch: K1 once per shard.

Counterpart of hbird_tpu/parallel/sharded_knn.py (the Faiss IndexShards
analogue, reference hbird/nn/search_faiss.py:53-63). The bank's rows are
split into equal, zero-padded shards, one per device of the mesh's 'bank'
axis (a device may repeat, parallel/mesh.py); each shard holds rows
[j·R, (j+1)·R) of the padded bank and the shard's own count of real rows.

- **gather** (`sharded_knn_with_labels`): K1 runs on every shard with the
  queries, then the per-shard (Q, k) sets move to the queries' device and
  merge. Every shard is launched before any result is moved, so distinct
  cards search at once, each on its own current stream.
- **ring** (`ring_knn_with_labels`): the queries split into blocks over the
  mesh axes; each block visits the shards in ring order from its home
  shard, carrying its running top-k, so no shard scores all the queries at
  once. Each block's labels are then collected shard by shard.

The merge keeps K1's one tie rule: value descending, then global row id
ascending. Unfilled slots (fewer real rows than k) are (-inf, 0), as K1
leaves them; a shard with no real rows adds such a set and launches
nothing. Each winner's label row comes from the shard that owns it,
selected without a host synchronisation (the JAX package's masked psum).

A bank axis may span the processes of a torch.distributed group
(parallel/distributed.py::process_mesh). A process then holds its own
shards and None at the others' positions; every process passes the same
queries and gets the same results: what one process holding every shard
would return, bit for bit. The cross-process steps are collectives: the
gather all-gathers the per-shard sets in shard order, the ring all-gathers
the blocks' running top-k after every hop (each process then holds every
block's carry, so the next shard's owner continues it), and label and
feature rows are a masked sum over the group (`take`).

With `rerank_bank` (ScaNN's reorder(C)), each shard takes its own
candidates (at most its rows, at least k), re-scores them exactly against
its shard of the rerank copy and keeps k before the merge, as the JAX
package does: the pool is a superset of the unsharded run's, so the two
answers may differ by design.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from hbird_tpu_torch.ops.knn import NEG_INF, knn_with_labels, rerank_exact
from hbird_tpu_torch.parallel import distributed

Shards = List[Optional[torch.Tensor]]  # None: another process's shard


def pad_rows_for_mesh(n_rows: int, n_shards: int, block: int = 8) -> int:
    """Rows after padding so each shard gets an equal, aligned slice."""
    per_shard = -(-n_rows // n_shards)
    per_shard = ((per_shard + block - 1) // block) * block
    return per_shard * n_shards


def shard_rows(x: torch.Tensor, mesh, bank_axis: str = "bank", block: int = 8) -> Shards:
    """`x` (M, ...) zero-padded to `pad_rows_for_mesh` rows (each shard a
    multiple of `block` rows; the tree's build takes block=1, the JAX
    package's layout there) and split into one shard per device of the
    mesh's `bank_axis`. A shard on `x`'s own device is a view of it (no
    copy); on a mesh over several processes another process's shard is
    None here, and this process's shards are copies, so `x` need not stay
    alive."""
    devices = mesh.axis_devices(bank_axis)
    n = len(devices)
    padded = pad_rows_for_mesh(x.shape[0], n, block)
    if padded != x.shape[0]:
        x = torch.cat([x, x.new_zeros((padded - x.shape[0],) + tuple(x.shape[1:]))])
    r = padded // n
    copy = mesh.spans_processes
    return [None if dev is None else x[j * r : (j + 1) * r].to(dev, copy=copy) for j, dev in enumerate(devices)]


def shard_bank(bank: torch.Tensor, labels: torch.Tensor, mesh, bank_axis: str = "bank") -> Tuple[Shards, Shards, int]:
    """(bank shards, label shards, valid rows): rows padded to equal shards
    over the mesh's bank axis; padded rows are masked out of the search."""
    return shard_rows(bank, mesh, bank_axis), shard_rows(labels, mesh, bank_axis), bank.shape[0]


def first_shard(shards: Shards) -> torch.Tensor:
    """A shard this process holds."""
    return next(s for s in shards if s is not None)


def spans_processes(mesh) -> bool:
    """Whether `mesh` is a mesh over several processes."""
    return mesh is not None and mesh.spans_processes


def gather_parts(parts: Sequence[Optional[torch.Tensor]], home, mesh=None) -> List[torch.Tensor]:
    """Every shard's tensor (one shape for all) on `home`, in shard order
    (gathered from the other processes on a mesh over several)."""
    if spans_processes(mesh):
        return distributed.gather_shards(parts, home)
    return [t.to(home) for t in parts]


def local_valid_rows(valid_rows: int, shard: int, rows_per_shard: int) -> int:
    """Real rows of shard `shard` when the first `valid_rows` rows are real."""
    return max(0, min(valid_rows - shard * rows_per_shard, rows_per_shard))


def merge_topk(vals: torch.Tensor, idx: torch.Tensor, k: int, *, index_ordered: bool = False):
    """Top k of candidate sets (Q, N) by value descending, then global id
    ascending; -inf slots get id 0. `index_ordered` says that among equal
    values the candidates already stand in ascending id order (shard sets
    concatenated in shard order), so one stable sort does."""
    if not index_ordered:
        idx, order = torch.sort(idx, dim=1, stable=True)
        vals = torch.gather(vals, 1, order)
    vals, order = torch.sort(vals, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k], torch.gather(idx, 1, order[:, :k])
    return vals, torch.where(torch.isfinite(vals), idx, torch.zeros_like(idx))


def take_rows(shards: Shards, idx: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rows of global ids `idx` (any shape), each taken from its owning
    shard, on idx's device, in the shards' dtype (or `out`'s, updated in
    place). Shards that are None (another process's) leave their rows as
    they were."""
    first = first_shard(shards)
    r = first.shape[0]
    if out is None:
        out = torch.zeros(idx.shape + tuple(first.shape[1:]), dtype=first.dtype, device=idx.device)
    for j, part in enumerate(shards):
        if part is None:
            continue
        mine = (idx >= j * r) & (idx < (j + 1) * r)
        rows = torch.where(mine, idx - j * r, torch.zeros_like(idx)).to(part.device)
        mine = mine.reshape(mine.shape + (1,) * (out.dim() - mine.dim()))
        out.copy_(torch.where(mine, part[rows].to(out.device, out.dtype), out))
    return out


def take(shards: Shards, idx: torch.Tensor, mesh=None, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rows of global ids `idx` from their shards (`take_rows`), summed over
    the processes of a mesh that spans several: the masked psum, exact
    since one process holds each row."""
    out = take_rows(shards, idx, out)
    return distributed.all_sum(out) if spans_processes(mesh) else out


def fetch_labels(idx: torch.Tensor, label_shards: Shards, mesh=None) -> torch.Tensor:
    """(Q, k, C) f32 label rows of global ids `idx` from their shards."""
    out = torch.zeros(idx.shape + (first_shard(label_shards).shape[1],), dtype=torch.float32, device=idx.device)
    return take(label_shards, idx, mesh, out)


def _unfilled(n_q: int, k: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (Q, k) set with no candidate: (-inf, 0) everywhere, as K1 leaves
    the slots it cannot fill."""
    return (torch.full((n_q, k), NEG_INF, dtype=torch.float32, device=device),
            torch.zeros((n_q, k), dtype=torch.int64, device=device))


class _ShardSearch:
    """K1 (or its plain version) on one shard, with the reorder pass."""

    def __init__(self, bank_shards, k, valid_rows, distance, row_scale, rerank_bank, rerank_candidates):
        self.banks = bank_shards
        self.rows = first_shard(bank_shards).shape[0]
        self.k = k
        self.valid = [local_valid_rows(valid_rows, j, self.rows) for j in range(len(bank_shards))]
        self.distance = distance
        self.row_scale = row_scale
        self.rerank_bank = rerank_bank
        do_rerank = rerank_bank is not None and min(rerank_candidates, self.rows * len(bank_shards)) > k
        # A shard supplies at most its rows; at least k, so every merged
        # value is on the full-precision scale.
        self.local_c = max(k, min(rerank_candidates, self.rows)) if do_rerank else 0

    def __call__(self, j: int, q: torch.Tensor, q_rerank: Optional[torch.Tensor]):
        """(values, global ids) of queries `q` (on shard j's device) in
        shard j."""
        from hbird_tpu_torch.ops.knn_cuda import knn_topk

        rs = self.row_scale[j] if self.row_scale is not None else None
        valid = self.valid[j]
        if self.local_c:
            cvals, cand = knn_topk(q, self.banks[j], self.local_c, valid_rows=valid,
                                   distance=self.distance, row_scale=rs)
            vals, idx = rerank_exact(q_rerank, self.rerank_bank[j], cand, self.k,
                                     cand_valid=torch.isfinite(cvals) & (cand < valid))
        else:
            vals, idx = knn_topk(q, self.banks[j], self.k, valid_rows=valid, distance=self.distance, row_scale=rs)
        return vals, idx + j * self.rows


def _on(cache: Dict[torch.device, torch.Tensor], x: Optional[torch.Tensor], dev: torch.device):
    """`x` on `dev`, copied once per device."""
    if x is None:
        return None
    if dev not in cache:
        cache[dev] = x.to(dev)
    return cache[dev]


def sharded_knn_with_labels(
    queries: torch.Tensor,
    bank,
    labels,
    k: int,
    *,
    mesh=None,
    bank_axis: str = "bank",
    valid_rows: Optional[int] = None,
    distance: str = "dot_product",
    rerank_bank=None,
    rerank_queries: Optional[torch.Tensor] = None,
    rerank_candidates: int = 0,
    row_scale=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k search + label fetch, on one device or over the bank shards.

    Args:
        queries: (Q, D), as K1 takes them (cast to the bank's form); on a
            mesh over several processes, the same in every process.
        bank / labels / row_scale / rerank_bank: without a mesh (or with a
            bank axis of 1) tensors; with one, lists of shards (`shard_rows`).
        valid_rows: real rows of the padded bank (default: all).
        rerank_queries / rerank_candidates: ScaNN's reorder(C), per shard.

    Returns:
        values (Q, k) f32, global ids (Q, k) int64, labels (Q, k, C), on the
        queries' device.
    """
    if mesh is None or mesh.shape.get(bank_axis, 1) == 1:
        one = lambda x: x[0] if isinstance(x, (list, tuple)) else x  # noqa: E731
        return knn_with_labels(
            queries, one(bank), one(labels), k, valid_rows=valid_rows, distance=distance,
            rerank_bank=one(rerank_bank), rerank_queries=rerank_queries,
            rerank_candidates=rerank_candidates, row_scale=one(row_scale),
        )
    n = len(bank)
    if valid_rows is None:
        valid_rows = n * first_shard(bank).shape[0]
    search = _ShardSearch(bank, k, int(valid_rows), distance, row_scale, rerank_bank, rerank_candidates)
    if search.local_c and rerank_queries is None:
        rerank_queries = queries
    home = queries.device
    q_at: Dict[torch.device, torch.Tensor] = {}
    qr_at: Dict[torch.device, torch.Tensor] = {}
    vals_s, idx_s = [None] * n, [None] * n
    for j in range(n):  # every shard launched before any result moves
        if bank[j] is None:
            continue
        if search.valid[j] == 0:
            vals_s[j], idx_s[j] = _unfilled(queries.shape[0], k, home)
            continue
        dev = bank[j].device
        vals_s[j], idx_s[j] = search(j, _on(q_at, queries, dev), _on(qr_at, rerank_queries, dev))
    cand_v = torch.cat(gather_parts(vals_s, home, mesh), dim=1)
    cand_i = torch.cat(gather_parts(idx_s, home, mesh), dim=1)
    vals, idx = merge_topk(cand_v, cand_i, k, index_ordered=True)
    return vals, idx, fetch_labels(idx, labels, mesh)


def ring_knn_with_labels(
    queries: torch.Tensor,
    bank: Shards,
    labels: Shards,
    k: int,
    *,
    mesh,
    bank_axis: str = "bank",
    valid_rows: Optional[int] = None,
    distance: str = "dot_product",
    query_partition: Optional[Sequence[str]] = None,
    rerank_bank: Optional[Shards] = None,
    rerank_queries: Optional[torch.Tensor] = None,
    rerank_candidates: int = 0,
    row_scale: Optional[Shards] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Query-blocked ring search (the retrieval analogue of ring attention).

    The queries split into P blocks, P the product of the `query_partition`
    axes' sizes (default: the bank axis alone; ('data', 'bank') gives each
    data row its own ring). Block b starts at shard b mod n and visits the
    n shards in ring order, carrying its running top-k; a shard with no
    real rows passes the carry on. K1 runs P·n times. On a mesh over
    several processes the owner of a block's shard continues its carry,
    and after every hop the carries are all-gathered, so every process
    holds every block's. Each block's labels are then collected from the
    shards that own its winners. Same arguments and results as
    `sharded_knn_with_labels` (shard lists).
    """
    n = len(bank)
    if valid_rows is None:
        valid_rows = n * first_shard(bank).shape[0]
    parts_n = 1
    for axis in tuple(query_partition or (bank_axis,)):
        parts_n *= mesh.shape[axis]
    search = _ShardSearch(bank, k, int(valid_rows), distance, row_scale, rerank_bank, rerank_candidates)
    if search.local_c and rerank_queries is None:
        rerank_queries = queries
    home = queries.device
    q_n = queries.shape[0]
    step = -(-q_n // parts_n) if q_n else 0
    blocks = []
    for b in range(parts_n):
        lo, hi = min(b * step, q_n), min((b + 1) * step, q_n)
        vals, idx = _unfilled(hi - lo, k, home)
        blocks.append({"q": queries[lo:hi], "qr": rerank_queries[lo:hi] if search.local_c else None,
                       "vals": vals, "idx": idx})
    for hop in range(n):
        for b, blk in enumerate(blocks):
            j = (b % n + hop) % n
            if bank[j] is None or search.valid[j] == 0 or blk["q"].shape[0] == 0:
                continue
            dev = bank[j].device  # the block and its carry travel to shard j
            for key in ("q", "qr", "vals", "idx"):
                if blk[key] is not None:
                    blk[key] = blk[key].to(dev)
            v, i = search(j, blk["q"], blk["qr"])
            blk["vals"], blk["idx"] = merge_topk(torch.cat([blk["vals"], v], 1), torch.cat([blk["idx"], i], 1), k)
        if spans_processes(mesh) and step:
            _share_carries(blocks, [int(mesh.ranks[(b % n + hop) % n]) for b in range(parts_n)], step, k, home)
    vals = torch.cat([blk["vals"].to(home) for blk in blocks])
    idx = torch.cat([blk["idx"].to(home) for blk in blocks])
    return vals, idx, fetch_labels(idx, labels, mesh)


def _share_carries(blocks, owners: List[int], step: int, k: int, home) -> None:
    """After a hop over a process group: every block's carry, continued by
    the process that owns its shard (`owners[b]`), all-gathered into every
    process. Each process sends its blocks in ascending order, each padded
    to `step` rows with unfilled slots (the last blocks may be shorter), so
    the gathered list stands in (owner, block) order."""
    rank = distributed.process_index()

    def padded(t, fill):
        t = t.to(home)
        return torch.cat([t, t.new_full((step - t.shape[0], k), fill)]) if t.shape[0] < step else t

    mine = [blocks[b] for b in range(len(blocks)) if owners[b] == rank]
    got_v = distributed.gather_shards([padded(blk["vals"], NEG_INF) for blk in mine], home)
    got_i = distributed.gather_shards([padded(blk["idx"], 0) for blk in mine], home)
    for slot, b in enumerate(sorted(range(len(blocks)), key=lambda b: (owners[b], b))):
        if owners[b] != rank:
            rows = blocks[b]["q"].shape[0]
            blocks[b]["vals"], blocks[b]["idx"] = got_v[slot][:rows], got_i[slot][:rows]
