"""K2's share of its roofline. The leaves each 256-query tile probes are
worked out by the benchmark from the built tree's centroids and fill and
each eval batch's queries (portbench/reference/hbird.py::tile_leaves), so
the count is the same whatever implements K2; each call's bound
(portbench/work.py::ivf_bound_ms) over K2's device time. Every job of the
window does the same work (same data, weights and tree), so the last
job's count stands for each."""

import torch

from portbench import work
from portbench.reference.hbird import tile_leaves


def read(res, ctx):
    t, tree = res["trace"], res.get("tree")
    if t is None or not t.activities or tree is None:
        return None
    kernels = t.kernels("K2")
    batches = [b["q"] for b in res["recorder"].batches.values() if "q" in b]
    if not kernels or not batches:
        return None
    lv = tree["leaf_valid"].long()
    bound = 0.0
    for q in batches:
        lids, _ = tile_leaves(q, tree["centroids"], tree["n_probe"], tree["block_q"])
        scanned = int(lv[lids].sum())
        read_rows = int(lv[torch.unique(lids)].sum())
        n_q = lids.shape[0] * tree["block_q"]
        bound += work.ivf_bound_ms(n_q, lids.shape[0], scanned, read_rows, q.shape[1],
                                   ctx.traffic["n_neighbours"])[0]
    bound *= len(res["jobs"])
    return 100.0 * bound * 1e-3 / (sum(a.end - a.start for a in kernels) * 1e-9)
