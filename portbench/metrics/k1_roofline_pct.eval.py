"""K1's share of its roofline: the bound of each call (portbench/work.py:
bf16 queries and bank rows read once, results written once, or 2·Q·M·D
operations at the bf16 peak) over K1's device time (its top-k kernel and
the merge it launches), over the traced window."""

from portbench import work


def read(res, ctx):
    t = res["trace"]
    if t is None or not t.activities or "bank_rows" not in res or res.get("tree") is not None:
        return None
    kernels = t.kernels("K1")
    calls = t.calls("K1")
    if not calls:
        return None
    d = ctx.config["width"]
    bound, _ = work.bound_ms(res["queries_per_batch"], res["bank_rows"], d, ctx.traffic["n_neighbours"])
    return 100.0 * calls * bound * 1e-3 / (sum(a.end - a.start for a in kernels) * 1e-9)
