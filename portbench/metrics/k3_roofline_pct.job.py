"""K3's share of its roofline: each launch's bound at (batch, heads,
tokens, head width) in bf16 (portbench/work.py) over K3's device time."""

from portbench import work


def read(res, ctx):
    t = res["trace"]
    if t is None or not t.activities:
        return None
    kernels = t.kernels("K3")
    if not kernels:
        return None
    cfg = ctx.config
    shape = (ctx.traffic["batch"], cfg["num_heads"], work.vit_tokens(cfg, cfg["input_size"]),
             cfg["width"] // cfg["num_heads"])
    bound, _ = work.flash_bound_ms(shape)
    return 100.0 * len(kernels) * bound * 1e-3 / (sum(a.end - a.start for a in kernels) * 1e-9)
