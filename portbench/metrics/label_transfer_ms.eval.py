"""Device ms per eval batch of what `evaluate` launches outside the
forward and outside K1 and K2: label transfer, upsampling, argmax, the
confusion counts and the copies back to the host."""


def read(res, ctx):
    t = res["trace"]
    if t is None or not t.activities or not res["eval_batches"]:
        return None
    inside = t.under("portbench.phase.evaluate")
    if not inside:
        return None
    fwd = {id(a) for a in t.under("portbench.forward")}
    search = {id(a) for a in t.kernels("K1") + t.kernels("K2")}
    ns = sum(a.end - a.start for a in inside if id(a) not in fwd and id(a) not in search)
    return ns * 1e-6 / res["eval_batches"]
