"""Device ms per train batch of the memory build outside the forward: the
mask ids, patchify, soft labels, sampling, normalisation, the in-place
write into the bank and the batch's copies to the card."""


def read(res, ctx):
    t = res["trace"]
    if t is None or not t.activities or not res.get("train_batches"):
        return None
    inside = t.under("portbench.phase.memory_build")
    if not inside:
        return None
    fwd = {id(a) for a in t.under("portbench.forward")}
    return sum(a.end - a.start for a in inside if id(a) not in fwd) * 1e-6 / res["train_batches"]
