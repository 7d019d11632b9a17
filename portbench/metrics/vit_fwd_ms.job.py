"""Device ms per batch of 64 of the ViT forward (everything launched under
the benchmark's forward span), train and val batches alike."""


def read(res, ctx):
    t = res["trace"]
    if t is None or not t.activities:
        return None
    n = len(t.spans.get("portbench.forward", []))
    if not n:
        return None
    return sum(a.end - a.start for a in t.under("portbench.forward")) * 1e-6 / n
