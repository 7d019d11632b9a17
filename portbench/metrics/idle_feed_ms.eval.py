"""Device-idle ms per eval step while the engine feeds the next batch: the
program's `hbird.eval.feed` spans (the loader's next item, padding, the
copies to the card) against the window's device activity, over its
`hbird.eval.step` spans."""

from portbench import spans


def read(res, ctx):
    return spans.idle_per(res, ("hbird.eval.feed",), ("hbird.eval.step",), 1e-3)
