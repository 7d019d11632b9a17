"""Device-idle ms per eval step while the host takes the last batch's
results: the program's `hbird.eval.consume` spans (the copies back, the
host's mask and metric update) against the window's device activity, over
its `hbird.eval.step` spans."""

from portbench import spans


def read(res, ctx):
    return spans.idle_per(res, ("hbird.eval.consume",), ("hbird.eval.step",), 1e-3)
