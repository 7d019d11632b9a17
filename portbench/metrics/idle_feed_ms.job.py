"""Device-idle ms per memory or eval step while the engine feeds the next
batch: the program's `hbird.memory.feed` and `hbird.eval.feed` spans
against the window's device activity, over its `hbird.memory.step` and
`hbird.eval.step` spans."""

from portbench import spans


def read(res, ctx):
    return spans.idle_per(res, ("hbird.memory.feed", "hbird.eval.feed"),
                          ("hbird.memory.step", "hbird.eval.step"), 1e-3)
