"""Device-idle seconds per job in the tree build's stages: the program's
`hbird.index.<stage>` spans (k-means, refine, assign, layout, scatter)
against the window's device activity, over its `hbird.phase.index_build`
spans."""

from portbench import spans


def read(res, ctx):
    return spans.idle_per(res, ("hbird.index.",), ("hbird.phase.index_build",), 1.0)
