"""Peak device memory over set-up and window, GiB: the CUDA caching
allocator's `max_memory_allocated`, read by the benchmark when the window
closes, before the reference runs."""


def read(res, ctx):
    return res["peak_bytes"] / 2**30 if res["peak_bytes"] else None
