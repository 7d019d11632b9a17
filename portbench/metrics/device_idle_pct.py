"""Share of the traced window with no device activity (the union of every
kernel, copy and set)."""


def read(res, ctx):
    t = res["trace"]
    if t is None or not t.activities:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
