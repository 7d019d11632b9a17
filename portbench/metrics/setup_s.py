"""Seconds from the process's start to the window's: loading, making the
weights and data, the memory and index builds a cell's set-up holds, and
the warm-up (host clock)."""


def read(res, ctx):
    return res["setup_s"]
