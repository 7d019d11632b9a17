"""Seconds per whole evaluation: the window's jobs' time over their count
(host clock; every job in the window is whole)."""


def read(res, ctx):
    jobs = res.get("jobs")
    return sum(jobs) / len(jobs) if jobs else None
