"""Seconds of the engine's index_build phase (the in-memory tree build)
per job: the PhaseTimer the benchmark hands the engine, which synchronises
the device at the phase's end."""


def read(res, ctx):
    if res["trace"] is None or not res["trace"].activities or not res.get("index_build_s"):
        return None
    return sum(res["index_build_s"]) / len(res["index_build_s"])
