"""Val images scored per second: every image over all the time from
`evaluate`'s call to its return (host clock)."""


def read(res, ctx):
    return res["images"] / res["eval_s"] if res.get("eval_s") else None
