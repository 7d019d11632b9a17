"""Job kind 'eval': the engine's memory and index build in set-up, then
`evaluate` over the val split in the window.

The val feed wraps round the split and stops yielding once `--seconds`
have passed (never before `sample.val_batches` batches); `evaluate` then
finishes the batch in flight and computes the metric. The rate is every
image scored over all the time from `evaluate`'s call to its return.
"""

from __future__ import annotations

from portbench import harness
from portbench.data import HostSplit, Prefetched, TimedStream
from portbench.probe import BenchTimer, Recorder, launch_counts, watch_eval


def run(ctx: harness.Ctx) -> dict:
    from hbird_tpu_torch.hbird_eval import HbirdEvaluation

    tr, cfg = ctx.traffic, ctx.config
    b = tr["batch"]
    at_least = tr["sample"]["val_batches"]
    sample = harness.draw_sample(ctx.seed, tr, at_least * b)
    rec = Recorder(sample.train_calls(b), sample.val_batches())
    stages = ctx.stages
    ext = harness.feature_extractor(ctx, rec)
    stages.mark("model")
    val = HostSplit(harness.split(ctx, "val"), tr["classes"])
    stages.mark("val_data")
    timer = BenchTimer()
    engine = HbirdEvaluation(ext, Prefetched(harness.split(ctx, "train")),
                             **harness.engine_kwargs(ctx, tr["train_images"], timer))
    stages.mark("memory_and_index_build")
    esr = ext.eval_spatial_resolution
    rec.in_eval = True
    engine.evaluate(list(val.batches())[:1], esr)  # warm-up: every shape of the window
    harness.sync(ctx.device)
    stages.mark("warm_up")
    watch_eval(engine, rec, b)
    before = launch_counts()
    stream = TimedStream(val, b, at_least, harness.clock)
    setup_s = harness.clock() - ctx.t0
    window = harness.Window(ctx)
    with window.open():
        t_a = harness.clock()
        stream.deadline = t_a + ctx.seconds
        miou = engine.evaluate(stream, esr)
        harness.sync(ctx.device)
        eval_s = harness.clock() - t_a
    peak = harness.peak_bytes(ctx.device)
    after = launch_counts()
    n_batches = len(stream.indices)
    return {
        "setup_s": setup_s,
        "setup_stages": stages.seconds,
        "window_s": window.seconds,
        "trace": window.trace,
        "peak_bytes": peak,
        "eval_s": eval_s,
        "eval_batches": n_batches,
        "images": n_batches * b,
        "forwards": n_batches,
        "launches": {k: after.get(k, 0) - before.get(k, 0) for k in set(after) | set(before)},
        "miou": float(miou),
        "conf_mat": engine.conf_mat,
        "gt_histogram": sum(val.histogram[idx].sum(axis=0) for idx in stream.indices),
        "val_indices": stream.indices,
        "engine": engine,
        "recorder": rec,
        "sample": sample,
        "val": val,
        "extractor": ext,
        "bank_rows": int(engine.feature_memory.shape[0]),
        "queries_per_batch": b * esr * esr,
    }
