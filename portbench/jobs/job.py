"""Job kind 'job': whole evaluations back to back, as a user runs them.

Each job builds the memory over the train split, builds the index, runs
`evaluate` over the val split and computes the metric; the previous job's
engine is released before the next one starts. Set-up makes the data and
runs one small job over two train batches and one val batch, so every
kernel and code path has run once. The window ends with the first job that
ends after `--seconds`; the last job's engine is kept for the reference.
"""

from __future__ import annotations

from torch.profiler import record_function

from portbench import harness
from portbench.data import HostSplit
from portbench.probe import BenchTimer, Recorder, launch_counts, watch_eval


def run(ctx: harness.Ctx) -> dict:
    from hbird_tpu_torch.hbird_eval import HbirdEvaluation

    tr = ctx.traffic
    b = tr["batch"]
    n_val_batches = -(-tr["val_images"] // b)
    sample = harness.draw_sample(ctx.seed, tr, tr["val_images"])
    val_want = sample.val_batches()
    if ctx.trace:  # the reader of K2's work needs every eval batch's queries
        val_want = {i: val_want.get(i, []) for i in range(n_val_batches)}
    rec = Recorder(sample.train_calls(b), val_want, keep_queries=True)
    stages = ctx.stages
    ext = harness.feature_extractor(ctx, rec)
    stages.mark("model")
    train = HostSplit(harness.split(ctx, "train"), tr["classes"])
    val = HostSplit(harness.split(ctx, "val"), tr["classes"])
    stages.mark("data")
    esr = ext.eval_spatial_resolution

    small = HbirdEvaluation(ext, list(train.batches())[:2],
                            **harness.engine_kwargs(ctx, 2 * b, BenchTimer()))
    rec.in_eval = True
    small.evaluate(list(val.batches())[:1], esr)
    del small
    harness.sync(ctx.device)
    stages.mark("warm_up")
    before = launch_counts()
    setup_s = harness.clock() - ctx.t0

    jobs, index_build, phases, miou, engine = [], [], [], None, None
    window = harness.Window(ctx)
    with window.open():
        t_start = harness.clock()
        while True:
            engine = None  # the previous job's engine goes before the next is built
            rec.reset()
            timer = BenchTimer()
            with record_function("portbench.job"):
                t0 = harness.clock()
                engine = HbirdEvaluation(ext, train.batches(), **harness.engine_kwargs(ctx, tr["train_images"], timer))
                watch_eval(engine, rec, b)
                miou = engine.evaluate(val.batches(), esr)
                harness.sync(ctx.device)
                jobs.append(harness.clock() - t0)
            index_build.append(timer.phases["index_build"]["seconds"])
            phases.append({k: v["seconds"] for k, v in timer.phases.items()})
            if harness.clock() - t_start >= ctx.seconds:
                break
    peak = harness.peak_bytes(ctx.device)
    after = launch_counts()
    nn = engine.NN_algorithm
    return {
        "setup_s": setup_s,
        "setup_stages": stages.seconds,
        "window_s": window.seconds,
        "trace": window.trace,
        "peak_bytes": peak,
        "jobs": jobs,
        "index_build_s": index_build,
        "job_phases": phases,
        "eval_batches": n_val_batches * len(jobs),
        "train_batches": train.__len__() * len(jobs),
        "forwards": (len(train) + n_val_batches) * len(jobs),
        "train_images_per_job": tr["train_images"],
        "val_images_per_job": tr["val_images"],
        "launches": {k: after.get(k, 0) - before.get(k, 0) for k in set(after) | set(before)},
        "miou": float(miou),
        "conf_mat": engine.conf_mat,
        "gt_histogram": val.histogram.sum(axis=0),
        "val_indices": None,
        "engine": engine,
        "recorder": rec,
        "sample": sample,
        "val": val,
        "extractor": ext,
        "bank_rows": int(engine.feature_memory.shape[0]),
        "queries_per_batch": b * esr * esr,
        "tree": {"centroids": nn.centroids, "leaf_valid": nn.leaf_valid, "cap": nn._cap,
                 "n_probe": min(nn.num_leaves_to_search, nn._n_leaves), "block_q": nn.query_block},
    }
