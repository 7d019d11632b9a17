"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the chips the cell asks for.
The cell names a configuration (`configs/<config>.json`) and a traffic mix
(`traffic/<traffic>.json`); the traffic names the job kind, whose window
driver is `jobs/<kind>.py`. Each metric is read by `metrics/<metric>.py`, or
by the reader of its name's part before the first dot (end-to-end metrics with `--trace 0`, per-layer metrics with `--trace 1`).
Once the window has closed and the peak memory is read, the outputs are
judged against the plain reference (portbench/check.py) and each number is
printed beside its limit (`limits/<cell>.json`): on standard error as the
last lines, and in the result line under "checks", its last key. The last
line of standard output is the result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
KERNEL_SOURCES = ("knn_topk.cu", "ivf_topk.cu", "flash_attn.cu")  # K1, K2, K3
FORBIDDEN = ("jax", "jaxlib", "flax", "hbird_tpu", "hbird")  # whole top-level names


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(metric: str) -> Path:
    """The metric's reader: `metrics/<name>.py`, else the reader of the part
    of its name before the first dot (one reader for `mfu.eval` and
    `mfu.job`)."""
    path = HERE / "metrics" / f"{metric}.py"
    return path if path.exists() else HERE / "metrics" / f"{metric.split('.')[0]}.py"


def load_cell(name: str) -> dict:
    """The cell's entry, configuration, traffic, limits and metrics."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"cell": cell, "config": config, "traffic": traffic, "limits": limits,
            "end_to_end": mine(bench["end_to_end"]), "per_layer": mine(bench["per_layer"])}


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def execute(ctx, metrics, limits: dict, with_control: bool = False) -> dict:
    """Run the cell's job, read its metrics, judge its outputs. Returns
    {"res", "metrics", "numbers", "control", "correct"}."""
    import torch

    import hbird_tpu_torch.hbird_eval  # noqa: F401
    from portbench import check
    from portbench.harness import Stages

    ctx.stages = Stages(ctx)
    ctx.stages.mark("start_and_imports")
    if ctx.device.type == "cuda":
        from concurrent.futures import ThreadPoolExecutor

        from hbird_tpu_torch.ops import cuda_build

        torch.cuda.init()
        ctx.stages.mark("cuda_init")
        # The port builds each kernel at first use; building the three the
        # cells run at once, here, only shortens a checkout's first run.
        with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
            list(pool.map(cuda_build.build, KERNEL_SOURCES))
        ctx.stages.mark("kernels_built_or_found")
    job = load_module(HERE / "jobs" / f"{ctx.traffic['job']}.py")
    res = job.run(ctx)
    values = {}
    for m in metrics:
        v = load_module(reader_path(m["name"])).read(res, ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if res.get("tree") is None:
        res["engine"].NN_algorithm = None  # the searched copy: the reference reads the f32 bank
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, control = check.judge(ctx, res, with_control)
    return {"res": res, "metrics": values, "numbers": numbers, "control": control,
            "correct": check.verdict(numbers, limits)}


def result_line(ctx, out: dict, limits: dict) -> dict:
    import torch

    res = out["res"]
    dev = ctx.device
    device = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": res["peak_bytes"],
    }
    line = {"correct": bool(out["correct"]), "attempted": res.get("images") or len(res.get("jobs", [])),
            "failed": 0, "metrics": out["metrics"], "device": device}
    t = res["trace"]
    if t is not None:
        device["busy_s"] = t.busy_s()
        device["window_s"] = t.window_s
        line["breakdown"] = t.breakdown()
    line["checks"] = {k: [out["numbers"][k], limits[k]] for k in limits}
    return line


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    spec = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["cell"]["chips"]:
        print(f"portbench: {args.workload} needs {spec['cell']['chips']} CUDA device(s); "
              f"this host has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from portbench.harness import Ctx

    ctx = Ctx(args.workload, spec["config"], spec["traffic"], args.seed, args.seconds,
              bool(args.trace), torch.device("cuda", 0), T0)
    metrics = spec["per_layer"] if args.trace else spec["end_to_end"]
    out = execute(ctx, metrics, spec["limits"])
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    line = result_line(ctx, out, spec["limits"])
    stages = " ".join(f"{k} {v:.3f}" for k, v in out["res"]["setup_stages"].items())
    print(f"set-up seconds: {stages}; window {out['res']['window_s']:.3f}", file=sys.stderr)
    for i, phases in enumerate(out["res"].get("job_phases", [])):
        print(f"job {i}: " + " ".join(f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)
    for k, (v, lim) in line["checks"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
