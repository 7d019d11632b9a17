"""The program's spans against the traced window's device activity.

The port records its own spans (`hbird.*`, hbird_tpu_torch/utils/profiling.py)
while a profiler runs, on the clock the profiler stamps its events with, so
they line up with the device activity of `portbench.trace.Trace` and with
each activity's launch time. A program that records none (an older
checkout) gives None here, and so does every reader built on this file.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>

runs the cell traced, as `portbench.run` does, and prints one JSON line:
the per-layer metrics, the window's device-idle seconds by the innermost
program span open on the host (`(none)` where none is), each span's host
ms per occurrence, where the kernels were launched (K3 under
`hbird.forward`, K1 and K2 under `hbird.search`) and, for whole jobs, each
job's seconds and phases.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from portbench.trace import Trace, _merged


def window_spans(trace: Trace) -> Optional[list]:
    """The program's spans that overlap the window, or None when it
    recorded none."""
    try:
        from hbird_tpu_torch.utils.profiling import recorded_spans
    except ImportError:
        return None
    w0, w1 = trace.window
    return [s for s in recorded_spans() if s.start_ns < w1 and s.end_ns > w0] or None


def _overlap_ns(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ns(trace: Trace, intervals: Sequence[Tuple[int, int]]) -> int:
    """Device-idle ns in the union of `intervals` within the window: their
    length less the part any device activity covers."""
    w0, w1 = trace.window
    host = _merged(sorted((max(s, w0), min(e, w1)) for s, e in intervals if s < w1 and e > w0))
    busy = _merged(sorted((a.start, a.end) for a in trace.activities))
    return sum(e - s for s, e in host) - _overlap_ns(host, busy)


def idle_per(res: dict, names: Tuple[str, ...], per: Tuple[str, ...], scale: float) -> Optional[float]:
    """Device-idle time under the spans whose names start with one of
    `names`, over the count of spans named in `per`, in units of `scale`
    seconds; None on an untraced run or when the program recorded no span."""
    t = res["trace"]
    if t is None or not t.activities:
        return None
    spans = window_spans(t)
    if spans is None:
        return None
    n = sum(1 for s in spans if s.name in per)
    if not n:
        return None
    ns = idle_ns(t, [(s.start_ns, s.end_ns) for s in spans if s.name.startswith(names)])
    return ns * 1e-9 / scale / n


def idle_by_span(trace: Trace, spans: list) -> Dict[str, int]:
    """The window's device-idle ns by the innermost span open on the host
    (the latest opened of those open; one thread's spans nest), `(none)`
    where no span is open."""
    w0, w1 = trace.window
    busy = _merged(sorted((a.start, a.end) for a in trace.activities))
    starts = [s for s, _ in busy]
    done = [0]
    for s, e in busy:
        done.append(done[-1] + e - s)

    def busy_until(t: int) -> int:
        i = bisect.bisect_right(starts, t)
        return done[i] - (max(0, busy[i - 1][1] - t) if i else 0)

    events = sorted([(max(s.start_ns, w0), 1, k) for k, s in enumerate(spans)]
                    + [(min(s.end_ns, w1), 0, k) for k, s in enumerate(spans)] + [(w1, 0, -1)])
    out: Dict[str, int] = collections.defaultdict(int)
    open_: List[int] = []
    t = w0
    for at, opens, k in events:
        if at > t:
            idle = (at - t) - (busy_until(at) - busy_until(t))
            out[spans[open_[-1]].name if open_ else "(none)"] += idle
            t = at
        if k < 0:
            continue
        if opens:
            open_.append(k)
        else:
            open_.remove(k)
    return dict(out)


def launched_under(trace: Trace, spans: list, name: str, activities) -> Tuple[int, List[int]]:
    """Of `activities`, how many were launched under no span `name`, and
    how many under each such span (in the spans' order; one thread's spans
    of one name never overlap)."""
    ranges = sorted((s.start_ns, s.end_ns) for s in spans if s.name == name)
    per = [0] * len(ranges)
    outside = 0
    for a in activities:
        i = bisect.bisect_right(ranges, (a.launched, float("inf"))) - 1 if a.launched is not None else -1
        if i >= 0 and ranges[i][0] <= a.launched < ranges[i][1]:
            per[i] += 1
        else:
            outside += 1
    return outside, per


def report(res: dict, metrics: dict, correct: bool) -> dict:
    t = res["trace"]
    spans = window_spans(t) or []
    by_span = idle_by_span(t, spans)
    idle = sum(by_span.values())
    host: Dict[str, List[int]] = collections.defaultdict(list)
    for s in spans:
        host[s.name].append(min(s.end_ns, t.window[1]) - max(s.start_ns, t.window[0]))
    launches = {}
    for kernel, under in (("K3", "hbird.forward"), ("K1", "hbird.search"), ("K2", "hbird.search")):
        acts = [a for a in t.kernels(kernel) if "merge_parts" not in a.name]
        outside, per = launched_under(t, spans, under, acts)
        launches[kernel] = {"launches": len(acts), "outside": outside, "spans": len(per),
                            "per_span": dict(collections.Counter(per))}
    return {
        "correct": correct, "metrics": metrics, "window_s": t.window_s, "idle_s": idle * 1e-9,
        "idle_by_span_s": {k: v * 1e-9 for k, v in sorted(by_span.items(), key=lambda kv: -kv[1])},
        "uncovered_share": by_span.get("(none)", 0) / idle if idle else None,
        "host_ms": {k: {"n": len(v), "mean": sum(v) / len(v) * 1e-6} for k, v in sorted(host.items())},
        "launched_under": launches, "jobs_s": res.get("jobs"), "job_phases": res.get("job_phases"),
    }


def main(argv: Optional[list] = None) -> int:
    t0 = time.perf_counter()
    p = argparse.ArgumentParser(description="The idle time of a traced run of a cell by program span")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)

    import torch

    from portbench import run
    from portbench.harness import Ctx

    spec = run.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench.spans: needs a CUDA device", file=sys.stderr)
        return 2
    ctx = Ctx(args.workload, spec["config"], spec["traffic"], args.seed, args.seconds, True,
              torch.device("cuda", 0), t0)
    out = run.execute(ctx, spec["per_layer"], spec["limits"])
    print(json.dumps(report(out["res"], out["metrics"], bool(out["correct"]))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
