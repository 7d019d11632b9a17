"""Phase timing, program spans and optional device tracing.

- `PhaseTimer`: wall-clock + items/sec per named phase, queryable as a
  dict. Phases that end in device work must synchronise before they
  close (the engine does), or the time measured is the enqueue. Each
  phase is also the span `hbird.phase.<name>`.
- `span`: a named range of host work. While a `torch.profiler` records in
  this process it is a `record_function` range in the profiler's trace and
  a `Span` in this module's store (`recorded_spans`), both on the clock the
  profiler stamps its events with (`time.time_ns`), so device activity in
  the same trace lines up with it. Otherwise it is one flag check. A span
  never synchronises the device: device time under it comes from the
  device trace, through each kernel's launch time.
- `maybe_trace`: wraps a phase in `torch.profiler.profile` and writes a
  Chrome trace under HBIRD_PROFILE_DIR when that variable is set. Zero
  overhead when unset.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

PROFILE_ENV = "HBIRD_PROFILE_DIR"


class Span(NamedTuple):
    name: str
    start_ns: int  # time.time_ns(), the profiler's clock
    end_ns: int
    id: int
    parent: Optional[int]  # id of the span open around it on its thread
    attrs: Dict[str, Any]


# The store holds spans across engines (each job builds its own), as the
# kernels' launch counters do; `clear_spans` empties it.
_SPANS: List[Span] = []
_IDS = itertools.count(1)
_OPEN = threading.local()  # .stack: ids of the spans open on this thread
_OFF = contextlib.nullcontext()


class _Recording:
    __slots__ = ("name", "attrs", "id", "parent", "start", "range")

    def __init__(self, name: str, attrs: Dict[str, Any]) -> None:
        self.name, self.attrs = name, attrs

    def __enter__(self) -> "_Recording":
        stack = _OPEN.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        self.id = next(_IDS)
        stack.append(self.id)
        self.start = time.time_ns()
        self.range = record_function(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.range.__exit__(*exc)
        end = time.time_ns()
        _OPEN.stack.pop()
        _SPANS.append(Span(self.name, self.start, end, self.id, self.parent, self.attrs))


def span(name: str, **attrs):
    """A context manager over a range of host work named `name`, with
    `attrs` kept beside it (the engine's: `engine`, its per-process serial,
    and `batch`, the index within the phase)."""
    if not _profiler_enabled():
        return _OFF
    return _Recording(name, attrs)


def recorded_spans() -> List[Span]:
    """A copy of the spans recorded so far, in the order they closed."""
    return list(_SPANS)


def clear_spans() -> None:
    _SPANS.clear()


class PhaseTimer:
    def __init__(self) -> None:
        self.phases: Dict[str, Dict[str, float]] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(f"hbird.phase.{name}"):
                yield self
        finally:
            rec = self.phases.setdefault(name, {"seconds": 0.0, "items": 0.0})
            rec["seconds"] += time.perf_counter() - t0

    def add_items(self, name: str, items: int) -> None:
        rec = self.phases.setdefault(name, {"seconds": 0.0, "items": 0.0})
        rec["items"] += items

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, rec in self.phases.items():
            entry = {"seconds": round(rec["seconds"], 3)}
            if rec["items"]:
                entry["items"] = int(rec["items"])
                entry["items_per_sec"] = round(rec["items"] / max(rec["seconds"], 1e-9), 2)
            out[name] = entry
        return out


@contextlib.contextmanager
def maybe_trace(name: str):
    """torch.profiler trace of this phase when HBIRD_PROFILE_DIR is set."""
    trace_dir = os.environ.get(PROFILE_ENV)
    if not trace_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))
