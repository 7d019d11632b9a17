"""The traced window: `torch.profiler` over the window, read in memory.

`Trace` holds the device's activities (kernels, copies and sets) with the
host time of the call that launched each, and the benchmark's spans
(`portbench.*` profiler ranges). Readers ask it for the device time of the
kernels launched under a span, of one of the port's kernels, or the union
of busy intervals.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_API = re.compile(r"^cu(da)?[A-Z]")  # runtime and driver calls: cudaLaunchKernel, cuLaunchKernelEx, ...


@dataclass
class Activity:
    name: str
    start: int  # ns, device
    end: int
    stream: int
    launched: Optional[int]  # ns, host time of the launching call


@dataclass
class Trace:
    window: Tuple[int, int]  # ns
    activities: List[Activity]
    spans: Dict[str, List[Tuple[int, int]]] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_s(self) -> float:
        """Seconds in which at least one activity ran (the union)."""
        return _union_ns(sorted((a.start, a.end) for a in self.activities)) * 1e-9

    def under(self, span: str) -> List[Activity]:
        """Activities launched while `span` was open on the host."""
        return [a for a in self.activities if a.launched is not None and _inside(self.spans.get(span, []), a.launched)]

    def kernels(self, kernel: str) -> List[Activity]:
        """One of the port's kernels by name: 'K1' (the flat top-k and the
        merge it launches after it), 'K2' (the probed-leaf top-k and its
        merge) or 'K3' (flash attention forward)."""
        if kernel == "K3":
            return [a for a in self.activities if "flash_bf16_wgmma" in a.name or "flash_f32_wgmma" in a.name]
        want = {"K1": "Flat", "K2": "Slabs"}[kernel]
        out, last = [], {}
        for a in sorted(self.activities, key=lambda a: a.start):
            if "topk_wgmma" in a.name:
                last[a.stream] = want in a.name
                if last[a.stream]:
                    out.append(a)
            elif "merge_parts" in a.name and last.get(a.stream):
                out.append(a)
        return out

    def calls(self, kernel: str) -> int:
        """Launches of K1 or K2's top-k kernel, or of K3."""
        ks = self.kernels(kernel)
        return len([a for a in ks if "merge_parts" not in a.name])

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the innermost benchmark span open on the host."""
        by_name: Dict[str, int] = {}
        for a in self.activities:
            by_name[a.name[:120]] = by_name.get(a.name[:120], 0) + a.end - a.start
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        t = self.window[0]
        for s, e in _merged(sorted((a.start, a.end) for a in self.activities)) + [(self.window[1], self.window[1])]:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return {
            "device_ops": [[n, ns * 1e-9] for n, ns in ops],
            "idle_gaps": [[self._host_doing(g0), (g1 - g0) * 1e-9] for g0, g1 in gaps],
        }

    def _host_doing(self, t: int) -> str:
        best, width = "outside any span", None
        for name, ranges in self.spans.items():
            for s, e in ranges:
                if s <= t < e and (width is None or e - s < width):
                    best, width = name, e - s
        return best


def _merged(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _union_ns(intervals: List[Tuple[int, int]]) -> int:
    return sum(e - s for s, e in _merged(intervals))


def _inside(ranges: List[Tuple[int, int]], t: int) -> bool:
    i = bisect.bisect_right(ranges, (t, float("inf"))) - 1
    return i >= 0 and ranges[i][0] <= t < ranges[i][1]


def parse(prof) -> Trace:
    """Read a finished `torch.profiler.profile` whose window is the
    `portbench.window` span into a Trace."""
    from torch.autograd import DeviceType

    launches: Dict[int, int] = {}
    device = []
    spans: Dict[str, List[Tuple[int, int]]] = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            # The profiler mirrors each span onto the device's timeline as a
            # "user annotation"; only kernels, copies and sets are activity.
            if not (name.startswith("portbench.") or e.is_user_annotation()):
                device.append(e)
            continue
        if name.startswith("portbench."):
            spans.setdefault(name, []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif _API.match(name):
            launches[e.correlation_id()] = e.start_ns()
    for ranges in spans.values():
        ranges.sort()
    acts = [Activity(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.device_resource_id(),
                     launches.get(e.correlation_id())) for e in device]
    window = spans["portbench.window"][0]
    acts = [a for a in acts if a.end > window[0] and a.start < window[1]]
    for a in acts:
        a.start, a.end = max(a.start, window[0]), min(a.end, window[1])
    return Trace(window=window, activities=acts, spans=spans)
