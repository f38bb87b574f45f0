"""The reduction from a ``torch.profiler`` trace to the numbers a traced run
reports: device busy time, the operations that took most device time, the
idle gaps by the benchmark span the host was in, and each kernel's device
time and launch count.

Only the benchmark's own ``record_function`` spans, named
``perfbench.<layer>``, name an idle gap; the host span under a gap is the
innermost of them that covers the gap's start.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

SPAN_PREFIX = "perfbench."


@dataclass
class TraceSummary:
    busy_s: float                     # union of device activity
    window_s: float                   # first to last traced event
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    kernel_s: Dict[str, float] = field(default_factory=dict)
    kernel_launches: Dict[str, int] = field(default_factory=dict)

    def kernel_time(self, fragment: str) -> float:
        return sum(t for n, t in self.kernel_s.items() if fragment in n)

    def launches(self, fragment: str = "") -> int:
        return sum(c for n, c in self.kernel_launches.items()
                   if fragment in n)


def _kind(e) -> str:
    """``kernel``, ``device`` (memcpy, memset), ``span`` (a user annotation
    on the host), ``device_span`` (its copy on the device's timeline, which
    is no device work) or ``host``."""
    on_device = "cuda" in str(e.device_type()).lower()
    name = e.name()
    if e.is_user_annotation() or name.startswith(SPAN_PREFIX):
        return "device_span" if on_device else "span"
    if not on_device:
        return "host"
    if name.startswith(("Memcpy", "Memset", "Memory")):
        return "device"
    return "kernel"


def _union(intervals):
    """Merged ``[start, end)`` intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(prof, top: int = 10) -> TraceSummary:
    """Reduce a finished ``torch.profiler.profile`` to a
    :class:`TraceSummary` (times in seconds)."""
    dev, spans, starts, ends = [], [], [], []
    kernel_s: Dict[str, float] = {}
    launches: Dict[str, int] = {}
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        kind = _kind(e)
        starts.append(s)
        ends.append(s + d)
        if kind in ("kernel", "device"):
            dev.append((s, s + d))
            name = e.name()
            kernel_s[name] = kernel_s.get(name, 0.0) + d * 1e-9
            if kind == "kernel":
                launches[name] = launches.get(name, 0) + 1
        elif kind == "span" and e.name().startswith(SPAN_PREFIX):
            spans.append((s, s + d, e.name()))
    if not starts:
        return TraceSummary(0.0, 0.0, [], [])
    t0, t1 = min(starts), max(ends)
    busy = _union(dev)
    busy_ns = sum(e - s for s, e in busy)
    gaps = []
    prev = t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    by_span: Dict[str, float] = {}
    for gs, ge in gaps:
        inner, width = "outside perfbench spans", None
        for s, e, name in spans:
            if s <= gs < e and (width is None or e - s < width):
                inner, width = name, e - s
        by_span[inner] = by_span.get(inner, 0.0) + (ge - gs) * 1e-9
    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:top]
    gaps_top = sorted(by_span.items(), key=lambda kv: -kv[1])[:top]
    return TraceSummary(busy_ns * 1e-9, (t1 - t0) * 1e-9,
                        [[n, t] for n, t in ops], [[n, t] for n, t in gaps_top],
                        kernel_s, launches)
