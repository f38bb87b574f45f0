"""Device time and device-idle time by program span, from a
``torch.profiler`` trace, and a command that prints them for one cell.

The spans are the benchmark's own (``perfbench.<layer>``) and the port's
(``srba.<scope>``: its profiler scopes and spans, recorded only while a
trace is on).  Two reductions, on the host spans of the trace:

* ``device_s_by_span``: each device operation's time (kernels, copies and
  fills) goes to the innermost span that covers its launch, the host
  runtime call with the operation's CUPTI correlation id, among the spans
  of the launching thread.  An operation whose launch is not in the trace,
  or lies outside every span, goes to ``OUTSIDE``.
* ``idle_s_by_span``: the device-idle time (the window less the union of
  device activity) that falls inside a span's interval and inside none of
  its children (self-idle, by overlap), over the spans of every thread.

Run as::

    python3 perfbench/span_trace.py --workload stereo_kitti.refine \\
        --seed <n>

from the root of a checkout: the cell's set-up, then its traced calls (as
a ``--trace 1`` run makes them) under the profiler, then one JSON line with
both reductions, the spans' counts and host durations, and the per-phase
readings they give.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, List, Tuple

import tracing

PREFIXES = ("perfbench.", "srba.")
OUTSIDE = "outside spans"


@dataclass
class SpanTimes:
    device_s_by_span: Dict[str, float]
    idle_s_by_span: Dict[str, float]
    host_s_by_span: Dict[str, float]  # the spans' own durations, summed
    span_counts: Dict[str, int]
    linked_ops: int                   # device operations with a launch found
    device_ops: int


def _segments(spans) -> Tuple[List[int], List[str]]:
    """The timeline cut at every span boundary: ``(starts, names)``, where
    ``names[i]`` is the innermost (shortest) span covering ``[starts[i],
    starts[i+1])``, or ``OUTSIDE``."""
    cuts = sorted({t for s, e, _ in spans for t in (s, e)})
    names = []
    for a in cuts:
        inner, width = OUTSIDE, None
        for s, e, name in spans:
            if s <= a < e and (width is None or e - s < width):
                inner, width = name, e - s
        names.append(inner)
    return cuts, names


def _at(table, t) -> str:
    cuts, names = table
    i = bisect.bisect_right(cuts, t) - 1
    return names[i] if i >= 0 else OUTSIDE


def summarize_spans(events) -> SpanTimes:
    """Reduce the kineto events of a finished trace
    (``prof.profiler.kineto_results.events()``) by span."""
    dev, spans, launches, ends = [], [], {}, []
    counts: Dict[str, int] = {}
    host: Dict[str, float] = {}
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        ends.append((s, s + d))
        kind, name = tracing._kind(e), e.name()
        if kind in ("kernel", "device"):
            dev.append((s, s + d, e.correlation_id()))
        elif kind == "span" and name.startswith(PREFIXES):
            spans.append((s, s + d, name, e.start_thread_id()))
            counts[name] = counts.get(name, 0) + 1
            host[name] = host.get(name, 0.0) + d * 1e-9
        elif kind == "host" and name.startswith("cu"):
            # cudaLaunchKernel, cuLaunchKernelEx, cudaMemcpyAsync, ...
            launches[e.correlation_id()] = (s, e.start_thread_id())
    by_thread: Dict[int, list] = {}
    for s, e, name, tid in spans:
        by_thread.setdefault(tid, []).append((s, e, name))
    tables = {tid: _segments(sp) for tid, sp in by_thread.items()}
    device: Dict[str, float] = {}
    linked = 0
    for s, e, corr in dev:
        launch = launches.get(corr)
        name = OUTSIDE
        if launch is not None:
            linked += 1
            table = tables.get(launch[1])
            if table is not None:
                name = _at(table, launch[0])
        device[name] = device.get(name, 0.0) + (e - s) * 1e-9
    idle: Dict[str, float] = {}
    if ends:
        t0, t1 = min(s for s, _ in ends), max(e for _, e in ends)
        busy = tracing._union([(s, e) for s, e, _ in dev])
        gaps, prev = [], t0
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if t1 > prev:
            gaps.append((prev, t1))
        cuts, names = _segments([(s, e, n) for s, e, n, _ in spans])
        for a, ge in gaps:
            while a < ge:   # the gap cut where the innermost span changes
                i = bisect.bisect_right(cuts, a)
                b = min(ge, cuts[i]) if i < len(cuts) else ge
                name = names[i - 1] if i else OUTSIDE
                idle[name] = idle.get(name, 0.0) + (b - a) * 1e-9
                a = b
    return SpanTimes(device, idle, host, counts, linked, len(dev))


def per_phase(times: SpanTimes, phases: int) -> Dict[str, float]:
    """The per-phase readings of the refine spans, in ms."""
    d, i = times.device_s_by_span, times.idle_s_by_span
    build = ("srba.refine_map_windows", "srba.refine_map_pack")
    return {
        "sweep_build_idle_ms": 1e3 * sum(i.get(n, 0.0) for n in build)
        / phases,
        "neq_device_ms": 1e3 * d.get("srba.lm.normal_eqs", 0.0) / phases,
        "schur_device_ms": 1e3 * d.get("srba.lm.solve_delta", 0.0) / phases,
    }


def main(argv=None) -> int:
    import argparse
    import json
    import os
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    with open(os.path.join(os.path.dirname(here), "BENCHMARK.json")) as f:
        spec = json.load(f)
    import run     # the host thread pools as run.py fixes them
    w = next(x for x in spec["workloads"] if x["name"] == args.workload)
    threads = run.host_threads(w["config"])
    for var in run.THREAD_VARS:
        os.environ[var] = str(threads)
    sys.path[:0] = [os.path.dirname(here)]
    import torch
    from torch.profiler import ProfilerActivity, profile

    import harness
    torch.set_num_threads(threads)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(here, "configs", w["config"] + ".json")) as f:
        config = json.load(f)
    with open(os.path.join(here, "traffic",
                           f"{w['config']}.{w['traffic']}.json")) as f:
        traffic = json.load(f)
    driver = harness.load_file(
        os.path.join(here, "drivers", traffic["driver"] + ".py"), "driver")
    device = torch.device("cuda", 0)
    sut = driver.Cell(config, traffic, args.seed, device)
    sut.warm()
    torch.cuda.synchronize(device)
    with sut.traced(), profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
        for _ in range(sut.trace_calls):
            sut.call()
        torch.cuda.synchronize(device)
    events = prof.profiler.kineto_results.events()
    whole = tracing.summarize(prof)
    times = summarize_spans(events)
    phases = sut.readings()["phases"]
    print(json.dumps({
        "device": torch.cuda.get_device_name(device), "seed": args.seed,
        "phases": phases, "busy_s": whole.busy_s,
        "window_s": whole.window_s, "launches": whole.launches(),
        "idle_gaps": whole.idle_gaps,
        "device_s_by_span": times.device_s_by_span,
        "idle_s_by_span": times.idle_s_by_span,
        "host_s_by_span": times.host_s_by_span,
        "span_counts": times.span_counts,
        "linked_ops": times.linked_ops, "device_ops": times.device_ops,
        "per_phase": per_phase(times, phases)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
