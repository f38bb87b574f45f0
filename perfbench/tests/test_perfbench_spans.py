"""Device time and idle time by program span (``span_trace.py``) on a
hand-made trace with correlation ids, and the readers of the port's traced
scopes and counters on a tiny traced CPU run."""

import importlib.util
import math
import os

import pytest

import span_trace
import tracing
from conftest import PERFBENCH, tiny_run

CPU, CUDA = "DeviceType.CPU", "DeviceType.CUDA"


class _Ev:
    def __init__(self, name, start, dur, dev=CPU, ann=False, corr=0,
                 linked=0, tid=1):
        self._n, self._s, self._d, self._dev, self._a = name, start, dur, \
            dev, ann
        self._c, self._l, self._t = corr, linked, tid

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._a

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def start_thread_id(self):
        return self._t


class _Prof:
    def __init__(self, events):
        self.profiler = type("K", (), {"kineto_results": type(
            "R", (), {"events": staticmethod(lambda: events)})()})()


def _span(name, start, dur, tid=1):
    return _Ev(name, start, dur, ann=True, tid=tid)


SPANS = [_span("perfbench.refine_map", 0, 1000),
         _span("srba.refine_map_phase", 100, 300),
         _span("srba.lm.normal_eqs", 150, 100),
         _span("srba.refine_map_windows", 500, 200),
         _span("srba.worker", 155, 10, tid=2)]
OTHER = [
    # Launches on the host: the runtime calls carry the CUPTI ids.
    _Ev("cudaMemcpyAsync", 50, 5, corr=14),
    _Ev("cudaLaunchKernel", 160, 5, corr=11),
    _Ev("cudaLaunchKernel", 300, 5, corr=12),
    _Ev("cudaLaunchKernel", 550, 5, corr=13),
    # An operator whose own id collides with a kernel's: no launch.
    _Ev("aten::mm", 900, 5, corr=13),
    # The device: each operation's id is its launch's; the linked id (the
    # operator's) is not the link.
    _Ev("Memcpy HtoD", 60, 20, CUDA, corr=14),
    _Ev("gemm", 200, 60, CUDA, corr=11, linked=13),
    _Ev("spd_inverse_staged<3>", 400, 50, CUDA, corr=12, linked=13),
    _Ev("elementwise", 800, 50, CUDA, corr=13, linked=11),
    _Ev("unlaunched", 900, 10, CUDA, corr=99),
    _Ev("srba.refine_map_phase", 200, 250, CUDA, ann=True)]   # no work


def test_device_time_goes_to_the_span_over_the_launch():
    t = span_trace.summarize_spans(SPANS + OTHER)
    want = {"perfbench.refine_map": 20e-9, "srba.lm.normal_eqs": 60e-9,
            "srba.refine_map_phase": 50e-9, "srba.refine_map_windows": 50e-9,
            span_trace.OUTSIDE: 10e-9}
    assert t.device_s_by_span.keys() == want.keys()
    for k, v in want.items():
        assert math.isclose(t.device_s_by_span[k], v, rel_tol=1e-12), k
    assert (t.linked_ops, t.device_ops) == (4, 5)
    assert t.span_counts["srba.lm.normal_eqs"] == 1
    assert math.isclose(t.host_s_by_span["srba.refine_map_phase"], 300e-9)


def test_self_idle_by_overlap():
    t = span_trace.summarize_spans(SPANS + OTHER)
    # Busy [60,80) [200,260) [400,450) [800,850) [900,910) of [0,1000).
    want = {"perfbench.refine_map": 370e-9, "srba.refine_map_phase": 190e-9,
            "srba.lm.normal_eqs": 40e-9, "srba.worker": 10e-9,
            "srba.refine_map_windows": 200e-9}
    assert t.idle_s_by_span.keys() == want.keys()
    for k, v in want.items():
        assert math.isclose(t.idle_s_by_span[k], v, rel_tol=1e-12), k
    assert math.isclose(sum(t.idle_s_by_span.values()), 810e-9,
                        rel_tol=1e-12)
    per = span_trace.per_phase(t, 2)
    assert math.isclose(per["sweep_build_idle_ms"], 1e3 * 200e-9 / 2)
    assert math.isclose(per["neq_device_ms"], 1e3 * 60e-9 / 2)
    assert math.isclose(per["schur_device_ms"], 0.0)


def test_srba_spans_leave_the_whole_trace_summary_as_it_was():
    plain = [e for e in SPANS + OTHER if not e.name().startswith("srba.")]
    a = tracing.summarize(_Prof(SPANS + OTHER))
    b = tracing.summarize(_Prof(plain))
    assert (a.busy_s, a.window_s, a.kernel_s, a.kernel_launches) == \
        (b.busy_s, b.window_s, b.kernel_s, b.kernel_launches)
    assert a.launches() == 4


def _reader(name):
    path = os.path.join(PERFBENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


READERS = ("sweep_build_ms.refine", "lm_active_trips_pct.refine",
           "obs_fill_pct.refine")


@pytest.mark.parametrize("name", READERS)
def test_readers_need_the_port_s_traced_tally(monkeypatch, name):
    from srba_tpu_torch.utils import profiler
    r = {"trace": tracing.TraceSummary(1.0, 2.0, [], [])}
    monkeypatch.setattr(profiler, "TRACED", profiler.Profiler())
    assert _reader(name).read(r) is None          # nothing traced yet
    monkeypatch.delattr(profiler, "TRACED")
    assert _reader(name).read(r) is None          # a port without it


def test_tiny_traced_run_reports_the_program_s_readings(spec):
    res = tiny_run(spec, "stereo_kitti.refine", 2**31 + 77, trace=True)
    m = res["metrics"]
    assert set(READERS) <= set(m)
    assert m["sweep_build_ms.refine"]["value"] > 0
    for name in READERS[1:]:
        assert 0 < m[name]["value"] <= 100
        assert m[name]["unit"] == "%"
    assert all(math.isfinite(v["value"]) for v in m.values())
