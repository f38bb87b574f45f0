"""The trace reduction on a hand-made trace: busy time is the union of
device intervals, an idle gap goes to the innermost benchmark span that
covers its start, and the readers that need a trace return nothing
without one."""

import importlib.util
import os

import tracing
from conftest import PERFBENCH


class _Ev:
    def __init__(self, name, start, dur, dev="DeviceType.CPU", ann=False):
        self._n, self._s, self._d, self._dev, self._a = name, start, dur, \
            dev, ann

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


class _Prof:
    def __init__(self, events):
        self.profiler = type("K", (), {"kineto_results": type(
            "R", (), {"events": staticmethod(lambda: events)})()})()


def test_busy_union_and_gaps_by_innermost_span():
    cuda = "DeviceType.CUDA"
    ev = [_Ev("perfbench.outer", 0, 100, ann=True),
          _Ev("perfbench.inner", 40, 30, ann=True),
          _Ev("spd_inverse_staged<6>", 10, 20, cuda),
          _Ev("gemm", 20, 20, cuda),          # overlaps the first
          _Ev("Memcpy HtoD", 80, 10, cuda),
          _Ev("perfbench.outer", 0, 100, cuda, ann=True)]   # no device work
    s = tracing.summarize(_Prof(ev))
    assert abs(s.busy_s - 40e-9) < 1e-15          # [10,40) + [80,90)
    assert abs(s.window_s - 100e-9) < 1e-15
    gaps = dict(s.idle_gaps)
    assert abs(gaps["perfbench.inner"] - 40e-9) < 1e-15      # [40,80)
    assert abs(gaps["perfbench.outer"] - 20e-9) < 1e-15      # [0,10), [90,100)
    assert s.launches() == 2 and s.launches("spd_inverse") == 1
    assert abs(s.kernel_time("spd_inverse") - 20e-9) < 1e-15


def test_roofline_reader_counts_each_block_once():
    path = os.path.join(PERFBENCH, "metrics", "spd_inverse_roofline.refine.py")
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    trace = tracing.TraceSummary(1.0, 2.0, [], [],
                                 kernel_s={"spd_inverse_staged": 1e-3})
    r = {"trace": trace, "launches_by_shape": {(32768, 6): 10},
         "hbm_bytes_per_s": 3.35e12}
    want = 100.0 * 10 * 32768 * 36 * 8 / 3.35e12 / 1e-3
    assert abs(mod.read(r) - want) < 1e-9
    assert mod.read({"trace": None}) is None
