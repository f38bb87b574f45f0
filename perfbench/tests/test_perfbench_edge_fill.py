"""The reader of ``edge_fill_pct.refine``: the port's counters
``refine_edge_rows`` over ``refine_edge_slots`` while a trace records,
nothing where the port has no such counters, and its reading on a tiny
traced CPU run."""

import importlib.util
import math
import os

import tracing
from conftest import PERFBENCH, tiny_run

NAME = "edge_fill_pct.refine"


def _reader():
    path = os.path.join(PERFBENCH, "metrics", NAME + ".py")
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reader_divides_the_traced_counters(monkeypatch):
    from srba_tpu_torch.utils import profiler
    r = {"trace": tracing.TraceSummary(1.0, 2.0, [], [])}
    prof = profiler.Profiler()
    monkeypatch.setattr(profiler, "TRACED", prof)
    read = _reader().read
    assert read(r) is None                        # nothing traced yet
    prof.count("refine_edge_slots", 2200)
    assert read(r) is None                        # a port without rows
    prof.count("refine_edge_rows", 1964)
    assert math.isclose(read(r), 100.0 * 1964 / 2200, rel_tol=1e-12)
    assert read({"trace": None}) is None          # an untraced run
    monkeypatch.delattr(profiler, "TRACED")
    assert read(r) is None                        # a port without a tally


def test_tiny_traced_run_reports_the_edge_fill(spec):
    m = tiny_run(spec, "stereo_kitti.refine", 2**31 + 91,
                 trace=True)["metrics"]
    assert 0 < m[NAME]["value"] <= 100 and m[NAME]["unit"] == "%"
