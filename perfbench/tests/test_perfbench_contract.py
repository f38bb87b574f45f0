"""``BENCHMARK.json`` against the rules its files follow: names, units,
files found by name, each reader's declared layer, unit, source and the
end-to-end metric it moves, and the chip time a full check takes."""

import importlib.util
import json
import os
import re

from conftest import PERFBENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _load(path):
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_keys_and_names():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["perfbench"]
    assert 1 <= spec["run_seconds"] <= 51
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in spec[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_files_found_by_name(spec):
    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
    for w in spec["workloads"]:
        path = os.path.join(PERFBENCH, "traffic",
                            f"{w['config']}.{w['traffic']}.json")
        with open(path) as f:
            traffic = json.load(f)
        assert os.path.exists(os.path.join(PERFBENCH, "drivers",
                                           traffic["driver"] + ".py"))
        assert w["chips"] == 1


def test_readers_declare_what_the_spec_says(spec):
    e2e = {m["name"] for m in spec["end_to_end"]}
    layers = {}
    for m in spec["per_layer"]:
        mod = _load(os.path.join(PERFBENCH, "metrics", m["name"] + ".py"))
        assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == \
            (m["layer"], m["unit"], m["source"], m["moves"])
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], m["layer"])
        assert mod.read({}) is None


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric(spec):
    for w in spec["workloads"]:
        e2e = [m for m in spec["end_to_end"]
               if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(w["name"] in m["workloads"] for m in spec["per_layer"])


def test_full_check_fits_the_budget_at_24_cells(spec):
    runs = 2 + 14 * 24
    total = runs * (spec["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
