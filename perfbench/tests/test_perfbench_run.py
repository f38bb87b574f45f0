"""The command's contract on the CPU: a run at a tiny size gives a last
line that parses with the keys a result must have; the command itself, with
no CUDA device, exits non-zero and prints no result; no run loads JAX or
the JAX package, compared by whole top-level module names."""

import json
import os
import subprocess
import sys

import pytest

from conftest import PERFBENCH, ROOT, tiny_run


@pytest.mark.parametrize("workload,trace", [
    ("stereo_kitti.refine", False), ("stereo_kitti.refine", True)])
def test_tiny_run_result_parses(spec, workload, trace):
    res = json.loads(json.dumps(tiny_run(spec, workload, 2**31 + 5, trace)))
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in res
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["attempted"] >= 1
    names = set(res["metrics"])
    if trace:
        assert "breakdown" in res
        assert {"busy_s", "window_s"} <= set(res["device"])
        layer = {m["name"] for m in spec["per_layer"]
                 if workload in m["workloads"]}
        assert names <= layer and names
    else:
        e2e = {m["name"] for m in spec["end_to_end"]
               if "workloads" not in m or workload in m["workloads"]}
        assert names == e2e
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}


def test_command_without_cuda_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, os.path.join("perfbench", "run.py"), "--workload",
         "stereo_kitti.refine", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert not proc.stdout.strip()


def test_forbidden_modules_compare_whole_top_level_names():
    import harness
    saved = dict(sys.modules)
    try:
        for name in ("srba_tpu_torch_extra", "jaxtyping", "flaxen"):
            sys.modules[name] = sys
        assert harness.forbidden_modules() == []
        sys.modules["srba_tpu.engine"] = sys
        sys.modules["jax"] = sys
        assert harness.forbidden_modules() == ["jax", "srba_tpu.engine"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import json, sys, torch\n"
        f"sys.path[:0] = [{PERFBENCH!r}, {ROOT!r}]\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['srba_tpu'] = None\n"
        "import harness\n"
        "from conftest import TINY, load_spec\n"
        "spec = load_spec()\n"
        "for w in TINY:\n"
        "    harness.run_cell(spec, w, 3, 0.2, False,\n"
        "                     device=torch.device('cpu'), sizes=TINY[w])\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                    'srba_tpu')\n"
        "             and sys.modules[m] is not None))\n")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=900,
        env=dict(os.environ, PYTHONPATH=os.path.join(PERFBENCH, "tests")))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_sources_name_no_jax():
    for dirpath, _, files in os.walk(PERFBENCH):
        for f in files:
            if f.endswith(".py") and "tests" not in dirpath:
                text = open(os.path.join(dirpath, f)).read()
                for bad in ("import jax", "from jax", "import srba_tpu\n",
                            "from srba_tpu ", "from srba_tpu.", "import flax"):
                    assert bad not in text, (f, bad)
