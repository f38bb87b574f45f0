"""Shared set-up of the benchmark's tests: the benchmark's folder and the
checkout's root on ``sys.path``, as ``run.py`` puts them, and the
``cuda`` marker's skip, decided when a test runs."""

import json
import os
import sys

import pytest

PERFBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PERFBENCH)
for p in (ROOT, PERFBENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def load_spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture
def spec():
    return load_spec()


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); none here")
    return torch.device("cuda", 0)


# Sizes a CPU test run can hold: a 30-keyframe drive past a lower, sparser
# facade; and 60 keyframes of it, where one sweep after the warm one still
# moves the map (at 30 the warm sweep leaves nothing to move).
TINY = {
    "stereo_kitti.refine": {"num_keyframes": 30,
                            "world": {"facade_top_m": 3.5,
                                      "cell_along_m": 2.0}},
}
SMALL = {
    "stereo_kitti.refine": {"num_keyframes": 60,
                            "world": {"facade_top_m": 3.5,
                                      "cell_along_m": 2.0}},
}


def tiny_run(spec, workload, seed, trace=False, seconds=0.5, sizes=TINY):
    import harness
    import torch
    return harness.run_cell(spec, workload, seed, seconds, trace,
                            device=torch.device("cpu"),
                            sizes=sizes[workload], threads=2)
