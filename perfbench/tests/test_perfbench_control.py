"""The control comes out not correct: the program with TF32 switched on
(``torch.backends.cuda.matmul.allow_tf32``, the precision below the
configuration's float32 with TF32 off) reads above the cell's
``window_gap`` limit, while the program in float32, in the same process
and on the same map, reads under it; at the cell's own size, which the
card holds (about 90 s a seed).  Needs the card (TF32 exists only
there); run with ``python -m pytest perfbench/tests -m cuda``.
"""

import json
import os

import pytest

import calibrate
import harness
from conftest import PERFBENCH

# The cell's own size: on a shorter drive (80 keyframes, fewer windows)
# the TF32 program read 1.8e-5 and 3.7e-3 on two seeds of three, under the
# limit, where at the cell's size it reads over 2e-2.
SIZES = {}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_refine_control_is_not_correct(cuda_device, seed):
    import torch
    from reference import srba_sweep
    with open(os.path.join(PERFBENCH, "configs", "stereo_kitti.json")) as f:
        config = json.load(f)
    with open(os.path.join(PERFBENCH, "traffic",
                           "stereo_kitti.refine.json")) as f:
        traffic = json.load(f)
    driver = harness.load_file(os.path.join(PERFBENCH, "drivers",
                                            "refine_map.py"), "drv_control")
    cell = driver.Cell(config, traffic, seed, cuda_device, SIZES)
    cell.warm()
    cell.call()                      # float32: call 0
    calibrate.tf32_call(cell)        # TF32: call 1
    cell.release()
    p = cell.problem()
    windows = srba_sweep.plan_windows(p)
    limit = traffic["limits"]["window_gap"]
    gap = [cell.gaps(p, windows, cell.reference_sweep(p, windows, c),
                     cell.state_of(c + 1))["window_gap"] for c in (0, 1)]
    assert gap[0] <= limit < gap[1], gap
    assert torch.backends.cuda.matmul.allow_tf32 is False
