"""The plain reference agrees with the port at a size the CPU can hold: the
edges and priors of a short stereo drive, and one refinement sweep of it.
Also the reference's own arithmetic, and that it repeats itself exactly."""

import json
import os

import numpy as np
import torch

from conftest import PERFBENCH, TINY, tiny_run
from reference import srba_sweep


def test_so3_helpers_round_trip():
    g = torch.Generator().manual_seed(0)
    w = torch.randn((50, 3), generator=g, dtype=torch.float64)
    w = w / torch.linalg.vector_norm(w, dim=-1, keepdim=True) * \
        torch.rand((50, 1), generator=g, dtype=torch.float64) * 3.0
    R = srba_sweep.so3_exp(w)
    assert torch.allclose(R @ R.transpose(-1, -2),
                          torch.eye(3, dtype=torch.float64).expand(50, 3, 3),
                          atol=1e-12)
    assert torch.allclose(srba_sweep.so3_log(R), w, atol=1e-9)


def test_refine_reference_agrees_with_port(spec):
    res = tiny_run(spec, "stereo_kitti.refine", 2**31 + 22)
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert checks["start_mismatches"] == 0
    assert checks["edge_mismatches"] == 0
    assert checks["windows_mismatch"] == 0
    assert abs(checks["window_gap"]) < 1e-5


def test_reference_sweep_repeats_exactly(spec):
    import harness
    with open(os.path.join(PERFBENCH, "configs", "stereo_kitti.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(PERFBENCH, "traffic",
                           "stereo_kitti.refine.json")) as f:
        traffic = json.load(f)
    driver = harness.load_file(os.path.join(PERFBENCH, "drivers",
                                            "refine_map.py"), "drv")
    cell = driver.Cell(cfg, traffic, 7, torch.device("cpu"),
                       TINY["stereo_kitti.refine"])
    cell.warm()
    cell.release()
    p = cell.problem()
    assert cell.edge_mismatches(p) == 0
    assert cell.prior_gaps["m"] < 1e-5 and cell.prior_gaps["rad"] < 1e-6
    windows = srba_sweep.plan_windows(p)
    a = cell.reference_sweep(p, windows, 0)
    b = cell.reference_sweep(p, windows, 0)
    assert torch.equal(a.t, b.t) and torch.equal(a.lm, b.lm)
    gaps = cell.gaps(p, windows, a, b.to(torch.float64))
    assert gaps == dict.fromkeys(gaps, 0.0)
