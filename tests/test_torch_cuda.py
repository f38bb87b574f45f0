"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).  The CUDA
kernel has no CPU or interpret mode, so without a card they skip.  On a
machine with a card and no JAX, run them with

    python -m pytest -o addopts="" -m cuda tests/test_torch_cuda.py

(``-o addopts=""`` drops the JAX package's test boot plugin from the
pytest settings).  This file imports no JAX.

Tolerances: kernel vs plain at rtol 2e-4 / atol 2e-5 (the block tests'
tolerance); CUDA vs CPU engine state at atol 1e-3 (the e2e parity
tolerance of tests/test_torch_e2e_rb2d.py, _rb3d.py and _graphslam.py).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or "
                    "interpret mode")
    return torch.device("cuda")


def _spd_stack(B, d, seed=0, cond=5.0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, d, d)).astype(np.float32)
    return A @ A.transpose(0, 2, 1) + cond * np.eye(d, dtype=np.float32)


@pytest.mark.parametrize("d", [1, 2, 3, 6])
@pytest.mark.parametrize("B", [1, 7, 300, 2048])
def test_kernel_matches_plain(cuda, B, d):
    from srba_tpu_torch.ops import block_linalg as bl
    m = torch.as_tensor(_spd_stack(B, d), device=cuda)
    n0 = bl.spd_inverse_cuda.launches
    out = bl.spd_inverse(m)
    torch.cuda.synchronize()
    assert bl.spd_inverse_cuda.launches == n0 + 1
    torch.testing.assert_close(out, bl.spd_inverse_unrolled(m), rtol=2e-4,
                               atol=2e-5)


def test_kernel_rejects_what_it_does_not_take(cuda):
    from srba_tpu_torch.ops import block_linalg as bl
    m = torch.as_tensor(_spd_stack(8, 2), device=cuda)
    with pytest.raises(TypeError):
        bl.spd_inverse_cuda(m.double())
    with pytest.raises(ValueError):
        bl.spd_inverse_cuda(m.transpose(-1, -2))
    with pytest.raises(ValueError):
        bl.spd_inverse_cuda(torch.eye(4, device=cuda).repeat(3, 1, 1))


def _run(device, frames, odometry, model="RangeBearing2D", sigma=0.005):
    import srba_tpu_torch as port
    from srba_tpu_torch.models.noise import NoiseIdentity
    eng = port.SrbaEngine(
        model, noise=NoiseIdentity(sigma),
        params=port.SrbaParams(max_tree_depth=3, max_optimize_depth=3),
        device=device)
    for k, frame in enumerate(frames):
        eng.define_new_keyframe(
            [port.Observation(lm_id=m, z=z) for m, z in frame],
            edge_init={k - 1: odometry[k - 1]} if k else None)
    return eng


def test_engine_on_cuda_matches_cpu_and_repeats_bitwise(cuda):
    from srba_tpu_torch.ops import block_linalg as bl
    from srba_tpu_torch.utils.datasets import make_world_loop_2d, observe
    world = make_world_loop_2d(num_kfs=25, radius=6.0, num_landmarks=60,
                               seed=7)
    ds = observe(world, "RangeBearing2D", noise_std=0.005, sensor_range=5.0,
                 odo_noise_std=0.03, seed=7)
    n0 = bl.spd_inverse_cuda.launches
    eg = _run("cuda", ds.frames, ds.odometry)
    assert bl.spd_inverse_cuda.launches > n0
    ec = _run("cpu", ds.frames, ds.odometry)
    sg, sc = eg.get_rba_state(), ec.get_rba_state()
    np.testing.assert_allclose(sg.k2k_pose[:sg.num_edges],
                               sc.k2k_pose[:sc.num_edges], atol=1e-3)
    np.testing.assert_allclose(sg.lm_state[:sg.num_lms],
                               sc.lm_state[:sc.num_lms], atol=1e-3)
    eg2 = _run("cuda", ds.frames, ds.odometry)
    assert torch.equal(eg.device_master.pose, eg2.device_master.pose)
    assert torch.equal(eg.device_master.lm, eg2.device_master.lm)


def _wide_dataset(model):
    from srba_tpu_torch.utils import datasets as tds
    if model == "RangeBearing3D":
        world = tds.make_world_loop_3d(num_kfs=20, radius=6.0,
                                       num_landmarks=80, seed=2)
        return tds.observe(world, model, noise_std=0.005, sensor_range=5.0,
                           odo_noise_std=0.02, seed=2), 0.005
    world = tds.make_world_loop_2d(num_kfs=25, radius=5.0, num_landmarks=1,
                                   seed=4)
    return tds.make_graph_slam_dataset(world, noise_std=0.005,
                                       odo_noise_std=0.05,
                                       loop_closure_range=3.0, seed=4), 0.005


@pytest.mark.parametrize("model", ["RangeBearing3D", "RelativePoses2D"])
def test_se3_and_graph_slam_engines_on_cuda_match_cpu(cuda, model):
    """The 20-KF 3D range-bearing loop and the 25-KF graph-SLAM loop on the
    card against the CPU, through the kernel at block size 3, and bitwise
    equal masters on a rerun."""
    from srba_tpu_torch.ops import block_linalg as bl
    ds, sigma = _wide_dataset(model)
    n0 = bl.spd_inverse_cuda.launches_by_d.get(3, 0)
    eg = _run("cuda", ds.frames, ds.odometry, model, sigma)
    assert bl.spd_inverse_cuda.launches_by_d.get(3, 0) > n0
    assert eg.device_master.pose.is_cuda and eg.device_master.lm.is_cuda
    ec = _run("cpu", ds.frames, ds.odometry, model, sigma)
    sg, sc = eg.get_rba_state(), ec.get_rba_state()
    assert (sg.num_edges, sg.num_lms) == (sc.num_edges, sc.num_lms)
    np.testing.assert_allclose(sg.k2k_pose[:sg.num_edges],
                               sc.k2k_pose[:sc.num_edges], atol=1e-3)
    np.testing.assert_allclose(sg.lm_state[:sg.num_lms],
                               sc.lm_state[:sc.num_lms], atol=1e-3)
    eg2 = _run("cuda", ds.frames, ds.odometry, model, sigma)
    assert torch.equal(eg.device_master.pose, eg2.device_master.pose)
    assert torch.equal(eg.device_master.lm, eg2.device_master.lm)
