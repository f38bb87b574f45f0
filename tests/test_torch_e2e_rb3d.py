"""End to end: the 20-keyframe 3D range-bearing loop of
tests/test_e2e_models.py (``TestRangeBearing3D``) through the JAX engine and
through the port's engine (both on the CPU), from bit-identical seeded
datasets.

Tolerances: zero noise — total squared error < 1e-3 and ATE < 5e-3 m in
both (the JAX test's bounds); noisy — edge poses and landmark states within
atol 1e-3 (m / quaternion units) of the JAX engine's and ATE within 1e-3 m:
20 keyframes of f32 window solves whose roundings differ between the
frameworks (measured ~1e-6); total squared error within rel 2e-3 (the JAX
package's own master-vs-host tolerance).
"""

import numpy as np
import pytest
import torch

import srba_tpu as J
import srba_tpu_torch as T
from srba_tpu.utils import datasets as jds
from srba_tpu_torch.utils import datasets as tds

torch.set_num_threads(1)

STATE_ATOL, ATE_ATOL = 1e-3, 1e-3


def _datasets(noise, odo):
    wj = jds.make_world_loop_3d(num_kfs=20, radius=6.0, num_landmarks=80,
                                seed=2)
    wt = tds.make_world_loop_3d(num_kfs=20, radius=6.0, num_landmarks=80,
                                seed=2)
    kw = dict(noise_std=noise, sensor_range=5.0, odo_noise_std=odo, seed=2)
    return (wj, jds.observe(wj, "RangeBearing3D", **kw),
            wt, tds.observe(wt, "RangeBearing3D", **kw))


def _run(pkg, ds, **kw):
    eng = pkg.SrbaEngine(
        "RangeBearing3D",
        params=pkg.SrbaParams(max_tree_depth=3, max_optimize_depth=3), **kw)
    for k, frame in enumerate(ds.frames):
        obs = [pkg.Observation(lm_id=m, z=z) for m, z in frame]
        eng.define_new_keyframe(
            obs, edge_init={k - 1: ds.odometry[k - 1]} if k > 0 else None)
    return eng


@pytest.fixture(scope="module", params=["zero_noise", "noisy"])
def runs(request):
    noise, odo = (0.0, 0.0) if request.param == "zero_noise" \
        else (0.005, 0.02)
    wj, dsj, wt, dst = _datasets(noise, odo)
    return (request.param, wj, dsj, wt, dst, _run(J, dsj),
            _run(T, dst, device="cpu"))


def test_datasets_bit_identical(runs):
    _, wj, dsj, wt, dst, _, _ = runs
    assert wt.group_name == wj.group_name == "SE3"
    np.testing.assert_array_equal(wj.gt_poses, wt.gt_poses)
    np.testing.assert_array_equal(wj.landmarks, wt.landmarks)
    assert len(dsj.frames) == len(dst.frames)
    for fj, ft in zip(dsj.frames, dst.frames):
        assert [m for m, _ in fj] == [m for m, _ in ft]
        for (_, zj), (_, zt) in zip(fj, ft):
            np.testing.assert_array_equal(zj, zt)
    for oj, ot in zip(dsj.odometry, dst.odometry):
        np.testing.assert_array_equal(oj, ot)


def test_engines_agree(runs):
    kind, wj, _, wt, _, ej, et = runs
    Gj, _ = ej.create_complete_spanning_tree(0)
    Gt, _ = et.create_complete_spanning_tree(0)
    ate_j = jds.ate_rmse(Gj[:, :3], wj.gt_poses[:, :3])
    ate_t = tds.ate_rmse(Gt[:, :3], wt.gt_poses[:, :3])
    err_j, err_t = ej.eval_overall_squared_error(), \
        et.eval_overall_squared_error()
    if kind == "zero_noise":
        assert err_j < 1e-3 and err_t < 1e-3
        assert ate_j < 5e-3 and ate_t < 5e-3
    else:
        assert err_t == pytest.approx(err_j, rel=2e-3)
    assert abs(ate_t - ate_j) < ATE_ATOL
    sj, st = ej.get_rba_state(), et.get_rba_state()
    assert (st.num_kfs, st.num_edges, st.num_lms, st.num_obs) == \
        (sj.num_kfs, sj.num_edges, sj.num_lms, sj.num_obs)
    assert et.lm_type.name == ej.lm_type.name == "Euclidean3D"
    np.testing.assert_array_equal(st.lm_base[:st.num_lms],
                                  sj.lm_base[:sj.num_lms])
    np.testing.assert_allclose(st.k2k_pose[:st.num_edges],
                               sj.k2k_pose[:sj.num_edges], atol=STATE_ATOL)
    np.testing.assert_allclose(st.k2k_prior[:st.num_edges],
                               sj.k2k_prior[:sj.num_edges], atol=STATE_ATOL)
    np.testing.assert_allclose(st.lm_state[:st.num_lms],
                               sj.lm_state[:sj.num_lms], atol=STATE_ATOL)


def test_port_run_is_bitwise_reproducible(runs):
    *_, dst, _, et = runs
    et2 = _run(T, dst, device="cpu")
    for a, b in ((et.device_master.pose, et2.device_master.pose),
                 (et.device_master.prior, et2.device_master.prior),
                 (et.device_master.lm, et2.device_master.lm)):
        assert torch.equal(a, b)


def test_unit_quaternions_in_the_masters(runs):
    """Every live SE(3) edge in the device master keeps a unit quaternion
    (compose normalizes; pad rows never reach a gather)."""
    *_, et = runs
    dm = et.device_master
    q = dm.pose[:dm.num_edges, 3:]
    assert torch.allclose(torch.linalg.vector_norm(q, dim=-1),
                          torch.ones(dm.num_edges), atol=1e-6)
