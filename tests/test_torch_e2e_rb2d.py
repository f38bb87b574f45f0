"""End to end: the 25-keyframe 2D range-bearing loop of
tests/test_e2e_rb2d.py through the JAX engine and through the port's
engine (both on the CPU), from bit-identical seeded datasets.

Tolerances: zero noise — ATE < 1e-3 m in both (the JAX test's bound);
noisy — edge poses and landmark states within atol 1e-3 (m / rad) of the
JAX engine's and ATE within 1e-3 m: 25 keyframes of f32 window solves whose
roundings differ between the frameworks (measured ~1e-5); total squared
error within rel 2e-3 (the JAX package's own master-vs-host tolerance).
"""

import numpy as np
import pytest
import torch

import srba_tpu as J
import srba_tpu_torch as T
from srba_tpu.models.noise import NoiseIdentity as JNoise
from srba_tpu.utils import datasets as jds
from srba_tpu_torch.engine.device_master import LazyInfo
from srba_tpu_torch.models.noise import NoiseIdentity as TNoise
from srba_tpu_torch.utils import datasets as tds

torch.set_num_threads(1)

STATE_ATOL, ATE_ATOL = 1e-3, 1e-3


def _datasets(noise, odo):
    wj = jds.make_world_loop_2d(num_kfs=25, radius=6.0, num_landmarks=60,
                                seed=7)
    wt = tds.make_world_loop_2d(num_kfs=25, radius=6.0, num_landmarks=60,
                                seed=7)
    kw = dict(noise_std=noise, sensor_range=5.0, odo_noise_std=odo, seed=7)
    return (wj, jds.observe(wj, "RangeBearing2D", **kw),
            wt, tds.observe(wt, "RangeBearing2D", **kw))


def _run(pkg, noise_cls, ds, **kw):
    eng = pkg.SrbaEngine(
        "RangeBearing2D", noise=noise_cls(0.005),
        params=pkg.SrbaParams(max_tree_depth=3, max_optimize_depth=3), **kw)
    for k, frame in enumerate(ds.frames):
        obs = [pkg.Observation(lm_id=m, z=z) for m, z in frame]
        eng.define_new_keyframe(
            obs, edge_init={k - 1: ds.odometry[k - 1]} if k > 0 else None)
    return eng


@pytest.fixture(scope="module", params=["zero_noise", "noisy"])
def runs(request):
    noise, odo = (0.0, 0.0) if request.param == "zero_noise" \
        else (0.005, 0.03)
    wj, dsj, wt, dst = _datasets(noise, odo)
    return (request.param, wj, dsj, wt, dst, _run(J, JNoise, dsj),
            _run(T, TNoise, dst, device="cpu"))


def test_datasets_bit_identical(runs):
    _, wj, dsj, wt, dst, _, _ = runs
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
    ate_j = jds.ate_rmse(Gj[:, :2], wj.gt_poses[:, :2])
    ate_t = tds.ate_rmse(Gt[:, :2], wt.gt_poses[:, :2])
    if kind == "zero_noise":
        assert ate_j < 1e-3 and ate_t < 1e-3
    assert abs(ate_t - ate_j) < ATE_ATOL
    sj, st = ej.get_rba_state(), et.get_rba_state()
    assert (st.num_kfs, st.num_edges, st.num_lms, st.num_obs) == \
        (sj.num_kfs, sj.num_edges, sj.num_lms, sj.num_obs)
    np.testing.assert_array_equal(st.k2k_from[:st.num_edges],
                                  sj.k2k_from[:sj.num_edges])
    np.testing.assert_array_equal(st.lm_base[:st.num_lms],
                                  sj.lm_base[:sj.num_lms])
    np.testing.assert_allclose(st.k2k_pose[:st.num_edges],
                               sj.k2k_pose[:sj.num_edges], atol=STATE_ATOL)
    np.testing.assert_allclose(st.lm_state[:st.num_lms],
                               sj.lm_state[:sj.num_lms], atol=STATE_ATOL)
    err_j, err_t = ej.eval_overall_squared_error(), \
        et.eval_overall_squared_error()
    if kind == "zero_noise":
        assert err_t < 1e-3
    else:
        assert err_t == pytest.approx(err_j, rel=2e-3)


def test_port_run_is_bitwise_reproducible(runs):
    *_, dst, _, et = runs
    et2 = _run(T, TNoise, dst, device="cpu")
    for a, b in ((et.device_master.pose, et2.device_master.pose),
                 (et.device_master.lm, et2.device_master.lm)):
        assert torch.equal(a, b)


def test_no_local_opt_flag_then_manual_optimize():
    _, _, _, dst = _datasets(0.0, 0.0)
    eng = T.SrbaEngine("RangeBearing2D", device="cpu")
    for k, frame in enumerate(dst.frames[:6]):
        info = eng.define_new_keyframe(
            [T.Observation(lm_id=m, z=z) for m, z in frame],
            run_local_optimization=False,
            edge_init={k - 1: dst.odometry[k - 1]} if k > 0 else None)
        assert info.optimize_results == {}
    out = eng.optimize_local_area(5, 3)
    assert isinstance(out, LazyInfo)
    assert "err_final" in out
    assert out["err_final"] <= out["err_init"] + 1e-12
    assert eng.optimize_local_area(0, 0) == {"skipped": 1.0}


def test_profiler_collects_stages(runs):
    *_, et = runs
    rep = et.profiler.report()
    assert "define_new_keyframe" in rep and "device_step" in rep
