"""The host-window engine mode of the port (``SrbaEngine(device_master=
False)``): the host state is authoritative, each window is uploaded,
solved by ``get_solver``'s solver and written back.  Held against the
port's device-master mode (the twin of tests/test_device_master.py::
TestParity::test_master_matches_host_path) and against the JAX package's
host-window engine on the same data, with the runtime iteration cap,
the closure bootstrap and the monocular front end in both modes.

Tolerances: total squared error rel 2e-3 and ATE rel 1e-2 / abs 1e-4 (the
JAX package's own master-vs-host tolerances: the device-master mode adds
each window's delta into the masters, ``x + (new - x)``, where the host
mode stores ``new``, so the two part by roundings that later windows
carry on); one window step from the same state in both modes: errors rel
1e-5 and states atol 1e-5 (the same solver on the same inputs, the
write-back apart).
"""

import numpy as np
import pytest
import torch

import srba_tpu as J
from srba_tpu.models.noise import NoiseIdentity as JNoise
from srba_tpu.utils import datasets as jds
import srba_tpu_torch as T
from srba_tpu_torch.ecps import LocalAreasVar1
from srba_tpu_torch.models.noise import NoiseIdentity as TNoise
from srba_tpu_torch.models.observations import CameraCalib
from srba_tpu_torch.utils import datasets as tds

torch.set_num_threads(1)

ERR_RTOL, ATE_RTOL, ATE_ATOL = 2e-3, 1e-2, 1e-4


def _data(dsm, num_kfs=25, seed=3):
    world = dsm.make_world_loop_2d(num_kfs=num_kfs, radius=8.0,
                                   num_landmarks=60, seed=seed)
    ds = dsm.observe(world, "RangeBearing2D", noise_std=0.005,
                     sensor_range=6.0, odo_noise_std=0.01, seed=seed)
    return world, ds


def _drive(eng, pkg, ds, run_local=True):
    for k, frame in enumerate(ds.frames):
        eng.define_new_keyframe(
            [pkg.Observation(lm_id=m, z=z) for m, z in frame],
            edge_init={k - 1: ds.odometry[k - 1]} if k > 0 else None,
            run_local_optimization=run_local)
    return eng


def _port(device_master, run_local=True, **kw):
    world, ds = _data(tds)
    eng = T.SrbaEngine(
        "RangeBearing2D",
        params=T.SrbaParams(max_tree_depth=4, max_optimize_depth=4),
        device_master=device_master, device="cpu", **kw)
    return _drive(eng, T, ds, run_local), world


def _ate(eng, world):
    G, _ = eng.create_complete_spanning_tree(0)
    return float(tds.ate_rmse(np.asarray(G)[:, :2], world.gt_poses[:, :2]))


@pytest.fixture(scope="module")
def runs():
    """tests/test_device_master.py's 25-KF run: the port in both modes and
    the JAX package's host-window engine."""
    eng_m, world = _port(True)
    eng_h, _ = _port(False)
    wj, dsj = _data(jds)
    eng_j = _drive(J.SrbaEngine(
        "RangeBearing2D",
        params=J.SrbaParams(max_tree_depth=4, max_optimize_depth=4),
        device_master=False), J, dsj)
    return eng_m, eng_h, eng_j, world


def test_master_matches_host_path(runs):
    eng_m, eng_h, _, world = runs
    assert eng_m.device_master is not None and eng_h.device_master is None
    err_m = eng_m.eval_overall_squared_error()
    err_h = eng_h.eval_overall_squared_error()
    assert err_m == pytest.approx(err_h, rel=ERR_RTOL, abs=1e-6)
    assert _ate(eng_m, world) == pytest.approx(_ate(eng_h, world),
                                               rel=ATE_RTOL, abs=ATE_ATOL)


def test_host_window_matches_jax_host_window(runs):
    _, eng_h, eng_j, world = runs
    st_h, st_j = eng_h.get_rba_state(), eng_j.get_rba_state()
    assert st_h.num_edges == st_j.num_edges
    np.testing.assert_array_equal(st_h.k2k_from[: st_h.num_edges],
                                  st_j.k2k_from[: st_j.num_edges])
    np.testing.assert_array_equal(st_h.k2k_to[: st_h.num_edges],
                                  st_j.k2k_to[: st_j.num_edges])
    assert eng_h.eval_overall_squared_error() == pytest.approx(
        eng_j.eval_overall_squared_error(), rel=ERR_RTOL, abs=1e-6)
    Gj, _ = eng_j.create_complete_spanning_tree(0)
    ate_j = float(jds.ate_rmse(np.asarray(Gj)[:, :2], world.gt_poses[:, :2]))
    assert _ate(eng_h, world) == pytest.approx(ate_j, rel=ATE_RTOL,
                                               abs=ATE_ATOL)


def test_host_mode_profiles_solve_and_write_back(runs):
    _, eng_h, _, _ = runs
    keys = set(eng_h.profiler.stats)
    assert "define_new_keyframe.optimize_local_area.device_solve" in keys
    assert "define_new_keyframe.optimize_local_area.write_back" in keys
    assert not any(k.endswith("device_step") for k in keys)


@pytest.mark.parametrize("cap", [2, 0])
def test_iters_cap_in_both_modes(cap):
    """The same window step from the same (unoptimized) state in both
    modes: the runtime cap bounds the iterations (0 = ``max_iters``) and
    the two modes agree."""
    out = []
    for device_master in (True, False):
        eng, _ = _port(device_master, run_local=False)
        info = eng.optimize_local_area(eng.num_keyframes - 1, 4,
                                       _iters_cap=cap)
        info = {k: float(v) for k, v in dict(info).items()}
        st = eng.get_rba_state()
        out.append((info, st.k2k_pose[: st.num_edges].copy(),
                    st.lm_state[: st.num_lms].copy()))
    (im, em, lm), (ih, eh, lh) = out
    limit = cap or T.SrbaParams().max_iters
    assert im["iters"] == ih["iters"] and 1 <= ih["iters"] <= limit
    if cap:
        assert ih["iters"] == cap
    for k in ("err_init", "err_final"):
        assert im[k] == pytest.approx(ih[k], rel=1e-5)
    assert ih["err_final"] < ih["err_init"]
    np.testing.assert_allclose(em, eh, atol=1e-5)
    np.testing.assert_allclose(lm, lh, atol=1e-5)


def test_host_mode_entry_points():
    eng, _ = _port(False, run_local=False)
    assert eng.device_master is None
    before = eng.state.k2k_pose.copy()
    eng.sync()
    eng.fence()
    np.testing.assert_array_equal(eng.state.k2k_pose, before)
    info = eng.optimize_local_area(eng.num_keyframes - 1)
    assert type(info) is dict and set(info) == {
        "err_init", "err_final", "iters", "lam", "num_obs"}
    assert all(isinstance(v, float) for v in info.values())
    with pytest.raises(ValueError, match="device-master"):
        eng.refine_map()
    skip = T.SrbaEngine("RangeBearing2D", device_master=False, device="cpu")
    skip.define_new_keyframe([T.Observation(lm_id=0, z=[1.0, 0.1])])
    assert skip.optimize_local_area(0, 2) == {"skipped": 1.0}
    # A mesh (here of one gloo rank) takes the host-window mode whatever
    # device_master asks, and solves its windows bitwise as this mode does.
    from tests.test_torch_sharding import one_rank_mesh
    for dm in (True, False):
        m = T.SrbaEngine("RangeBearing2D", device_master=dm,
                         mesh=one_rank_mesh(), device="cpu")
        assert m.device_master is None and m.device == torch.device("cpu")
    m, _ = _port(False, run_local=False, mesh=one_rank_mesh())
    assert m.optimize_local_area(m.num_keyframes - 1) == info
    np.testing.assert_array_equal(m.state.k2k_pose, eng.state.k2k_pose)
    np.testing.assert_array_equal(m.state.lm_state, eng.state.lm_state)


def test_closure_bootstrap_in_both_modes():
    """tests/test_ecps.py's two-revolution loop under the adaptive
    local-areas policy: the same areas, the same edges (closures
    bootstrapped from re-observed landmarks) and the same closure-fit
    outcomes in both modes."""
    world = tds.make_world_loop_2d(num_kfs=80, radius=6.0, num_landmarks=120,
                                   seed=9, revolutions=2.0)
    ds = tds.observe(world, "RangeBearing2D", noise_std=0.003,
                     sensor_range=4.5, odo_noise_std=0.02, seed=9)
    out = []
    for device_master in (True, False):
        eng = _drive(T.SrbaEngine(
            "RangeBearing2D",
            ecp=LocalAreasVar1(min_obs_to_join=3,
                               min_obs_count_loop_closure=4),
            params=T.SrbaParams(max_tree_depth=4, max_optimize_depth=3),
            device_master=device_master, device="cpu"), T, ds)
        st = eng.get_rba_state()
        out.append((eng.ecp.get_state(),
                    list(zip(st.k2k_from[: st.num_edges].tolist(),
                             st.k2k_to[: st.num_edges].tolist())),
                    {k: v for k, v in eng.profiler.counters.items()
                     if k in ("closure_ok", "closure_weak", "closure_reject",
                              "closure_flushed", "closure_n/a")},
                    _ate(eng, world)))
    (areas_m, edges_m, fits_m, ate_m), (areas_h, edges_h, fits_h, ate_h) = out
    assert areas_h == areas_m
    assert edges_h == edges_m and len(edges_h) > 79
    assert fits_h == fits_m and fits_h.get("closure_ok", 0) >= 1
    assert ate_h < 0.5 and ate_h == pytest.approx(ate_m, rel=ATE_RTOL,
                                                  abs=ATE_ATOL)


def test_monocular_front_end_in_both_modes():
    """Deferred two-view triangulation with the camera mounted on the
    robot: the same landmarks materialize (ids, base keyframes, initial
    points — host numpy on the odometry-composed trajectory) in both
    modes, and both maps end at agreeing errors."""
    from srba_tpu_torch.engine.engine import SrbaEngine
    from srba_tpu_torch.models.sensor_pose import SensorPoseSE3
    from srba_tpu_torch.ops.np_lie import CAMERA_SENSOR_POSE_SE3

    world = tds.make_world_loop_3d(num_kfs=12, radius=6.0, num_landmarks=150,
                                   height_amp=0.5, seed=9)
    calib = CameraCalib.make()
    ds = tds.observe(world, "MonocularCamera", calib=calib, noise_std=0.2,
                     sensor_range=8.0, odo_noise_std=0.01, seed=9)
    out = []
    add = SrbaEngine._add_landmark
    for device_master in (True, False):
        seen = []

        def recorder(self, base_kf, st, fixed=False, seen=seen):
            seen.append((int(base_kf), np.array(st, np.float32)))
            return add(self, base_kf, st, fixed=fixed)

        SrbaEngine._add_landmark = recorder
        try:
            eng = _drive(T.SrbaEngine(
                "MonocularCamera", calib=calib, noise=TNoise(0.2),
                sensor_pose=SensorPoseSE3(CAMERA_SENSOR_POSE_SE3),
                params=T.SrbaParams(max_tree_depth=3, max_optimize_depth=3),
                device_master=device_master, device="cpu"), T, ds)
        finally:
            SrbaEngine._add_landmark = add
        out.append((eng, seen))
    (eng_m, seen_m), (eng_h, seen_h) = out
    assert eng_m._lm_id_map == eng_h._lm_id_map and len(seen_h) > 20
    assert all(bm == bh and np.array_equal(pm, ph)
               for (bm, pm), (bh, ph) in zip(seen_m, seen_h))
    assert eng_h.num_pending_landmarks == eng_m.num_pending_landmarks
    err_m = eng_m.eval_overall_squared_error()
    err_h = eng_h.eval_overall_squared_error()
    assert np.isfinite(err_h)
    assert err_h == pytest.approx(err_m, rel=ERR_RTOL)


def test_host_mode_optimize_global_writes_back():
    """``optimize_global`` in the host-window mode rewrites the host edge
    table (no device masters to upload to) and the engine keeps going."""
    eng = T.SrbaEngine("RelativePoses2D", device_master=False, device="cpu")
    world = tds.make_world_loop_2d(num_kfs=30, radius=3.0, num_landmarks=1,
                                   seed=5, revolutions=2.0)
    ds = tds.make_graph_slam_dataset(world, noise_std=0.002,
                                     loop_closure_range=1.5,
                                     odo_noise_std=0.01, seed=5)
    _drive(eng, T, ds)
    err0 = eng.eval_overall_squared_error()
    G, info = eng.optimize_global()
    assert info["converged"] == 1.0
    assert eng.eval_overall_squared_error() <= 1.05 * err0 + 1e-6
    G2, _ = eng.create_complete_spanning_tree(0)
    np.testing.assert_allclose(G2, G, atol=1e-4)
    n = eng.num_keyframes
    eng.define_new_keyframe([T.Observation(lm_id=n - 1, z=ds.odometry[-1])],
                            edge_init={n - 1: ds.odometry[-1]})
    assert np.isfinite(eng.eval_overall_squared_error())
