"""The port's monocular two-view triangulation front-end
(``srba_tpu_torch.engine.triangulate`` and the engine's deferred branch)
against the JAX package's, on the CPU: the twins of
tests/test_triangulate.py, each comparing the two packages' outputs.

Tolerances: the triangulator is host numpy in both packages and reads only
the odometry-composed trajectory (``_G_dr``), so its outputs are bitwise
equal.  The 60-keyframe run materializes the same landmarks (ids, base
keyframes, initial points bitwise) and ends within 1e-2 m of the JAX run's
ATE (the monocular windows have a scale gauge, so their states are not
held at 1e-3; measured 2.5e-5 m apart), with the JAX test's own bounds.
"""

import numpy as np
import pytest
import torch

import srba_tpu as J
import srba_tpu_torch as T
from srba_tpu.engine import triangulate as jtri
from srba_tpu.models.observations import CameraCalib as JCalib
from srba_tpu.models.observations import MonocularCamera as JMono
from srba_tpu.models.sensor_pose import SensorPoseSE3 as JMount
from srba_tpu.ops.np_lie import CAMERA_SENSOR_POSE_SE3, NpSE3
from srba_tpu.utils import datasets as jds
from srba_tpu_torch.engine import triangulate as ttri
from srba_tpu_torch.models.observations import CameraCalib as TCalib
from srba_tpu_torch.models.sensor_pose import SensorPoseSE3 as TMount
from srba_tpu_torch.utils import datasets as tds

torch.set_num_threads(1)

ATE_ATOL = 1e-2


def _assert_same(a, b):
    """Equal results of the two packages: tuples, Nones, floats, arrays."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif a is None or isinstance(a, (int, float)):
        assert a == b
    else:
        np.testing.assert_array_equal(a, b)


# -- TestRayMidpoint's cases ------------------------------------------------

RAYS = {
    "exact_intersection": (np.zeros(3), np.array([1.0, 2.0, 5.0]),
                           np.array([2.0, 0.0, 0.0]),
                           np.array([-1.0, 2.0, 5.0])),
    "skew_rays_midpoint": (np.zeros(3), np.array([0.0, 0.0, 1.0]),
                           np.array([1.0, -1.0, 0.0]),
                           np.array([0.0, 1.0, 1.0])),
    "parallel_rays_rejected": (np.zeros(3), np.array([0.0, 0.0, 1.0]),
                               np.array([1.0, 0, 0]),
                               np.array([0.0, 0.0, 1.0])),
    "behind_camera_rejected": (np.zeros(3), np.array([0.0, 0.0, 3.0]),
                               np.array([1.0, 0.0, 0.0]),
                               np.array([1.0, 0.0, 3.0])),
}
EXPECT = {"exact_intersection": [1.0, 2.0, 5.0],
          "skew_rays_midpoint": [0.5, 0.0, 1.0],
          "parallel_rays_rejected": None, "behind_camera_rejected": None}


@pytest.mark.parametrize("case", list(RAYS))
def test_ray_midpoint_matches_jax(case):
    o1, r1, o2, r2 = RAYS[case]
    out = ttri._ray_midpoint(o1, r1, o2, r2)
    _assert_same(out, jtri._ray_midpoint(o1, r1, o2, r2))
    if EXPECT[case] is None:
        assert out[0] is None
    else:
        np.testing.assert_allclose(out[0], EXPECT[case], atol=1e-9)
    if case == "exact_intersection":
        assert out[1] > np.deg2rad(5)
    if case == "parallel_rays_rejected":
        assert out[1] < 1e-6


# -- TestTriangulatorUnit ---------------------------------------------------

def _engines():
    """A JAX and a port monocular engine with the camera mount."""
    je = J.SrbaEngine("MonocularCamera", calib=JCalib.make(),
                      sensor_pose=JMount(CAMERA_SENSOR_POSE_SE3))
    te = T.SrbaEngine("MonocularCamera", calib=TCalib.make(),
                      sensor_pose=TMount(CAMERA_SENSOR_POSE_SE3),
                      device="cpu")
    return je, te


def _pixel(G, lm_world):
    S = np.asarray(CAMERA_SENSOR_POSE_SE3, np.float64)
    p_cam = NpSE3.apply(NpSE3.inverse(S), NpSE3.apply(NpSE3.inverse(G),
                                                      lm_world))
    return np.asarray(JMono.h(p_cam.astype(np.float32), JCalib.make()))


def test_two_view_recovers_point_as_jax():
    """Ground-truth camera motion and exact pixels: the exact landmark."""
    G0 = NpSE3.identity().astype(np.float64)
    G1 = NpSE3.pexp(np.asarray([0.5, 0.05, 0.0, 0.0, 0.0, 0.05]))
    lm_world = np.array([1.0, 2.5, 0.4])
    hits = []
    for eng, mod in zip(_engines(), (jtri, ttri)):
        eng._G_dr = [G0, G1]
        tri = mod.MonoTriangulator(eng, min_parallax_deg=0.5)
        tri.hold(7, 0, _pixel(G0, lm_world))
        assert tri.try_init(7) is None            # single view: pending
        tri.hold(7, 1, _pixel(G1, lm_world))
        hits.append(tri.try_init(7))
        assert tri.num_pending == 0
    hj, ht = hits
    assert ht[0] == hj[0] == 0 and len(ht[2]) == len(hj[2]) == 2
    np.testing.assert_array_equal(ht[1], hj[1])
    for (kj, zj), (kt, zt) in zip(hj[2], ht[2]):
        assert kj == kt
        np.testing.assert_array_equal(zj, zt)
    np.testing.assert_allclose(ht[1], lm_world, atol=1e-3)


def test_low_parallax_stays_pending_as_jax():
    for eng, mod in zip(_engines(), (jtri, ttri)):
        eng._G_dr = [NpSE3.identity(),
                     NpSE3.pexp(np.asarray([1e-4, 0, 0, 0, 0, 0]))]
        tri = mod.MonoTriangulator(eng, min_parallax_deg=1.0)
        z = np.array([160.0, 120.0])
        tri.hold(3, 0, z)
        tri.hold(3, 1, z)
        assert tri.try_init(3) is None
        assert tri.num_pending == 1


def test_buffer_limits_match_jax():
    assert ttri.MonoTriangulator.MAX_BUFFER == \
        jtri.MonoTriangulator.MAX_BUFFER == 16
    assert ttri.MonoTriangulator.MAX_IDLE_KFS == \
        jtri.MonoTriangulator.MAX_IDLE_KFS == 64


def test_full_buffer_replaces_newest_as_jax():
    """Past MAX_BUFFER sightings the newest entry is replaced (the first
    pins the base frame): a landmark first seen without parallax still
    materializes once the trajectory gives baseline."""
    lm_world = np.array([4.0, 0.3, 0.2])
    n = ttri.MonoTriangulator.MAX_BUFFER + 4
    # Sub-parallax creep for n - 1 keyframes, then a 1 m sideways step.
    G = [NpSE3.pexp(np.asarray([1e-5 * k, 0, 0, 0, 0, 0]))
         for k in range(n - 1)]
    G.append(NpSE3.pexp(np.asarray([0.0, 1.0, 0.0, 0, 0, 0])))
    out = []
    for eng, mod in zip(_engines(), (jtri, ttri)):
        eng._G_dr = G
        tri = mod.MonoTriangulator(eng, min_parallax_deg=1.0)
        hits = []
        for k in range(n):
            tri.hold(5, k, _pixel(G[k], lm_world))
            assert len(tri._pending[5]) == min(k + 1, mod.MonoTriangulator
                                               .MAX_BUFFER)
            hits.append(tri.try_init(5))
        assert all(h is None for h in hits[:-1])
        out.append(hits[-1])
    hj, ht = out
    assert ht[0] == hj[0] == 0
    assert [k for k, _ in ht[2]] == [k for k, _ in hj[2]]
    assert ht[2][-1][0] == n - 1 and len(ht[2]) == 16
    np.testing.assert_array_equal(ht[1], hj[1])
    np.testing.assert_allclose(ht[1], lm_world, atol=1e-3)


def test_idle_pending_landmarks_are_evicted_as_jax():
    """A pending landmark whose newest sighting is more than MAX_IDLE_KFS
    keyframes old is dropped at the next prune (every MAX_IDLE_KFS)."""
    idle = ttri.MonoTriangulator.MAX_IDLE_KFS
    left = []
    for eng, mod in zip(_engines(), (jtri, ttri)):
        tri = mod.MonoTriangulator(eng)
        z = np.array([160.0, 120.0])
        tri.hold(1, 0, z)           # never seen again
        tri.hold(2, 0, z)
        tri.hold(2, 10, z)          # seen again at 10
        seen = []
        for k in range(1, 3 * idle):
            tri.hold(3, k, z)       # a live track
            seen.append(sorted(tri._pending))
        left.append(seen)
    assert left[0] == left[1]
    assert left[1][idle - 1] == [1, 2, 3]        # KF idle: 64 idle, kept
    assert left[1][2 * idle - 1] == [3]          # KF 2*idle: both evicted


# -- TestEngineMonoNoExternalInit ---------------------------------------------

@pytest.fixture(scope="module")
def mono_runs():
    """test_e2e_mono_maps_without_inits's 60-KF run through both engines
    (no init anywhere), recording each landmark's base KF and initial
    point as it materializes."""
    out = []
    for pkg, dsm, calib, mount, kw in (
            (J, jds, JCalib.make(), JMount, {}),
            (T, tds, TCalib.make(), TMount, {"device": "cpu"})):
        world = dsm.make_world_loop_3d(num_kfs=60, radius=6.0,
                                       num_landmarks=150, height_amp=0.3,
                                       seed=9)
        ds = dsm.observe(world, "MonocularCamera", calib=calib,
                         noise_std=0.2, sensor_range=7.0,
                         odo_noise_std=0.005, seed=9)
        eng = pkg.SrbaEngine(
            "MonocularCamera", calib=calib,
            sensor_pose=mount(CAMERA_SENSOR_POSE_SE3),
            params=pkg.SrbaParams(max_tree_depth=4, max_optimize_depth=3,
                                  use_robust_kernel=True), **kw)
        inits = []
        add = eng._add_landmark

        def record(base_kf, st, fixed=False, add=add, inits=inits):
            inits.append((int(base_kf), np.array(st, np.float32)))
            return add(base_kf, st, fixed=fixed)

        eng._add_landmark = record
        nobs = []
        for k, frame in enumerate(ds.frames):
            eng.define_new_keyframe(
                [pkg.Observation(lm_id=m, z=z) for m, z in frame],
                edge_init={k - 1: ds.odometry[k - 1]} if k else None)
            nobs.append(eng.state.num_obs)
        G, _ = eng.create_complete_spanning_tree(0)
        ate = float(jds.ate_rmse(np.asarray(G)[:, :3],
                                 world.gt_poses[:len(G), :3]))
        out.append((eng, inits, nobs, ate))
    return out


def test_e2e_mono_maps_without_inits_as_jax(mono_runs):
    (ej, ij, oj, ate_j), (et, it, ot, ate_t) = mono_runs
    assert et.num_landmarks > 30, et.num_landmarks
    assert ate_t < 0.35 and ate_j < 0.35, (ate_t, ate_j)
    assert abs(ate_t - ate_j) < ATE_ATOL
    assert et._lm_id_map == ej._lm_id_map
    assert len(it) == len(ij) == et.num_landmarks
    for (bj, pj), (bt, pt) in zip(ij, it):
        assert bt == bj
        np.testing.assert_array_equal(pt, pj)
    assert ot == oj                               # observations per KF
    assert et.num_pending_landmarks == ej.num_pending_landmarks > 0
    sj, st = ej.get_rba_state(), et.get_rba_state()
    n = st.num_lms
    np.testing.assert_array_equal(st.lm_base[:n], sj.lm_base[:n])
    np.testing.assert_array_equal(st.obs_lm[:st.num_obs],
                                  sj.obs_lm[:sj.num_obs])
    np.testing.assert_array_equal(st.obs_kf[:st.num_obs],
                                  sj.obs_kf[:sj.num_obs])


def test_disabled_front_end_raises_as_jax():
    for pkg, calib, mount, kw in ((J, JCalib, JMount, {}),
                                  (T, TCalib, TMount, {"device": "cpu"})):
        eng = pkg.SrbaEngine(
            "MonocularCamera", calib=calib.make(),
            sensor_pose=mount(CAMERA_SENSOR_POSE_SE3),
            params=pkg.SrbaParams(mono_min_parallax_deg=None), **kw)
        with pytest.raises(ValueError, match="inverse sensor model"):
            eng.define_new_keyframe(
                [pkg.Observation(lm_id=0, z=np.array([160.0, 120.0]))])
