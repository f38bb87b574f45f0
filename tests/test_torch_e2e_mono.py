"""End to end: the monocular and RGB-D cameras on SE(3) (the camera mounted
on the robot through ``SensorPoseSE3``) through the JAX engine and through
the port's engine, both on the CPU, from bit-identical seeded datasets —
the port's counterparts of tests/test_e2e_models.py's ``TestMonocular`` and
``TestRGBD``.

Tolerances: each run is held to the JAX test's own ATE bound and to the
JAX run's ATE within 1e-2 m (1e-3 m on exact data); the same problem (edges,
landmarks, observations, base keyframes).  On exact data (RGB-D at zero
noise) edge poses and landmark states within atol 1e-3 as well; with noise
the monocular windows carry a scale gauge and near-flat directions along
which the two frameworks' f32 roundings move the state, so their states
are not held at 1e-3.
"""

import numpy as np
import pytest
import torch

import srba_tpu as J
import srba_tpu_torch as T
from srba_tpu.models.observations import CameraCalib as JCalib
from srba_tpu.models.sensor_pose import SensorPoseSE3 as JMount
from srba_tpu.ops.np_lie import CAMERA_SENSOR_POSE_SE3, NpSE3
from srba_tpu.utils import datasets as jds
from srba_tpu_torch.models.observations import CameraCalib as TCalib
from srba_tpu_torch.models.sensor_pose import SensorPoseSE3 as TMount
from srba_tpu_torch.utils import datasets as tds

torch.set_num_threads(1)

STATE_ATOL, EXACT_ATE_ATOL, ATE_ATOL = 1e-3, 1e-3, 1e-2
PARAMS = dict(max_tree_depth=3, max_optimize_depth=3)


def _engine(pkg, model, **params):
    jax = pkg is J
    return pkg.SrbaEngine(
        model, calib=(JCalib if jax else TCalib).make(),
        sensor_pose=(JMount if jax else TMount)(CAMERA_SENSOR_POSE_SE3),
        params=pkg.SrbaParams(**params),
        **({} if jax else {"device": "cpu"}))


def _drive(eng, pkg, ds, lm_init_fn=None):
    for k, frame in enumerate(ds.frames):
        obs = [pkg.Observation(
            lm_id=m, z=z,
            init_rel_pos=None if lm_init_fn is None else lm_init_fn(k, m))
            for m, z in frame]
        eng.define_new_keyframe(
            obs, edge_init={k - 1: ds.odometry[k - 1]} if k else None)
    return eng


def _ate(eng, world):
    G, _ = eng.create_complete_spanning_tree(0)
    return float(jds.ate_rmse(np.asarray(G)[:, :3], world.gt_poses[:, :3]))


def _same_problem(ej, et):
    sj, st = ej.get_rba_state(), et.get_rba_state()
    assert (st.num_kfs, st.num_edges, st.num_lms, st.num_obs) == \
        (sj.num_kfs, sj.num_edges, sj.num_lms, sj.num_obs)
    np.testing.assert_array_equal(st.lm_base[:st.num_lms],
                                  sj.lm_base[:sj.num_lms])
    np.testing.assert_array_equal(st.obs_lm[:st.num_obs],
                                  sj.obs_lm[:sj.num_obs])
    return sj, st


# -- TestRGBD -----------------------------------------------------------------

@pytest.fixture(scope="module", params=["zero_noise", "noisy"])
def rgbd_runs(request):
    """``TestRGBD._make``'s world (15 KFs) through both engines."""
    noise, odo = (0.0, 0.0) if request.param == "zero_noise" else (0.15,
                                                                    0.01)
    out = [request.param]
    for pkg, dsm, calib in ((J, jds, JCalib.make()), (T, tds, TCalib.make())):
        world = dsm.make_world_loop_3d(num_kfs=15, radius=6.0,
                                       num_landmarks=150, height_amp=0.5,
                                       seed=12)
        ds = dsm.observe(world, "RGBDCamera", calib=calib, noise_std=noise,
                         sensor_range=8.0, odo_noise_std=odo, seed=12)
        out += [world, ds, _drive(_engine(pkg, "RGBDCamera", **PARAMS),
                                  pkg, ds)]
    return out


def test_rgbd_datasets_bit_identical(rgbd_runs):
    _, wj, dsj, _, wt, dst, _ = rgbd_runs
    np.testing.assert_array_equal(wj.gt_poses, wt.gt_poses)
    assert sum(len(f) for f in dst.frames) > 30
    for fj, ft in zip(dsj.frames, dst.frames):
        assert [m for m, _ in fj] == [m for m, _ in ft]
        for (_, zj), (_, zt) in zip(fj, ft):
            np.testing.assert_array_equal(zj, zt)
    for oj, ot in zip(dsj.odometry, dst.odometry):
        np.testing.assert_array_equal(oj, ot)


def test_rgbd_engines_agree(rgbd_runs):
    kind, wj, _, ej, wt, _, et = rgbd_runs
    sj, st = _same_problem(ej, et)
    ate_j, ate_t = _ate(ej, wj), _ate(et, wt)
    if kind == "zero_noise":
        assert ate_j < 1e-2 and ate_t < 1e-2, (ate_j, ate_t)
        assert abs(ate_t - ate_j) < EXACT_ATE_ATOL
        np.testing.assert_allclose(st.k2k_pose[:st.num_edges],
                                   sj.k2k_pose[:sj.num_edges],
                                   atol=STATE_ATOL)
        np.testing.assert_allclose(st.lm_state[:st.num_lms],
                                   sj.lm_state[:sj.num_lms], atol=STATE_ATOL)
    else:
        assert ate_j < 0.25 and ate_t < 0.25, (ate_j, ate_t)
        assert abs(ate_t - ate_j) < ATE_ATOL
    assert et.num_pending_landmarks == 0    # the inverse model is exact


# -- TestMonocular ------------------------------------------------------------

def test_monocular_with_provided_inits_matches_jax():
    """``test_with_provided_inits``: perturbed ground-truth inits in the
    observing keyframe's frame, the same random draws in both runs."""
    out = []
    for pkg, dsm, calib in ((J, jds, JCalib.make()), (T, tds, TCalib.make())):
        world = dsm.make_world_loop_3d(num_kfs=12, radius=6.0,
                                       num_landmarks=150, height_amp=0.5,
                                       seed=9)
        ds = dsm.observe(world, "MonocularCamera", calib=calib,
                         noise_std=0.2, sensor_range=8.0, odo_noise_std=0.01,
                         seed=9)
        rng = np.random.default_rng(0)

        def lm_init(k, m, world=world, rng=rng):
            pt = NpSE3.apply(NpSE3.inverse(world.gt_poses[k]),
                             world.landmarks[m])
            return pt + rng.normal(0, 0.1, 3)

        eng = _drive(_engine(pkg, "MonocularCamera", **PARAMS), pkg, ds,
                     lm_init_fn=lm_init)
        out.append((eng, _ate(eng, world)))
    (ej, ate_j), (et, ate_t) = out
    _same_problem(ej, et)
    assert et.num_pending_landmarks == 0
    assert ate_j < 0.5 and ate_t < 0.5, (ate_j, ate_t)
    assert abs(ate_t - ate_j) < ATE_ATOL


def test_monocular_raises_without_init_when_frontend_disabled():
    """``mono_min_parallax_deg=None`` keeps the reference's contract: a new
    monocular landmark without an init is a ``ValueError``, in both."""
    for pkg in (J, T):
        eng = _engine(pkg, "MonocularCamera", mono_min_parallax_deg=None)
        with pytest.raises(ValueError, match="inverse sensor model"):
            eng.define_new_keyframe(
                [pkg.Observation(lm_id=0, z=np.asarray([160.0, 120.0]))])
        assert eng.num_landmarks == 0


def test_monocular_deferred_init_defers_then_materializes():
    """``test_deferred_init_defers_then_materializes`` (identity mount):
    the -1 sentinel while pending, nothing allocated, then both sightings
    replayed at the landmark's materialization, in both packages alike."""
    results = []
    for pkg, calib in ((J, JCalib.make()), (T, TCalib.make())):
        eng = pkg.SrbaEngine("MonocularCamera", calib=calib,
                             **({} if pkg is J else {"device": "cpu"}))
        info = eng.define_new_keyframe(
            [pkg.Observation(lm_id=7, z=np.asarray([160.0, 120.0]))])
        assert eng.num_landmarks == 0 and eng.num_pending_landmarks == 1
        assert eng.state.num_obs == 0
        # The sentinel itself, on a second initless landmark.
        assert eng.add_observation(info.kf_id, 8,
                                   np.asarray([100.0, 90.0])) == -1
        pt_cam1 = np.asarray([-1.0, 0.0, 4.0], np.float32)
        z1 = np.asarray([calib.fx * pt_cam1[0] / pt_cam1[2] + calib.cx,
                         calib.fy * pt_cam1[1] / pt_cam1[2] + calib.cy],
                        np.float32)
        odo = np.zeros(7, np.float32)
        odo[3] = 1.0                        # identity rotation
        odo[0] = -1.0                       # T_new<-old: old origin at -1 x
        eng.define_new_keyframe([pkg.Observation(lm_id=7, z=z1)],
                                edge_init={0: odo})
        assert eng.num_landmarks == 1       # materialized
        assert eng.num_pending_landmarks == 1   # landmark 8 still waits
        assert eng.state.num_obs == 2       # both sightings replayed
        st = eng.get_rba_state()
        results.append((int(st.lm_base[0]), st.obs_kf[:2].tolist(),
                        eng._lm_id_map.copy()))
    assert results[0] == results[1] == (0, [0, 1], {7: 0})
