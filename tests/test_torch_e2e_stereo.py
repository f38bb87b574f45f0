"""End to end: config #3's kind of run (StereoCamera on SE(3), the camera
mounted on the robot through ``SensorPoseSE3``) through the JAX engine and
through the port's engine, both on the CPU, from bit-identical seeded
datasets.

First the port's counterparts of tests/test_e2e_models.py's ``TestStereo``
(15 keyframes at zero noise, 40 noisy keyframes), then a small run of
config #3's shape: the local-areas edge policy, a loop that closes through
a bootstrapped closure edge, and the terminal ``optimize_global()``.

Tolerances: zero noise — total squared error < 1e-1 px² and ATE < 1e-2 m
in both (the JAX test's bounds), edge poses and landmark states within atol
1e-3; noisy — the JAX test's ATE < 0.5 m, edge poses within atol 1e-3
(m / quaternion units), ATE within 1e-3 m, total squared error within rel
1e-3, and landmarks compared as what the solver fits, their stereo pixels in
their base keyframe, within atol 3e-2 px (a tenth of the 0.3 px noise):
far landmarks seen twice are poorly constrained (a disparity of ~2.5 px at
9.5 m), and the two frameworks' f32 roundings leave them up to ~6e-3 m
apart, ~1.7e-2 px (measured).

The closure runs (30 keyframes of ``TestStereo``'s world, areas of 5
keyframes, one closure edge (27, 0) back to the first area): with exact
data, the same edge list, states within atol 1e-3, and after
``optimize_global()`` the same ``converged`` and nodes within atol 1e-3.
With noise (0.3 px, odometry 0.02) the same edge list and closure count;
the states are not held at 1e-3: the windows have nearly flat directions
along which the two frameworks' f32 roundings move the state apart (a
step's final errors agree while its states do not; ``chip_smoke.py``'s
``lockstep_steps`` shows the same between the card and the CPU).  Its
global PGO is compared on one problem instead, the JAX
engine's export solved by both packages: the same ``converged`` and
``iters`` and nodes within atol 1e-3, and each engine's own
``optimize_global()`` certified with ATE < 0.1 m.
"""

import copy

import numpy as np
import pytest
import torch

import srba_tpu as J
import srba_tpu_torch as T
from srba_tpu.models.observations import StereoCalib as JCalib
from srba_tpu.models.sensor_pose import SensorPoseSE3 as JMount
from srba_tpu.ops.np_lie import CAMERA_SENSOR_POSE_SE3 as J_MOUNT
from srba_tpu.utils import datasets as jds
from srba_tpu_torch.models.observations import StereoCalib as TCalib
from srba_tpu_torch.models.sensor_pose import SensorPoseSE3 as TMount
from srba_tpu_torch.ops.np_lie import CAMERA_SENSOR_POSE_SE3 as T_MOUNT
from srba_tpu_torch.utils import datasets as tds

torch.set_num_threads(1)

STATE_ATOL, ATE_ATOL, ERR_RTOL, PIXEL_ATOL = 1e-3, 1e-3, 1e-3, 3e-2
CALIB = dict(fx=200.0, fy=200.0, cx=160.0, cy=120.0, baseline=0.12)


def _datasets(n, num_landmarks, noise, odo):
    """``TestStereo._make``'s world and observations in both packages."""
    out = []
    for dsm, calib in ((jds, JCalib.make(**CALIB)),
                       (tds, TCalib.make(**CALIB))):
        world = dsm.make_world_loop_3d(num_kfs=n, radius=6.0,
                                       num_landmarks=num_landmarks,
                                       height_amp=0.5, seed=8)
        out += [world, dsm.observe(world, "StereoCamera", calib=calib,
                                   noise_std=noise, sensor_range=8.0,
                                   odo_noise_std=odo, seed=8)]
    return out


def _engine(pkg, ecp=None, noise=None, **params):
    jax = pkg is J
    kw = {} if jax else {"device": "cpu"}
    if ecp is not None:
        kw["ecp"] = ecp
    if noise is not None:
        kw["noise"] = noise
    return pkg.SrbaEngine(
        "StereoCamera",
        calib=(JCalib if jax else TCalib).make(**CALIB),
        sensor_pose=(JMount(J_MOUNT) if jax else TMount(T_MOUNT)),
        params=pkg.SrbaParams(**params), **kw)


def _drive(eng, pkg, ds):
    for k, frame in enumerate(ds.frames):
        eng.define_new_keyframe(
            [pkg.Observation(lm_id=m, z=z) for m, z in frame],
            edge_init={k - 1: ds.odometry[k - 1]} if k else None)
    return eng


def _ate(eng, world):
    G, _ = eng.create_complete_spanning_tree(0)
    return float(jds.ate_rmse(np.asarray(G)[:, :3], world.gt_poses[:, :3]))


@pytest.fixture(scope="module", params=["zero_noise", "noisy"])
def runs(request):
    """Both engines over ``TestStereo``'s data (depth 3 / 3)."""
    if request.param == "zero_noise":
        data = _datasets(15, 150, 0.0, 0.0)
    else:
        data = _datasets(40, 400, 0.3, 0.02)
    wj, dsj, wt, dst = data
    ej = _drive(_engine(J, max_tree_depth=3, max_optimize_depth=3), J, dsj)
    et = _drive(_engine(T, max_tree_depth=3, max_optimize_depth=3), T, dst)
    return request.param, wj, dsj, wt, dst, ej, et


def test_datasets_bit_identical(runs):
    _, wj, dsj, wt, dst, _, _ = runs
    np.testing.assert_array_equal(wj.gt_poses, wt.gt_poses)
    np.testing.assert_array_equal(wj.landmarks, wt.landmarks)
    assert len(dsj.frames) == len(dst.frames)
    assert sum(len(f) for f in dst.frames) > 30
    for fj, ft in zip(dsj.frames, dst.frames):
        assert [m for m, _ in fj] == [m for m, _ in ft]
        for (_, zj), (_, zt) in zip(fj, ft):
            np.testing.assert_array_equal(zj, zt)
    for oj, ot in zip(dsj.odometry, dst.odometry):
        np.testing.assert_array_equal(oj, ot)


def _base_pixels(eng, st):
    """Each landmark's stereo pixels (ul, vl, ur) in its base keyframe:
    the mount's inverse, then ``h``."""
    g = eng.np_group
    lm = st.lm_state[:st.num_lms].astype(np.float64)
    s = g.apply(g.inverse(eng._sensor_pose.astype(np.float64)), lm)
    return np.asarray(eng.model.h(s, eng._calib_np))[:, :3]


def test_engines_agree(runs):
    kind, wj, _, wt, _, ej, et = runs
    ate_j, ate_t = _ate(ej, wj), _ate(et, wt)
    err_j = ej.eval_overall_squared_error()
    err_t = et.eval_overall_squared_error()
    sj, st = ej.get_rba_state(), et.get_rba_state()
    assert (st.num_kfs, st.num_edges, st.num_lms, st.num_obs) == \
        (sj.num_kfs, sj.num_edges, sj.num_lms, sj.num_obs)
    np.testing.assert_array_equal(st.lm_base[:st.num_lms],
                                  sj.lm_base[:sj.num_lms])
    np.testing.assert_allclose(st.k2k_pose[:st.num_edges],
                               sj.k2k_pose[:sj.num_edges], atol=STATE_ATOL)
    assert abs(ate_t - ate_j) < ATE_ATOL
    if kind == "zero_noise":
        assert err_j < 1e-1 and err_t < 1e-1
        assert ate_j < 1e-2 and ate_t < 1e-2
        np.testing.assert_allclose(st.lm_state[:st.num_lms],
                                   sj.lm_state[:sj.num_lms], atol=STATE_ATOL)
    else:
        assert ate_j < 0.5 and ate_t < 0.5
        assert err_t == pytest.approx(err_j, rel=ERR_RTOL)
        np.testing.assert_allclose(_base_pixels(et, st), _base_pixels(ej, sj),
                                   atol=PIXEL_ATOL)


def test_port_run_is_bitwise_reproducible(runs):
    *_, dst, _, et = runs
    et2 = _drive(_engine(T, max_tree_depth=3, max_optimize_depth=3), T, dst)
    for a, b in ((et.device_master.pose, et2.device_master.pose),
                 (et.device_master.prior, et2.device_master.prior),
                 (et.device_master.lm, et2.device_master.lm)):
        assert torch.equal(a, b)


# -- config #3's shape: local areas, a bootstrapped closure, global PGO -------

def _edges(st):
    n = st.num_edges
    return list(zip(st.k2k_from[:n].tolist(), st.k2k_to[:n].tolist()))


@pytest.fixture(scope="module", params=["exact", "noisy"])
def closure_runs(request):
    from srba_tpu.ecps import LocalAreasFixedGrid as JGrid
    from srba_tpu.models.noise import NoiseIdentity as JNoise
    from srba_tpu_torch.ecps import LocalAreasFixedGrid as TGrid
    from srba_tpu_torch.models.noise import NoiseIdentity as TNoise
    noise, odo = (0.0, 0.0) if request.param == "exact" else (0.3, 0.02)
    wj, dsj, wt, dst = _datasets(30, 400, noise, odo)
    params = dict(max_tree_depth=3, max_optimize_depth=3)
    ej = _drive(_engine(J, JGrid(submap_size=5, min_obs_count_loop_closure=5),
                        JNoise(0.3), **params), J, dsj)
    et = _drive(_engine(T, TGrid(submap_size=5, min_obs_count_loop_closure=5),
                        TNoise(0.3), **params), T, dst)
    return request.param, wj, wt, ej, et


def test_closure_run_edges_match_jax(closure_runs):
    kind, wj, wt, ej, et = closure_runs
    sj, st = ej.get_rba_state(), et.get_rba_state()
    assert _edges(st) == _edges(sj)
    closures = [(a, b) for a, b in _edges(st) if b != (a - 1) // 5 * 5
                and b != a // 5 * 5]
    assert closures == [(27, 0)]
    assert et.profiler.counters["closure_ok"] >= 1
    assert (st.num_lms, st.num_obs) == (sj.num_lms, sj.num_obs)
    if kind == "exact":
        np.testing.assert_allclose(st.k2k_pose[:st.num_edges],
                                   sj.k2k_pose[:sj.num_edges],
                                   atol=STATE_ATOL)
        np.testing.assert_allclose(st.lm_state[:st.num_lms],
                                   sj.lm_state[:sj.num_lms], atol=STATE_ATOL)
        assert abs(_ate(et, wt) - _ate(ej, wj)) < ATE_ATOL


def test_closure_run_global_pgo_matches_jax(closure_runs):
    from srba_tpu.io.export import get_global_graphslam_problem
    from srba_tpu.solver.global_graphslam import PGOConfig as JPGO
    from srba_tpu.solver.global_graphslam import \
        optimize_global_pose_graph as jsolve
    from srba_tpu_torch.solver.global_graphslam import PGOConfig as TPGO
    from srba_tpu_torch.solver.global_graphslam import \
        optimize_global_pose_graph as tsolve
    kind, wj, wt, ej, et = closure_runs
    ej.flush_pending_closures()
    # A copy: the export's edges are views of the mirror, which the
    # write-back below overwrites.
    prob = copy.deepcopy(get_global_graphslam_problem(ej))
    Gj, ij = ej.optimize_global()
    Gt, it = et.optimize_global()
    assert ij["converged"] == it["converged"] == 1.0
    for G, w in ((np.asarray(Gj), wj), (Gt, wt)):
        assert jds.ate_rmse(G[:, :3], w.gt_poses[:, :3]) < 0.1
    if kind == "exact":
        np.testing.assert_allclose(Gt, np.asarray(Gj), atol=STATE_ATOL)
        return
    kw = dict(group="SE3", chordal_init=True, robust_delta=0.1)
    Gj, ij = jsolve(prob, JPGO(**kw))
    Gt, it = tsolve(prob, TPGO(**kw), device="cpu")
    assert float(it["converged"]) == float(ij["converged"]) == 1.0
    assert float(it["iters"]) == float(ij["iters"]) >= 1
    np.testing.assert_allclose(Gt, np.asarray(Gj), atol=STATE_ATOL)
