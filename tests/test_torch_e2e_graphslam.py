"""End to end: the relative-pose graph-SLAM cases of tests/test_e2e_models.py
(``TestGraphSlam``) through the JAX engine and through the port's engine
(both on the CPU), from bit-identical seeded datasets: pose landmarks fixed
at their own base keyframe, a kf2kf edge created for every observed
keyframe beyond the tree depth, no odometry prior.

Tolerances: the JAX test's own bounds on each case (ATE < 1e-2 m at zero
noise; noisy odometry: ATE < half the dead-reckoning ATE); against the JAX
run, edge poses within atol 1e-3 (m / rad or quaternion units), ATE within
1e-3 m and total squared error within rel 2e-3 (f32 window solves whose
roundings differ between the frameworks, measured ~1e-6), and the same
edges (endpoints exactly).
"""

import numpy as np
import pytest
import torch

import srba_tpu as J
import srba_tpu_torch as T
from srba_tpu.utils import datasets as jds
from srba_tpu_torch.ops.np_lie import NpSE2
from srba_tpu_torch.utils import datasets as tds

torch.set_num_threads(1)

STATE_ATOL, ATE_ATOL = 1e-3, 1e-3

# name: (world maker args, dataset args, odometry as edge_init, model)
CASES = {
    "se2_zero_noise": (
        ("2d", dict(num_kfs=20, radius=5.0, num_landmarks=1, seed=3)),
        dict(noise_std=0.0, loop_closure_range=2.5, seed=3), False,
        "RelativePoses2D"),
    "se2_noisy_odometry": (
        ("2d", dict(num_kfs=25, radius=5.0, num_landmarks=1, seed=4)),
        dict(noise_std=0.005, odo_noise_std=0.05, loop_closure_range=3.0,
             seed=4), True, "RelativePoses2D"),
    "se2_closures": (
        ("2d", dict(num_kfs=25, radius=5.0, num_landmarks=1, seed=4)),
        dict(noise_std=0.005, loop_closure_range=3.0, seed=4), True,
        "RelativePoses2D"),
    "se3_zero_noise": (
        ("3d", dict(num_kfs=15, radius=5.0, num_landmarks=1, seed=5)),
        dict(noise_std=0.0, loop_closure_range=2.5, seed=5), False,
        "RelativePoses3D"),
}


def _world(mod, kind, kw):
    return (mod.make_world_loop_2d(**kw) if kind == "2d"
            else mod.make_world_loop_3d(**kw))


def _run(pkg, model, ds, use_init, **kw):
    eng = pkg.SrbaEngine(
        model, params=pkg.SrbaParams(max_tree_depth=3, max_optimize_depth=3),
        **kw)
    for k, frame in enumerate(ds.frames):
        obs = [pkg.Observation(lm_id=m, z=z) for m, z in frame]
        eng.define_new_keyframe(
            obs, edge_init=({k - 1: ds.odometry[k - 1]}
                            if (use_init and k > 0) else None))
    return eng


def _ate(mod, eng, world):
    G, _ = eng.create_complete_spanning_tree(0)
    d = 2 if world.group_name == "SE2" else 3
    return mod.ate_rmse(np.asarray(G)[:, :d], world.gt_poses[:, :d])


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    (kind, wkw), dkw, use_init, model = CASES[request.param]
    wj, wt = _world(jds, kind, wkw), _world(tds, kind, wkw)
    dsj = jds.make_graph_slam_dataset(wj, **dkw)
    dst = tds.make_graph_slam_dataset(wt, **dkw)
    return (request.param, wj, dsj, wt, dst,
            _run(J, model, dsj, use_init),
            _run(T, model, dst, use_init, device="cpu"))


def test_graph_slam_dataset_bit_identical(runs):
    _, wj, dsj, wt, dst, _, _ = runs
    np.testing.assert_array_equal(wj.gt_poses, wt.gt_poses)
    assert dst.obs_model == dsj.obs_model
    assert len(dsj.frames) == len(dst.frames)
    for fj, ft in zip(dsj.frames, dst.frames):
        assert [m for m, _ in fj] == [m for m, _ in ft]
        for (_, zj), (_, zt) in zip(fj, ft):
            assert zt.dtype == zj.dtype
            np.testing.assert_array_equal(zj, zt)
    for oj, ot in zip(dsj.odometry, dst.odometry):
        np.testing.assert_array_equal(oj, ot)


def test_engines_agree(runs):
    name, wj, dsj, wt, _, ej, et = runs
    ate_j, ate_t = _ate(jds, ej, wj), _ate(tds, et, wt)
    if name.endswith("zero_noise"):
        assert ate_j < 1e-2 and ate_t < 1e-2
    if name == "se2_noisy_odometry":
        D = np.zeros((len(dsj.frames), 3), np.float32)
        for k in range(1, len(dsj.frames)):
            D[k] = NpSE2.compose(D[k - 1], NpSE2.inverse(dsj.odometry[k - 1]))
        ate_dr = tds.ate_rmse(D[:, :2], wt.gt_poses[:, :2])
        assert ate_t < 0.5 * ate_dr, (ate_t, ate_dr)
    assert abs(ate_t - ate_j) < ATE_ATOL
    sj, st = ej.get_rba_state(), et.get_rba_state()
    assert (st.num_kfs, st.num_edges, st.num_lms, st.num_obs) == \
        (sj.num_kfs, sj.num_edges, sj.num_lms, sj.num_obs)
    np.testing.assert_array_equal(st.k2k_from[:st.num_edges],
                                  sj.k2k_from[:sj.num_edges])
    np.testing.assert_array_equal(st.k2k_to[:st.num_edges],
                                  sj.k2k_to[:sj.num_edges])
    np.testing.assert_array_equal(st.k2k_prior_w[:st.num_edges],
                                  sj.k2k_prior_w[:sj.num_edges])
    np.testing.assert_allclose(st.k2k_pose[:st.num_edges],
                               sj.k2k_pose[:sj.num_edges], atol=STATE_ATOL)
    err_j, err_t = ej.eval_overall_squared_error(), \
        et.eval_overall_squared_error()
    if name.endswith("zero_noise"):
        assert err_t < 1e-3
    else:
        assert err_t == pytest.approx(err_j, rel=2e-3)


def test_closure_edges_created(runs):
    """Observing a keyframe beyond the tree depth creates a kf2kf edge
    initialized from the measurement: more edges than the chain alone, as
    many as the JAX engine creates."""
    name, _, _, _, dst, ej, et = runs
    st = et.state
    assert st.num_edges == ej.state.num_edges
    if name in ("se2_noisy_odometry", "se2_closures"):
        assert st.num_edges > et.num_keyframes - 1
    # No odometry prior in graph-SLAM mode.
    assert not st.k2k_prior_w[:st.num_edges].any()


def test_pose_landmarks_fixed_at_their_own_base(runs):
    *_, et = runs
    st = et.state
    assert et.lm_type.name == et.model.name and et.lm_type.is_pose
    assert st.lm_fixed[: st.num_lms].all()
    ident = et.np_group.identity()
    for ext, internal in et._lm_id_map.items():
        assert int(st.lm_base[internal]) == ext
        np.testing.assert_array_equal(st.lm_state[internal], ident)


def test_port_run_is_bitwise_reproducible(runs):
    name, *_, dst, _, et = runs
    (_, _), _, use_init, model = CASES[name]
    et2 = _run(T, model, dst, use_init, device="cpu")
    for a, b in ((et.device_master.pose, et2.device_master.pose),
                 (et.device_master.lm, et2.device_master.lm)):
        assert torch.equal(a, b)


def test_observation_of_a_future_keyframe_raises():
    eng = T.SrbaEngine("RelativePoses2D", device="cpu")
    eng.define_new_keyframe([])
    with pytest.raises(ValueError, match="existing keyframes"):
        eng.define_new_keyframe(
            [T.Observation(lm_id=5, z=np.zeros(3, np.float32))],
            edge_init={0: np.zeros(3, np.float32)})
