"""The LM+Schur window solver of the port against the JAX package: the same
``WindowBatch`` (converted with ``srba_tpu_torch.convert``) through both,
with and without edge priors, with an iteration cap and with the robust
kernel.  First the linearization (r and J), then the solve's deltas,
``err_init``, ``err_final``, ``iters``, ``lam`` and ``num_obs``.

Tolerances: r and J at rtol 1e-4 / atol 1e-3 (entries reach ~1e3 after
whitening by 1/0.005 = 200; f32 rounding along a 3-step chain of trig
products, ~3e-5 relative measured); deltas at atol 1e-4 (m / rad); errors at
rtol 1e-4 (f32 sums of ~100 terms in a different order); ``iters``, ``lam``
and ``num_obs`` exactly.  Exact ``iters``/``lam`` need every accept/reject
and stop decision to be far from a tie.  On this window the relative
improvements per LM step are 0.78, 0.96, 0.91, 0.19, then f32 noise (0.77,
0.93, 0.47, 0.016 with priors; 0.76, 0.83, 0.76, 0.18 robust), so the
uncapped solves use ``rel_tol=0.3``: the loop stops on the 4th step, far
from a tie.  At the default 1e-6 it stops on a step whose improvement is
summation noise, which the two frameworks round differently.

The same comparisons run on an SE(3) RangeBearing3D window with edge priors
(the engine's prior weights; improvements 0.988, 0.871, 0.0092, then f32
noise, so ``rel_tol=0.05`` stops on the 3rd step) and on a graph-SLAM
RelativePoses2D window whose paths cross closure edges (pose landmarks
fixed, priors of weight 0 as the engine builds them; improvements 0.863,
7.6e-5, then noise, so ``rel_tol=1e-3`` stops on the 2nd step), with the
tolerances above, and on config #3's kind of window: StereoCamera with its
calibration and the camera mounted on the robot (``SensorPoseSE3``), pixel
noise 0.3 (improvements 0.707, 0.925, 0.906, 0.130, 1.5e-4, then noise, so
``rel_tol=0.05`` stops on the 5th step).  Its r and J hold at atol 1e-4
(rtol 1e-5: Jacobian entries reach ~fx / depth / 0.3 ~ 300); its solved
state at atol 1e-3 and its errors at rtol 1e-3, because one LM step from
the odometry seed (total squared error 45,208) leaves the far landmarks
(depth up to 8 m, disparity ~3 px) ~4e-4 m apart between the frameworks,
a gap that later steps close to ~3e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srba_tpu import Observation as JObservation
from srba_tpu import SrbaEngine as JEngine
from srba_tpu import SrbaParams as JParams
from srba_tpu.solver import lm as jlm
from srba_tpu.solver.window import build_window
from srba_tpu.utils.datasets import (make_graph_slam_dataset,
                                     make_world_loop_2d, make_world_loop_3d,
                                     observe)
from srba_tpu_torch import convert
from srba_tpu_torch.solver import lm as tlm

torch.set_num_threads(1)

DELTA_ATOL, ERR_RTOL = 1e-4, 1e-4
R_RTOL, R_ATOL = 1e-4, 1e-3
STEREO_R_RTOL, STEREO_R_ATOL = 1e-5, 1e-4
STEREO_STATE_ATOL, STEREO_ERR_RTOL = 1e-3, 1e-3


@pytest.fixture(scope="module")
def window():
    """A depth-3 window of a 10-KF range-bearing map whose edges still hold
    their noisy odometry seeds (nothing optimized yet)."""
    world = make_world_loop_2d(num_kfs=25, radius=6.0, num_landmarks=60,
                               seed=7)
    ds = observe(world, "RangeBearing2D", noise_std=0.005, sensor_range=5.0,
                 odo_noise_std=0.03, seed=7)
    from srba_tpu.models.noise import NoiseIdentity
    eng = JEngine("RangeBearing2D", noise=NoiseIdentity(0.005),
                  params=JParams(max_tree_depth=3, max_optimize_depth=3),
                  device_master=False)
    for k, frame in enumerate(ds.frames[:10]):
        eng.define_new_keyframe(
            [JObservation(lm_id=m, z=z) for m, z in frame],
            run_local_optimization=False,
            edge_init={k - 1: ds.odometry[k - 1]} if k else None)
    arrays, _ = build_window(eng.state, eng.graph, 9, 3, 3)
    return eng._solver_cfg, arrays, eng._whitener


@pytest.fixture(scope="module", params=["RangeBearing3D", "RelativePoses2D",
                                        "StereoCamera"])
def wide_window(request):
    """A depth-3 window of a 10-KF SE(3) range-bearing or mounted-stereo
    map, or of a 24-KF graph-SLAM map with closure edges, whose edges still
    hold their odometry / measurement seeds."""
    from srba_tpu.models.noise import NoiseIdentity
    from srba_tpu.models.observations import StereoCalib
    from srba_tpu.models.sensor_pose import SensorPoseSE3
    from srba_tpu.ops.np_lie import CAMERA_SENSOR_POSE_SE3
    model = request.param
    kw = {}
    if model == "StereoCamera":
        calib = StereoCalib.make(fx=200.0, fy=200.0, cx=160.0, cy=120.0,
                                 baseline=0.12)
        world = make_world_loop_3d(num_kfs=20, radius=6.0, num_landmarks=150,
                                   height_amp=0.5, seed=8)
        ds = observe(world, model, calib=calib, noise_std=0.3,
                     sensor_range=8.0, odo_noise_std=0.02, seed=8)
        nk, noise, rel_tol = 10, 0.3, 0.05
        kw = dict(calib=calib,
                  sensor_pose=SensorPoseSE3(CAMERA_SENSOR_POSE_SE3))
    elif model == "RangeBearing3D":
        world = make_world_loop_3d(num_kfs=20, radius=6.0, num_landmarks=80,
                                   seed=2)
        ds = observe(world, model, noise_std=0.005, sensor_range=5.0,
                     odo_noise_std=0.02, seed=2)
        nk, noise, rel_tol = 10, 0.005, 0.05
    else:
        world = make_world_loop_2d(num_kfs=30, radius=3.0, num_landmarks=1,
                                   seed=5, revolutions=2.0)
        ds = make_graph_slam_dataset(world, noise_std=0.002,
                                     loop_closure_range=1.5,
                                     odo_noise_std=0.01, seed=5)
        nk, noise, rel_tol = 24, 0.002, 1e-3
    eng = JEngine(model, noise=NoiseIdentity(noise),
                  params=JParams(max_tree_depth=3, max_optimize_depth=3),
                  device_master=False, **kw)
    for k, frame in enumerate(ds.frames[:nk]):
        eng.define_new_keyframe(
            [JObservation(lm_id=m, z=z) for m, z in frame],
            run_local_optimization=False,
            edge_init={k - 1: ds.odometry[k - 1]} if k else None)
    arrays, _ = build_window(eng.state, eng.graph, nk - 1, 3, 3)
    cfg = dataclasses.replace(eng._solver_cfg, rel_tol=rel_tol)
    assert cfg.use_sensor_pose == (model == "StereoCamera")
    return cfg, arrays, eng._whitener, eng._sensor_pose_inv, eng.calib


def _jax_batch(arrays, whitener, prior_scale=None, iters_cap=None,
               sensor_pose_inv=None, calib=None):
    return jlm.WindowBatch(
        edge_pose=jnp.asarray(arrays.edge_pose),
        edge_opt=jnp.asarray(arrays.edge_opt),
        lm_state=jnp.asarray(arrays.lm_state),
        lm_opt=jnp.asarray(arrays.lm_opt),
        obs_z=jnp.asarray(arrays.obs_z), obs_lm=jnp.asarray(arrays.obs_lm),
        path_edge=jnp.asarray(arrays.path_edge),
        path_sign=jnp.asarray(arrays.path_sign),
        obs_valid=jnp.asarray(arrays.obs_valid),
        whitener=jnp.asarray(whitener),
        sensor_pose_inv=(jnp.zeros(3, jnp.float32) if sensor_pose_inv is None
                         else jnp.asarray(sensor_pose_inv)),
        edge_prior=(None if prior_scale is None
                    else jnp.asarray(arrays.edge_prior)),
        edge_prior_w=(None if prior_scale is None
                      else jnp.asarray(arrays.edge_prior_w * prior_scale)),
        iters_cap=(None if iters_cap is None
                   else jnp.asarray(iters_cap, jnp.int32)),
        calib=calib)


def test_linearization_matches_jax(window):
    """r and J of every observation (padded rows included) and of the edge
    priors, against the JAX package's vmap(jacfwd) of the same residual."""
    cfg, arrays, W = window
    jb = _jax_batch(arrays, W, prior_scale=1.0)
    per_obs, eps_dim = jlm._make_per_obs_residual(cfg)
    eps0 = jnp.zeros((eps_dim,), jnp.float32)

    def f(eps, z, li, pe, ps):
        return per_obs(eps, jb.edge_pose, jb.lm_state, z, li, pe, ps,
                       jb.whitener, jb.sensor_pose_inv, None)

    args = (jb.obs_z, jb.obs_lm, jb.path_edge, jb.path_sign)
    r_ref = np.asarray(jax.vmap(lambda *a: f(eps0, *a))(*args))
    J_ref = np.asarray(jax.vmap(lambda *a: jax.jacfwd(f)(eps0, *a))(*args))

    tb = convert.window_batch_from_jax(jb, device="cpu")
    linearize, prior_linearize = tlm.make_linearize(
        convert.solver_config_from_jax(cfg))
    r, J = linearize(tb.edge_pose, tb.lm_state, tb, jac=True)
    np.testing.assert_allclose(r.numpy(), r_ref, rtol=R_RTOL, atol=R_ATOL)
    np.testing.assert_allclose(J.numpy(), J_ref, rtol=R_RTOL, atol=R_ATOL)
    r_only, none = linearize(tb.edge_pose, tb.lm_state, tb, jac=False)
    assert none is None and torch.equal(r_only, r)

    S = jlm.GROUPS["SE2"]

    def per_prior(eps_e, prior, pose):
        return S.plog(S.compose(S.inverse(prior), S.retract(pose, eps_e)))

    z3 = jnp.zeros_like(jb.edge_pose)
    rp_ref = np.asarray(jax.vmap(per_prior)(z3, jb.edge_prior, jb.edge_pose))
    Jp_ref = np.asarray(jax.vmap(jax.jacfwd(per_prior))(
        z3, jb.edge_prior, jb.edge_pose))
    rp, Jp = prior_linearize(tb.edge_pose, tb, jac=True)
    np.testing.assert_allclose(rp.numpy(), rp_ref, atol=1e-5)
    np.testing.assert_allclose(Jp.numpy(), Jp_ref, atol=1e-5)


@pytest.mark.parametrize("case", ["plain", "priors", "priors_cap3",
                                  "robust"])
def test_solve_matches_jax(window, case):
    cfg, arrays, W = window
    prior_scale = None if case in ("plain", "robust") else 100.0
    cap = 3 if case == "priors_cap3" else None
    if cap is None:
        cfg = dataclasses.replace(cfg, rel_tol=0.3)
    if case == "robust":
        cfg = dataclasses.replace(cfg, use_robust_kernel=True,
                                  kernel_param=3.0)
    jb = _jax_batch(arrays, W, prior_scale=prior_scale, iters_cap=cap)
    je, jl, jinfo = jlm.make_lm_solver(cfg)[0](jb)
    te, tl, tinfo = tlm.make_solver_impl(convert.solver_config_from_jax(
        cfg))[0](convert.window_batch_from_jax(jb, device="cpu"))
    e0, l0 = arrays.edge_pose, arrays.lm_state
    np.testing.assert_allclose(te.numpy() - e0, np.asarray(je) - e0,
                               atol=DELTA_ATOL)
    np.testing.assert_allclose(tl.numpy() - l0, np.asarray(jl) - l0,
                               atol=DELTA_ATOL)
    jinfo = {k: float(v) for k, v in jinfo.items()}
    tinfo = {k: float(v) for k, v in tinfo.items()}
    for k in ("err_init", "err_final"):
        assert tinfo[k] == pytest.approx(jinfo[k], rel=ERR_RTOL), k
    for k in ("iters", "lam", "num_obs"):
        assert tinfo[k] == jinfo[k], (k, tinfo, jinfo)
    assert tinfo["err_final"] < tinfo["err_init"]
    assert tinfo["iters"] == (cap if cap is not None else 4)


def test_eval_error_matches_jax(window):
    cfg, arrays, W = window
    jb = _jax_batch(arrays, W, prior_scale=1.0)
    ref = float(jlm.make_lm_solver(cfg)[1](jb))
    out = float(tlm.make_solver_impl(convert.solver_config_from_jax(cfg))[1](
        convert.window_batch_from_jax(jb, device="cpu")))
    assert out == pytest.approx(ref, rel=ERR_RTOL)


def test_non_spd_system_rejects_the_step(window):
    """A NaN-producing (non-SPD) reduced system must make the LM loop
    reject, as JAX's cho_factor NaN does — never raise, never move."""
    cfg, arrays, W = window
    tcfg = dataclasses.replace(convert.solver_config_from_jax(cfg),
                               diag_floor=-1e12, max_iters=2)
    tb = convert.window_batch_from_jax(_jax_batch(arrays, W), device="cpu")
    e, l, info = tlm.make_solver_impl(tcfg)[0](tb)
    assert torch.equal(e, tb.edge_pose) and torch.equal(l, tb.lm_state)
    assert float(info["err_final"]) == float(info["err_init"])
    assert float(info["lam"]) == pytest.approx(tcfg.lam0 * 100, rel=1e-6)


def test_make_lm_solver_moves_batch_to_its_device(window):
    cfg, arrays, W = window
    jb = _jax_batch(arrays, W)
    solve, _ = tlm.make_lm_solver(convert.solver_config_from_jax(cfg),
                                  device="cpu")
    e, _, info = solve(convert.window_batch_from_jax(jb, device="cpu"))
    assert e.device.type == "cpu" and info["iters"].dtype == torch.int32


def test_linearization_matches_jax_se3_and_graph_slam(wide_window):
    """r and J of every observation and of the edge priors on the wide
    windows, against the JAX package's vmap(jacfwd)."""
    cfg, arrays, W, spinv, calib = wide_window
    jb = _jax_batch(arrays, W, prior_scale=1.0, sensor_pose_inv=spinv,
                    calib=calib)
    per_obs, eps_dim = jlm._make_per_obs_residual(cfg)
    eps0 = jnp.zeros((eps_dim,), jnp.float32)

    def f(eps, z, li, pe, ps):
        return per_obs(eps, jb.edge_pose, jb.lm_state, z, li, pe, ps,
                       jb.whitener, jb.sensor_pose_inv, jb.calib)

    args = (jb.obs_z, jb.obs_lm, jb.path_edge, jb.path_sign)
    r_ref = np.asarray(jax.vmap(lambda *a: f(eps0, *a))(*args))
    J_ref = np.asarray(jax.vmap(lambda *a: jax.jacfwd(f)(eps0, *a))(*args))
    tb = convert.window_batch_from_jax(jb, device="cpu")
    linearize, prior_linearize = tlm.make_linearize(
        convert.solver_config_from_jax(cfg))
    r, J = linearize(tb.edge_pose, tb.lm_state, tb, jac=True)
    assert J.shape == J_ref.shape
    rtol, atol = ((STEREO_R_RTOL, STEREO_R_ATOL)
                  if cfg.obs_model == "StereoCamera" else (R_RTOL, R_ATOL))
    np.testing.assert_allclose(r.numpy(), r_ref, rtol=rtol, atol=atol)
    np.testing.assert_allclose(J.numpy(), J_ref, rtol=rtol, atol=atol)
    r_only, _ = linearize(tb.edge_pose, tb.lm_state, tb, jac=False)
    assert torch.equal(r_only, r)

    S = jlm.GROUPS[cfg.pose_group]

    def per_prior(eps_e, prior, pose):
        return S.plog(S.compose(S.inverse(prior), S.retract(pose, eps_e)))

    z = jnp.zeros((jb.edge_pose.shape[0], S.dof), jnp.float32)
    rp_ref = np.asarray(jax.vmap(per_prior)(z, jb.edge_prior, jb.edge_pose))
    Jp_ref = np.asarray(jax.vmap(jax.jacfwd(per_prior))(
        z, jb.edge_prior, jb.edge_pose))
    rp, Jp = prior_linearize(tb.edge_pose, tb, jac=True)
    np.testing.assert_allclose(rp.numpy(), rp_ref, atol=1e-5)
    np.testing.assert_allclose(Jp.numpy(), Jp_ref, atol=1e-5)


@pytest.mark.parametrize("cap", [None, 1])
def test_solve_matches_jax_se3_and_graph_slam(wide_window, cap):
    cfg, arrays, W, spinv, calib = wide_window
    jb = _jax_batch(arrays, W, prior_scale=1.0, iters_cap=cap,
                    sensor_pose_inv=spinv, calib=calib)
    je, jl, jinfo = jlm.make_lm_solver(cfg)[0](jb)
    te, tl, tinfo = tlm.make_solver_impl(convert.solver_config_from_jax(
        cfg))[0](convert.window_batch_from_jax(jb, device="cpu"))
    stereo = cfg.obs_model == "StereoCamera"
    atol = STEREO_STATE_ATOL if stereo else DELTA_ATOL
    e0, l0 = arrays.edge_pose, arrays.lm_state
    np.testing.assert_allclose(te.numpy() - e0, np.asarray(je) - e0,
                               atol=atol)
    np.testing.assert_allclose(tl.numpy() - l0, np.asarray(jl) - l0,
                               atol=atol)
    jinfo = {k: float(v) for k, v in jinfo.items()}
    tinfo = {k: float(v) for k, v in tinfo.items()}
    for k in ("err_init", "err_final"):
        assert tinfo[k] == pytest.approx(
            jinfo[k], rel=STEREO_ERR_RTOL if stereo else ERR_RTOL), k
    for k in ("iters", "lam", "num_obs"):
        assert tinfo[k] == jinfo[k], (k, tinfo, jinfo)
    assert tinfo["err_final"] < tinfo["err_init"]
    expect = {"RangeBearing3D": 3, "RelativePoses2D": 2,
              "StereoCamera": 5}[cfg.obs_model]
    assert tinfo["iters"] == (cap if cap is not None else expect)
    if cfg.obs_model == "RelativePoses2D":
        # Pose landmarks are fixed (lm_opt = 0): the state never moves.
        assert not arrays.lm_opt.any()
        assert torch.equal(tl, torch.from_numpy(l0))
