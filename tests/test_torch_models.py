"""Models of the port (RangeBearing2D/3D, Cartesian2D/3D, StereoCamera,
RelativePoses2D/3D, the four landmark types, NoiseIdentity, SensorPoseNone,
SensorPoseSE3, the pseudo-Huber kernel) against the JAX package on the same
seeded inputs.

Tolerances: torch values at atol 1e-5 (f32 sqrt/atan2/trig of the two
frameworks may differ in the last ulps at ranges up to ~10); the ``h``,
residual and retract Jacobians (``*_jvp`` tangents against ``jax.jacfwd``)
at atol 1e-4; the numpy paths (dataset generation, landmark init) run the
same numpy calls as the JAX package's numpy path and must agree bit for
bit.  The stereo camera's tolerances are stated at its section.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srba_tpu.models import landmarks as jlm
from srba_tpu.models import noise as jnoise
from srba_tpu.models import observations as jobs
from srba_tpu.models import sensor_pose as jsp
from srba_tpu.ops import lie as jlie
from srba_tpu.ops import robust as jrobust
from srba_tpu_torch.models import landmarks as tlm
from srba_tpu_torch.models import noise as tnoise
from srba_tpu_torch.models import observations as tobs
from srba_tpu_torch.models import sensor_pose as tsp
from srba_tpu_torch.ops import lie as tlie
from srba_tpu_torch.ops import robust as trobust

torch.set_num_threads(1)

ATOL, JAC_ATOL = 1e-5, 1e-4
J, T = jobs.RangeBearing2D, tobs.RangeBearing2D


def _points(n=128, seed=0):
    return np.random.default_rng(seed).uniform(-6, 6, (n, 2)).astype(
        np.float32)


def _z(n=128, seed=1):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0.2, 6, n), rng.uniform(-np.pi, np.pi, n)],
                    axis=-1).astype(np.float32)


def test_h_matches_jax():
    pts = _points()
    np.testing.assert_allclose(T.h(torch.from_numpy(pts)).numpy(),
                               np.asarray(J.h(jnp.asarray(pts))), atol=ATOL)


def test_residual_matches_jax_including_wrap():
    pred, z = _z(seed=2), _z(seed=3)
    pred[:, 1] += 3.0          # bearing differences beyond +-pi: wrapped
    ref = np.asarray(J.residual(jnp.asarray(pred), jnp.asarray(z)))
    out = T.residual(torch.from_numpy(pred), torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)
    assert np.all(np.abs(out[:, 1]) <= np.pi + 1e-6)


def test_inverse_matches_jax():
    z = _z(seed=4)
    np.testing.assert_allclose(T.inverse(torch.from_numpy(z)).numpy(),
                               np.asarray(J.inverse(jnp.asarray(z))),
                               atol=ATOL)


def test_numpy_paths_bit_identical_and_numpy_out():
    pts, z = _points(seed=5), _z(seed=6)
    h = T.h(pts)
    inv = T.inverse(z)
    assert isinstance(h, np.ndarray) and isinstance(inv, np.ndarray)
    np.testing.assert_array_equal(h, J.h(pts))
    np.testing.assert_array_equal(inv, J.inverse(z))


def test_h_jvp_matches_jax_jacfwd():
    pts = _points(64, seed=7)
    ref = np.asarray(jax.vmap(jax.jacfwd(J.h))(jnp.asarray(pts)))
    val, tan = T.h_jvp(torch.from_numpy(pts), torch.eye(2).expand(64, 2, 2))
    assert torch.equal(val, T.h(torch.from_numpy(pts)))
    np.testing.assert_allclose(tan.numpy(), ref, atol=JAC_ATOL)


def test_observation_chain_jacobian_matches_jax():
    """h(apply(pose, lm)) composed: the tangents the solver chains, with
    respect to the pose and the landmark, against JAX's jacfwd."""
    rng = np.random.default_rng(8)
    pose = np.concatenate([rng.normal(0, 2, (32, 2)),
                           rng.uniform(-3, 3, (32, 1))], -1).astype(
                               np.float32)
    lm = _points(32, seed=9)

    def f(p, l):
        return J.h(jlie.SE2.apply(p, l))

    ref_p = np.asarray(jax.vmap(jax.jacfwd(f, 0))(pose, lm))
    ref_l = np.asarray(jax.vmap(jax.jacfwd(f, 1))(pose, lm))
    basis = torch.eye(5).expand(32, 5, 5)
    pt, dpt = tlie.SE2.apply_jvp(torch.from_numpy(pose), torch.from_numpy(lm),
                                 basis[:, :3], basis[:, 3:])
    _, tan = T.h_jvp(pt, dpt)
    np.testing.assert_allclose(tan[..., :3].numpy(), ref_p, atol=JAC_ATOL)
    np.testing.assert_allclose(tan[..., 3:].numpy(), ref_l, atol=JAC_ATOL)


def test_model_metadata_matches_jax():
    for attr in ("name", "obs_dim", "z_dim", "lm_dim", "has_inverse_model",
                 "is_pose_landmark"):
        assert getattr(T, attr) == getattr(J, attr), attr
    assert T.pose_group.name == J.pose_group.name
    for attr in ("name", "dim", "dof", "is_pose"):
        assert getattr(tlm.Euclidean2D, attr) == getattr(jlm.Euclidean2D,
                                                         attr)


def test_landmark_retract_matches_jax():
    p, d = _points(seed=10), 0.01 * _points(seed=11)
    np.testing.assert_array_equal(
        tlm.Euclidean2D.retract(torch.from_numpy(p), torch.from_numpy(d))
        .numpy(), np.asarray(jlm.Euclidean2D.retract(p, d)))


def test_noise_and_sensor_pose_match_jax():
    np.testing.assert_array_equal(tnoise.NoiseIdentity(0.005).whitener(2),
                                  jnoise.NoiseIdentity(0.005).whitener(2))
    np.testing.assert_array_equal(
        np.asarray(tsp.SensorPoseNone().pose_for(tlie.SE2)),
        np.asarray(jsp.SensorPoseNone().pose_for(jlie.SE2)))


@pytest.mark.parametrize("fn", ["pseudo_huber_weight", "pseudo_huber_cost"])
def test_robust_kernel_matches_jax(fn):
    sq = np.random.default_rng(12).exponential(10.0, 256).astype(np.float32)
    out = getattr(trobust, fn)(torch.from_numpy(sq), 3.0).numpy()
    ref = np.asarray(getattr(jrobust, fn)(jnp.asarray(sq), 3.0))
    # XLA may turn the division by b^2 into a multiply by its reciprocal,
    # and sqrt(1 + s/b^2) - 1 cancels: a few f32 ulps of the operands.
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


# -- RangeBearing3D, Cartesian2D/3D, RelativePoses2D/3D ----------------------

POINT_MODELS = ["RangeBearing3D", "Cartesian2D", "Cartesian3D"]
POSE_MODELS = ["RelativePoses2D", "RelativePoses3D"]


def _points3(n=128, seed=40):
    return np.random.default_rng(seed).uniform(-6, 6, (n, 3)).astype(
        np.float32)


def _z_rb3d(n=128, seed=41):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0.2, 6, n), rng.uniform(-np.pi, np.pi, n),
                     rng.uniform(-1.5, 1.5, n)], axis=-1).astype(np.float32)


def _model_inputs(name, seed):
    """(sensor-frame input, a measurement) for a model, seeded."""
    if name == "RangeBearing3D":
        return _points3(seed=seed), _z_rb3d(seed=seed + 1)
    if name == "Cartesian2D":
        return _points(seed=seed), _points(seed=seed + 1)
    if name == "Cartesian3D":
        return _points3(seed=seed), _points3(seed=seed + 1)
    if name == "RelativePoses2D":
        rng = np.random.default_rng(seed)
        p = np.concatenate([rng.normal(0, 2, (128, 2)),
                            rng.uniform(-3, 3, (128, 1))], -1)
        return (p.astype(np.float32),
                (p + rng.normal(0, 0.1, p.shape)).astype(np.float32))
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(128, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    p = np.concatenate([rng.normal(0, 2, (128, 3)), q], -1).astype(
        np.float32)
    return p, np.array(jlie.SE3.retract(
        p, rng.normal(0, 0.1, (128, 6)).astype(np.float32)))


@pytest.mark.parametrize("name", POINT_MODELS + POSE_MODELS)
def test_model_metadata_and_values_match_jax(name):
    Jm, Tm = jobs.OBSERVATION_MODELS[name], tobs.OBSERVATION_MODELS[name]
    for attr in ("name", "obs_dim", "z_dim", "lm_dim", "has_inverse_model",
                 "is_pose_landmark"):
        assert getattr(Tm, attr) == getattr(Jm, attr), attr
    assert Tm.pose_group.name == Jm.pose_group.name
    x, z = _model_inputs(name, 42)
    pred = Tm.h(torch.from_numpy(x))
    np.testing.assert_allclose(pred.numpy(), np.asarray(Jm.h(jnp.asarray(x))),
                               atol=ATOL)
    if name == "RangeBearing3D":
        pred = pred + torch.tensor([0.0, 3.0, 3.0])   # both angles wrap
    ref = np.asarray(Jm.residual(jnp.asarray(pred.numpy()), jnp.asarray(z)))
    out = Tm.residual(pred, torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)
    if name == "RangeBearing3D":
        assert np.all(np.abs(out[:, 1:]) <= np.pi + 1e-6)
    np.testing.assert_allclose(Tm.inverse(torch.from_numpy(z)).numpy(),
                               np.asarray(Jm.inverse(jnp.asarray(z))),
                               atol=ATOL)


@pytest.mark.parametrize("name", POINT_MODELS)
def test_point_model_numpy_paths_bit_identical(name):
    Jm, Tm = jobs.OBSERVATION_MODELS[name], tobs.OBSERVATION_MODELS[name]
    x, z = _model_inputs(name, 43)
    h, inv = Tm.h(x), Tm.inverse(z)
    assert isinstance(h, np.ndarray) and isinstance(inv, np.ndarray)
    np.testing.assert_array_equal(h, Jm.h(x))
    np.testing.assert_array_equal(inv, Jm.inverse(z))


@pytest.mark.parametrize("name", POINT_MODELS + POSE_MODELS)
def test_h_and_residual_jvp_match_jax_jacfwd(name):
    """d residual(h(x), z) / dx by the port's ``h_jvp``/``residual_jvp``
    against JAX's jacfwd of the same composition."""
    Jm, Tm = jobs.OBSERVATION_MODELS[name], tobs.OBSERVATION_MODELS[name]
    x, z = _model_inputs(name, 44)
    x, z = x[:64], z[:64]
    ref = np.asarray(jax.vmap(jax.jacfwd(
        lambda a, b: Jm.residual(Jm.h(a), b)))(jnp.asarray(x),
                                              jnp.asarray(z)))
    n = x.shape[1]
    tx = torch.from_numpy(x)
    pred, dpred = Tm.h_jvp(tx, torch.eye(n).expand(64, n, n))
    assert torch.equal(pred, Tm.h(tx))
    r, tan = Tm.residual_jvp(pred, torch.from_numpy(z), dpred)
    assert torch.equal(r, Tm.residual(pred, torch.from_numpy(z)))
    np.testing.assert_allclose(tan.numpy(), ref, atol=JAC_ATOL)


@pytest.mark.parametrize("name", ["RangeBearing3D", "Cartesian3D"])
def test_se3_observation_chain_jacobian_matches_jax(name):
    """h(apply(pose, lm)) on SE(3): the tangents the solver chains, with
    respect to the pose and the landmark, against JAX's jacfwd."""
    Jm, Tm = jobs.OBSERVATION_MODELS[name], tobs.OBSERVATION_MODELS[name]
    _, pose = _model_inputs("RelativePoses3D", 45)
    pose, lm = pose[:32], _points3(32, seed=46)

    def f(p, l):
        return Jm.h(jlie.SE3.apply(p, l))

    ref_p = np.asarray(jax.vmap(jax.jacfwd(f, 0))(pose, lm))
    ref_l = np.asarray(jax.vmap(jax.jacfwd(f, 1))(pose, lm))
    basis = torch.eye(10).expand(32, 10, 10)
    pt, dpt = tlie.SE3.apply_jvp(torch.from_numpy(pose), torch.from_numpy(lm),
                                 basis[:, :7], basis[:, 7:])
    _, tan = Tm.h_jvp(pt, dpt)
    np.testing.assert_allclose(tan[..., :7].numpy(), ref_p, atol=JAC_ATOL)
    np.testing.assert_allclose(tan[..., 7:].numpy(), ref_l, atol=JAC_ATOL)


@pytest.mark.parametrize("name", ["Euclidean2D", "Euclidean3D",
                                  "RelativePoses2D", "RelativePoses3D"])
def test_landmark_types_match_jax(name):
    Jl, Tl = jlm.LANDMARK_TYPES[name], tlm.LANDMARK_TYPES[name]
    for attr in ("name", "dim", "dof", "is_pose"):
        assert getattr(Tl, attr) == getattr(Jl, attr), attr
    rng = np.random.default_rng(47)
    if Tl.is_pose:
        st = _model_inputs(name, 48)[0][:32]
    else:
        st = rng.uniform(-5, 5, (32, Tl.dim)).astype(np.float32)
    d = rng.normal(0, 0.1, (32, Tl.dof)).astype(np.float32)
    out = Tl.retract(torch.from_numpy(st), torch.from_numpy(d))
    np.testing.assert_allclose(out.numpy(), np.asarray(Jl.retract(st, d)),
                               atol=ATOL)
    ref = np.asarray(jax.vmap(jax.jacfwd(Jl.retract, 1))(st, d))
    val, tan = Tl.retract_jvp(torch.from_numpy(st), torch.from_numpy(d),
                              torch.eye(Tl.dof).expand(32, Tl.dof, Tl.dof))
    assert torch.equal(val, out)
    np.testing.assert_allclose(tan.numpy(), ref, atol=JAC_ATOL)
    np.testing.assert_array_equal(
        tlm.identity_state(Tl).numpy(), np.asarray(jlm.identity_state(Jl)))


# -- StereoCamera and SensorPoseSE3 ------------------------------------------
# Stereo pixels reach ~320: values at rtol 1e-6 (a few f32 ulps; an absolute
# 1e-6 is below one ulp there); tangents at atol 1e-4 after dividing by the
# focal length (entries reach fx / zc ~ 2e6 at the depth floor).

JS, TS = jobs.StereoCamera, tobs.StereoCamera


def _stereo_calibs():
    kw = dict(fx=200.0, fy=180.0, cx=160.0, cy=120.0, baseline=0.12)
    return jobs.StereoCalib.make(**kw), tobs.StereoCalib.make(**kw)


def _stereo_points(n=128, seed=60):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                     rng.uniform(0.5, 9.0, n)], axis=-1).astype(np.float32)


def test_stereo_calib_matches_jax():
    jc, tc = _stereo_calibs()
    for f in ("fx", "fy", "cx", "cy", "baseline"):
        assert type(getattr(tc, f)) is np.float32, f
        assert getattr(tc, f) == getattr(jc, f), f
    c = tobs.calib_constants(tc)
    assert all(type(getattr(c, f)) is float and getattr(c, f) == getattr(
        tc, f) for f in ("fx", "fy", "cx", "cy", "baseline"))
    assert tobs.calib_constants(None) is None


def test_stereo_h_and_inverse_match_jax():
    jc, tc = _stereo_calibs()
    pts = _stereo_points()
    z = np.array(JS.h(jnp.asarray(pts), jc))
    out = TS.h(torch.from_numpy(pts), tobs.calib_constants(tc)).numpy()
    np.testing.assert_allclose(out, z, rtol=1e-6)
    inv = TS.inverse(torch.from_numpy(z), tobs.calib_constants(tc)).numpy()
    np.testing.assert_allclose(
        inv, np.asarray(JS.inverse(jnp.asarray(z), jc)), rtol=1e-6,
        atol=1e-6)
    # Host (numpy) paths: the same numpy calls, bit for bit.
    np.testing.assert_array_equal(TS.h(pts, tc), JS.h(pts, jc))
    np.testing.assert_array_equal(TS.inverse(z, tc), JS.inverse(z, jc))
    for attr in ("name", "obs_dim", "z_dim", "lm_dim", "has_inverse_model",
                 "is_pose_landmark"):
        assert getattr(TS, attr) == getattr(JS, attr), attr


def test_stereo_disparity_sign():
    """tests/test_observations.py's check: ul > ur for points ahead, and
    vl == vr (rectified)."""
    _, tc = _stereo_calibs()
    z = TS.h(torch.tensor([[0.5, 0.1, 4.0]]), tobs.calib_constants(tc))
    assert float(z[0, 0]) > float(z[0, 2])
    assert float(z[0, 1]) == float(z[0, 3])


@pytest.mark.parametrize("where", ["random", "depth_floor_tie",
                                   "below_floor"])
def test_stereo_h_jvp_matches_jax_jacfwd(where):
    """Including zc == 1e-4 exactly (the tie of ``max(zc, 1e-4)``, where
    JAX's AD takes the derivative 0.5) and points behind the floor."""
    jc, tc = _stereo_calibs()
    pts = _stereo_points(32, seed=61)
    if where == "depth_floor_tie":
        pts[:, 2] = np.float32(1e-4)
    elif where == "below_floor":
        pts[:, 2] = np.linspace(-1.0, 5e-5, 32, dtype=np.float32)
    ref = np.asarray(jax.vmap(jax.jacfwd(lambda p: JS.h(p, jc)))(
        jnp.asarray(pts)))
    tp = torch.from_numpy(pts)
    val, tan = TS.h_jvp(tp, torch.eye(3).expand(32, 3, 3),
                        tobs.calib_constants(tc))
    assert torch.equal(val, TS.h(tp, tobs.calib_constants(tc)))
    np.testing.assert_allclose(tan.numpy() / 200.0, ref / 200.0,
                               rtol=1e-5, atol=JAC_ATOL)


def test_stereo_chain_jacobian_with_mount_matches_jax():
    """h(apply(mount_inv, apply(pose, lm))): the chain the solver builds
    with a sensor mount, with respect to the pose and the landmark."""
    from srba_tpu.ops.np_lie import CAMERA_SENSOR_POSE_SE3, NpSE3
    jc, tc = _stereo_calibs()
    spinv = NpSE3.inverse(CAMERA_SENSOR_POSE_SE3).astype(np.float32)
    rng = np.random.default_rng(62)
    pose = np.array(jlie.SE3.pexp(rng.normal(0, 0.2, (32, 6)).astype(
        np.float32)))
    # Landmarks ahead of the camera: robot x forward.
    lm = np.stack([rng.uniform(2, 8, 32), rng.uniform(-2, 2, 32),
                   rng.uniform(-1, 1, 32)], -1).astype(np.float32)

    def f(p, l):
        return JS.h(jlie.SE3.apply(spinv, jlie.SE3.apply(p, l)), jc)

    ref_p = np.asarray(jax.vmap(jax.jacfwd(f, 0))(pose, lm))
    ref_l = np.asarray(jax.vmap(jax.jacfwd(f, 1))(pose, lm))
    basis = torch.eye(10).expand(32, 10, 10)
    pt, dpt = tlie.SE3.apply_jvp(torch.from_numpy(pose), torch.from_numpy(lm),
                                 basis[:, :7], basis[:, 7:])
    pt, dpt = tlie.SE3.apply_jvp(torch.from_numpy(spinv), pt, None, dpt)
    _, tan = TS.h_jvp(pt, dpt, tobs.calib_constants(tc))
    np.testing.assert_allclose(tan[..., :7].numpy(), ref_p, rtol=1e-5,
                               atol=JAC_ATOL * 10)
    np.testing.assert_allclose(tan[..., 7:].numpy(), ref_l, rtol=1e-5,
                               atol=JAC_ATOL * 10)


def test_sensor_pose_se3_matches_jax():
    from srba_tpu.ops.np_lie import CAMERA_SENSOR_POSE_SE3
    t = tsp.SensorPoseSE3(CAMERA_SENSOR_POSE_SE3)
    j = jsp.SensorPoseSE3(CAMERA_SENSOR_POSE_SE3)
    assert (t.name, t.is_identity) == (j.name, j.is_identity)
    out = t.pose_for(tlie.SE3)
    assert isinstance(out, np.ndarray) and out.dtype == np.float32
    np.testing.assert_array_equal(out, np.asarray(j.pose_for(jlie.SE3)))
    np.testing.assert_array_equal(
        tsp.SensorPoseSE3([1.0, 2.0, 0.3]).pose_for(tlie.SE2),
        np.asarray(jsp.SensorPoseSE3([1.0, 2.0, 0.3]).pose_for(jlie.SE2)))
    with pytest.raises(ValueError, match="7-vector"):
        tsp.SensorPoseSE3([1.0, 2.0, 0.3]).pose_for(tlie.SE3)
    with pytest.raises(ValueError, match="SE2"):
        t.pose_for(tlie.SE2)


# -- MonocularCamera, RGBDCamera and CameraCalib ------------------------------
# Same rules as the stereo camera above: values at atol 1e-6 and rtol 1e-6
# (pixels reach ~320, where one f32 ulp is 3e-5); tangents at atol 1e-4
# after dividing by the focal length; the numpy paths bit for bit.

CAMERAS = ["MonocularCamera", "RGBDCamera"]


def _camera_calibs():
    kw = dict(fx=200.0, fy=180.0, cx=160.0, cy=120.0)
    return jobs.CameraCalib.make(**kw), tobs.CameraCalib.make(**kw)


def test_camera_calib_matches_jax():
    jc, tc = _camera_calibs()
    for f in ("fx", "fy", "cx", "cy"):
        assert type(getattr(tc, f)) is np.float32, f
        assert getattr(tc, f) == getattr(jc, f), f
    assert tobs.CameraCalib.make() == tobs.CameraCalib(
        fx=np.float32(200.0), fy=np.float32(200.0), cx=np.float32(160.0),
        cy=np.float32(120.0))
    c = tobs.calib_constants(tc)
    assert all(type(getattr(c, f)) is float and getattr(c, f) == getattr(
        tc, f) for f in ("fx", "fy", "cx", "cy"))


@pytest.mark.parametrize("kind", ["camera", "stereo"])
def test_calib_from_jax(kind):
    """``convert.calib_from_jax`` maps either JAX calibration to the port's
    by its fields; ``stereo_calib_from_jax`` is the same function."""
    from srba_tpu_torch import convert
    jc, tc = _camera_calibs() if kind == "camera" else _stereo_calibs()
    out = convert.calib_from_jax(jc)
    assert type(out) is type(tc) and out == tc
    assert convert.stereo_calib_from_jax is convert.calib_from_jax


@pytest.mark.parametrize("name", CAMERAS)
def test_camera_h_and_inverse_match_jax(name):
    Jm, Tm = jobs.OBSERVATION_MODELS[name], tobs.OBSERVATION_MODELS[name]
    for attr in ("name", "obs_dim", "z_dim", "lm_dim", "has_inverse_model",
                 "is_pose_landmark"):
        assert getattr(Tm, attr) == getattr(Jm, attr), attr
    assert Tm.pose_group.name == Jm.pose_group.name
    jc, tc = _camera_calibs()
    pts = _stereo_points(seed=63)
    z = np.array(Jm.h(jnp.asarray(pts), jc))
    out = Tm.h(torch.from_numpy(pts), tobs.calib_constants(tc)).numpy()
    np.testing.assert_allclose(out, z, rtol=1e-6, atol=1e-6)
    inv = Tm.inverse(torch.from_numpy(z), tobs.calib_constants(tc)).numpy()
    np.testing.assert_allclose(
        inv, np.asarray(Jm.inverse(jnp.asarray(z), jc)), rtol=1e-6,
        atol=1e-6)
    # Host (numpy) paths: the same numpy calls, bit for bit.
    np.testing.assert_array_equal(Tm.h(pts, tc), Jm.h(pts, jc))
    np.testing.assert_array_equal(Tm.inverse(z, tc), Jm.inverse(z, jc))
    if name == "RGBDCamera":   # the exact inverse model
        np.testing.assert_allclose(Tm.inverse(Tm.h(pts, tc), tc), pts,
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("depth", [None, 5.5, "per_point"])
def test_monocular_inverse_at_depth_matches_jax(depth):
    """The point along the pixel's ray at the default depth (3 m), a given
    depth, or a depth per pixel."""
    JM, TM = jobs.MonocularCamera, tobs.MonocularCamera
    jc, tc = _camera_calibs()
    z = np.array(JM.h(jnp.asarray(_stereo_points(seed=64)), jc))
    if depth == "per_point":
        depth = np.random.default_rng(65).uniform(1, 9, len(z)).astype(
            np.float32)
    ref = np.asarray(JM.inverse(jnp.asarray(z), jc, depth=depth))
    out = TM.inverse(torch.from_numpy(z), tobs.calib_constants(tc),
                     depth=None if depth is None else (
                         float(depth) if np.isscalar(depth)
                         else torch.from_numpy(depth)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(TM.inverse(z, tc, depth=depth),
                                  JM.inverse(z, jc, depth=depth))
    assert TM.default_depth == JM.default_depth == 3.0


@pytest.mark.parametrize("name", CAMERAS)
@pytest.mark.parametrize("where", ["random", "depth_floor_tie",
                                   "below_floor"])
def test_camera_h_jvp_matches_jax_jacfwd(name, where):
    """Including zc == 1e-4 exactly (the tie of ``max(zc, 1e-4)``, where
    JAX's AD takes the derivative 0.5) and points behind the floor; the
    RGB-D depth output is ``zc`` itself, unfloored."""
    Jm, Tm = jobs.OBSERVATION_MODELS[name], tobs.OBSERVATION_MODELS[name]
    jc, tc = _camera_calibs()
    pts = _stereo_points(32, seed=66)
    if where == "depth_floor_tie":
        pts[:, 2] = np.float32(1e-4)
    elif where == "below_floor":
        pts[:, 2] = np.linspace(-1.0, 5e-5, 32, dtype=np.float32)
    ref = np.asarray(jax.vmap(jax.jacfwd(lambda p: Jm.h(p, jc)))(
        jnp.asarray(pts)))
    tp = torch.from_numpy(pts)
    val, tan = Tm.h_jvp(tp, torch.eye(3).expand(32, 3, 3),
                        tobs.calib_constants(tc))
    assert torch.equal(val, Tm.h(tp, tobs.calib_constants(tc)))
    np.testing.assert_allclose(tan.numpy() / 200.0, ref / 200.0,
                               rtol=1e-5, atol=JAC_ATOL)


@pytest.mark.parametrize("name", CAMERAS)
def test_camera_chain_jacobian_with_mount_matches_jax(name):
    """h(apply(mount_inv, apply(pose, lm))) with respect to the pose and
    the landmark, as the solver chains it."""
    from srba_tpu.ops.np_lie import CAMERA_SENSOR_POSE_SE3, NpSE3
    Jm, Tm = jobs.OBSERVATION_MODELS[name], tobs.OBSERVATION_MODELS[name]
    jc, tc = _camera_calibs()
    spinv = NpSE3.inverse(CAMERA_SENSOR_POSE_SE3).astype(np.float32)
    rng = np.random.default_rng(67)
    pose = np.array(jlie.SE3.pexp(rng.normal(0, 0.2, (32, 6)).astype(
        np.float32)))
    lm = np.stack([rng.uniform(2, 8, 32), rng.uniform(-2, 2, 32),
                   rng.uniform(-1, 1, 32)], -1).astype(np.float32)

    def f(p, l):
        return Jm.h(jlie.SE3.apply(spinv, jlie.SE3.apply(p, l)), jc)

    ref_p = np.asarray(jax.vmap(jax.jacfwd(f, 0))(pose, lm))
    ref_l = np.asarray(jax.vmap(jax.jacfwd(f, 1))(pose, lm))
    basis = torch.eye(10).expand(32, 10, 10)
    pt, dpt = tlie.SE3.apply_jvp(torch.from_numpy(pose), torch.from_numpy(lm),
                                 basis[:, :7], basis[:, 7:])
    pt, dpt = tlie.SE3.apply_jvp(torch.from_numpy(spinv), pt, None, dpt)
    _, tan = Tm.h_jvp(pt, dpt, tobs.calib_constants(tc))
    np.testing.assert_allclose(tan[..., :7].numpy(), ref_p, rtol=1e-5,
                               atol=JAC_ATOL * 10)
    np.testing.assert_allclose(tan[..., 7:].numpy(), ref_l, rtol=1e-5,
                               atol=JAC_ATOL * 10)


def test_every_jax_model_is_registered():
    assert sorted(tobs.OBSERVATION_MODELS) == sorted(jobs.OBSERVATION_MODELS)


# -- NoiseConstantMatrix and the kf2kf pose types ----------------------------

_COVS = {"RangeBearing2D": [[4e-4, 1e-4], [1e-4, 9e-4]],
         "StereoCamera": np.diag([0.09, 0.09, 0.16, 0.16]) + 0.02}


@pytest.mark.parametrize("name", sorted(_COVS))
def test_noise_constant_matrix_whitener_bitwise(name):
    """The whitener is host numpy (inverse, Cholesky, transpose) — the same
    calls as the JAX package's, so bit for bit its value; ``noise_from_jax``
    carries the model across."""
    from srba_tpu_torch import convert
    cov = np.asarray(_COVS[name])
    d = cov.shape[0]
    jn, tn = jnoise.NoiseConstantMatrix(cov), tnoise.NoiseConstantMatrix(cov)
    assert tn.name == jn.name == "constant_matrix"
    np.testing.assert_array_equal(tn.whitener(d), jn.whitener(d))
    assert tn.whitener(d).dtype == np.float32
    w = tn.whitener(d).astype(np.float64)
    np.testing.assert_allclose(w.T @ w, np.linalg.inv(cov), rtol=1e-5)
    np.testing.assert_array_equal(
        convert.noise_from_jax(jn).whitener(d), jn.whitener(d))
    np.testing.assert_array_equal(
        convert.noise_from_jax(jnoise.NoiseIdentity(0.3)).whitener(d),
        jnoise.NoiseIdentity(0.3).whitener(d))
    with pytest.raises(ValueError, match="covariance"):
        tn.whitener(d + 1)


def test_window_with_constant_matrix_noise_matches_jax():
    """A window whitened by a correlated constant covariance, solved by
    both packages: errors at rtol 1e-4, states at atol 1e-4, ``iters``
    exactly (the solver tests' tolerances; ``rel_tol`` 0.3 stops on a
    decisive step)."""
    import dataclasses

    from srba_tpu import Observation as JObservation
    from srba_tpu import SrbaEngine as JEngine
    from srba_tpu import SrbaParams as JParams
    from srba_tpu.solver import lm as jlmsolver
    from srba_tpu.solver.window import build_window
    from srba_tpu.utils.datasets import make_world_loop_2d, observe
    from srba_tpu_torch import convert
    from srba_tpu_torch.solver import lm as tlmsolver

    world = make_world_loop_2d(num_kfs=25, radius=6.0, num_landmarks=60,
                               seed=7)
    ds = observe(world, "RangeBearing2D", noise_std=0.02, sensor_range=5.0,
                 odo_noise_std=0.03, seed=7)
    eng = JEngine("RangeBearing2D",
                  noise=jnoise.NoiseConstantMatrix(_COVS["RangeBearing2D"]),
                  params=JParams(max_tree_depth=3, max_optimize_depth=3),
                  device_master=False)
    for k, frame in enumerate(ds.frames[:10]):
        eng.define_new_keyframe(
            [JObservation(lm_id=m, z=z) for m, z in frame],
            run_local_optimization=False,
            edge_init={k - 1: ds.odometry[k - 1]} if k else None)
    arrays, _ = build_window(eng.state, eng.graph, 9, 3, 3)
    np.testing.assert_array_equal(
        eng._whitener,
        tnoise.NoiseConstantMatrix(_COVS["RangeBearing2D"]).whitener(2))
    cfg = dataclasses.replace(eng._solver_cfg, rel_tol=0.3)
    jb = jlmsolver.WindowBatch(
        edge_pose=jnp.asarray(arrays.edge_pose),
        edge_opt=jnp.asarray(arrays.edge_opt),
        lm_state=jnp.asarray(arrays.lm_state),
        lm_opt=jnp.asarray(arrays.lm_opt), obs_z=jnp.asarray(arrays.obs_z),
        obs_lm=jnp.asarray(arrays.obs_lm),
        path_edge=jnp.asarray(arrays.path_edge),
        path_sign=jnp.asarray(arrays.path_sign),
        obs_valid=jnp.asarray(arrays.obs_valid),
        whitener=jnp.asarray(eng._whitener),
        sensor_pose_inv=jnp.asarray(eng._sensor_pose_inv),
        edge_prior=jnp.asarray(arrays.edge_prior),
        edge_prior_w=jnp.asarray(arrays.edge_prior_w))
    js, _ = jlmsolver.make_lm_solver(cfg)
    je, jl, ji = js(jb)
    ts, _ = tlmsolver.make_lm_solver(convert.solver_config_from_jax(cfg),
                                     device="cpu")
    te, tl, ti = ts(convert.window_batch_from_jax(jb, device="cpu"))
    for k in ("err_init", "err_final"):
        assert float(ti[k]) == pytest.approx(float(ji[k]), rel=1e-4)
    assert int(ti["iters"]) == int(ji["iters"]) >= 2
    assert float(ti["err_final"]) < float(ti["err_init"])
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)


def test_kf2kf_pose_types():
    from srba_tpu.models import kf2kf_poses as jk
    from srba_tpu_torch import models as tmodels
    from srba_tpu_torch.models import kf2kf_poses as tk
    assert tmodels.KF2KF_POSE_TYPES is tk.KF2KF_POSE_TYPES
    assert sorted(tk.KF2KF_POSE_TYPES) == sorted(jk.KF2KF_POSE_TYPES)
    for name, g in tk.KF2KF_POSE_TYPES.items():
        jg = jk.KF2KF_POSE_TYPES[name]
        assert g is tlie.GROUPS[name]
        assert (g.name, g.dim, g.dof, g.point_dim) == \
            (jg.name, jg.dim, jg.dof, jg.point_dim)
    assert tmodels.NoiseConstantMatrix is tnoise.NoiseConstantMatrix
