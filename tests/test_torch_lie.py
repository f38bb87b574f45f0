"""SE(2) and SE(3) operations of the port against the JAX package, on the
same seeded inputs: the torch groups (values and hand-written forward-mode
tangents, the latter against ``jax.jacfwd``) and the host numpy mirrors.

Tolerances: values at atol 1e-5 (f32 trig of angles up to pi; the two
frameworks' sin/cos/atan2/sqrt may differ in the last ulps); Jacobians at
atol 1e-4 (products of those values, and the port takes the derivative of
``wrap_angle`` as exactly 1 where JAX's AD evaluates it in f32).  The SE(3)
tangents are checked at random poses, at the identity, and where an edge
equals its prior (``quat_log`` then sees w == 1 exactly, the tie of its
``clip``).  The numpy mirrors run the same numpy calls and must agree bit
for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srba_tpu.ops import lie as jlie
from srba_tpu.ops import np_lie as jnp_lie
from srba_tpu_torch.ops import lie as tlie
from srba_tpu_torch.ops import np_lie as tnp_lie

torch.set_num_threads(1)

ATOL, JAC_ATOL = 1e-5, 1e-4


def _poses(n, seed, scale=2.0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(0, scale, (n, 2)),
                           rng.uniform(-np.pi, np.pi, (n, 1))],
                          axis=-1).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("op", ["compose", "inverse", "apply", "retract",
                                "local_err", "normalize", "wrap_angle"])
def test_se2_values_match_jax(op):
    a, b = _poses(64, 1), _poses(64, 2)
    pt = b[:, :2]
    J, T = jlie.SE2, tlie.SE2
    if op == "compose":
        ref, out = J.compose(a, b), T.compose(_t(a), _t(b))
    elif op == "inverse":
        ref, out = J.inverse(a), T.inverse(_t(a))
    elif op == "apply":
        ref, out = J.apply(a, pt), T.apply(_t(a), _t(pt))
    elif op == "retract":
        d = 0.1 * b
        ref, out = J.retract(a, d), T.retract(_t(a), _t(d))
    elif op == "local_err":
        ref, out = J.local_err(a, b), T.local_err(_t(a), _t(b))
    elif op == "normalize":
        ref, out = J.normalize(4 * a), T.normalize(_t(4 * a))
    else:
        ref, out = jlie.wrap_angle(8 * a), tlie.wrap_angle(_t(8 * a))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def _jac_jax(f, argnum, *args):
    """[B, m, k] Jacobian of ``f`` in its ``argnum``-th argument, per row."""
    return np.asarray(jax.vmap(jax.jacfwd(f, argnums=argnum))(
        *[jnp.asarray(x) for x in args]))


def _basis(k, batch=32):
    return torch.eye(k).expand(batch, k, k)


@pytest.mark.parametrize("op", ["compose_a", "compose_b", "inverse",
                                "apply_a", "apply_pt", "retract"])
def test_se2_tangents_match_jax_jacfwd(op):
    """The port's ``*_jvp`` tangents, with the identity as the direction
    basis, are the Jacobians JAX's jacfwd takes of the same functions."""
    a, b = _poses(32, 3), _poses(32, 4)
    pt, zero = b[:, :2], np.zeros_like(b)
    J, T = jlie.SE2, tlie.SE2
    if op == "compose_a":
        ref = _jac_jax(J.compose, 0, a, b)
        _, tan = T.compose_jvp(_t(a), _t(b), _basis(3), None)
    elif op == "compose_b":
        ref = _jac_jax(J.compose, 1, a, b)
        _, tan = T.compose_jvp(_t(a), _t(b), None, _basis(3))
    elif op == "inverse":
        ref = _jac_jax(J.inverse, 0, a)
        _, tan = T.inverse_jvp(_t(a), _basis(3))
    elif op == "apply_a":
        ref = _jac_jax(J.apply, 0, a, pt)
        _, tan = T.apply_jvp(_t(a), _t(pt), _basis(3), None)
    elif op == "apply_pt":
        ref = _jac_jax(J.apply, 1, a, pt)
        _, tan = T.apply_jvp(_t(a), _t(pt), None, _basis(2))
    else:
        ref = _jac_jax(J.retract, 1, a, zero)
        _, tan = T.retract_jvp(_t(a), _t(zero), _basis(3))
    np.testing.assert_allclose(tan.numpy(), ref, atol=JAC_ATOL)


def test_jvp_values_equal_plain_values():
    """Every ``*_jvp`` returns exactly the plain function's value."""
    a, b = _t(_poses(16, 5)), _t(_poses(16, 6))
    T = tlie.SE2
    assert torch.equal(T.compose_jvp(a, b, _basis(3, 16), None)[0],
                       T.compose(a, b))
    assert torch.equal(T.inverse_jvp(a, _basis(3, 16))[0], T.inverse(a))
    assert torch.equal(T.apply_jvp(a, b[:, :2], None, _basis(2, 16))[0],
                       T.apply(a, b[:, :2]))


@pytest.mark.parametrize("op", ["compose", "inverse", "apply", "retract"])
def test_np_se2_bit_identical_to_jax_mirror(op):
    a, b = _poses(64, 7), _poses(64, 8)
    J, T = jnp_lie.NpSE2, tnp_lie.NpSE2
    if op == "compose":
        ref, out = J.compose(a, b), T.compose(a, b)
    elif op == "inverse":
        ref, out = J.inverse(a), T.inverse(a)
    elif op == "apply":
        ref, out = J.apply(a, b[:, :2]), T.apply(a, b[:, :2])
    else:
        ref, out = J.retract(a, 0.1 * b), T.retract(a, 0.1 * b)
    np.testing.assert_array_equal(out, ref)


def test_compose_path_matches_jax_mirror():
    edges = _poses(6, 9)
    path = [(0, 1), (3, -1), (5, 1), (2, -1)]
    np.testing.assert_array_equal(
        tnp_lie.compose_path(tnp_lie.NpSE2, edges, path),
        jnp_lie.compose_path(jnp_lie.NpSE2, edges, path))


# -- SE(3) -------------------------------------------------------------------


def _se3_poses(n, seed, scale=2.0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.concatenate([rng.normal(0, scale, (n, 3)), q],
                          axis=-1).astype(np.float32)


def _se3_identities(n):
    return np.tile(np.asarray([0, 0, 0, 1, 0, 0, 0], np.float32), (n, 1))


def _se3_at(point, n, seed):
    """Pairs (a, b) at a test point: random poses, the identity, or a
    pose equal to its prior (b == a)."""
    if point == "random":
        return _se3_poses(n, seed), _se3_poses(n, seed + 100)
    if point == "identity":
        return _se3_identities(n), _se3_identities(n)
    a = _se3_poses(n, seed)
    return a, a.copy()


@pytest.mark.parametrize("op", ["compose", "inverse", "apply", "pexp",
                                "plog", "retract", "local_err", "normalize"])
def test_se3_values_match_jax(op):
    a, b = _se3_poses(64, 21), _se3_poses(64, 22)
    d = np.random.default_rng(23).normal(0, 0.5, (64, 6)).astype(np.float32)
    d[:8] *= 1e-5     # the exp Taylor branch
    J, T = jlie.SE3, tlie.SE3
    if op == "compose":
        ref, out = J.compose(a, b), T.compose(_t(a), _t(b))
    elif op == "inverse":
        ref, out = J.inverse(a), T.inverse(_t(a))
    elif op == "apply":
        ref, out = J.apply(a, b[:, :3]), T.apply(_t(a), _t(b[:, :3]))
    elif op == "pexp":
        ref, out = J.pexp(d), T.pexp(_t(d))
    elif op == "plog":
        a[:8, 3:] *= -1.0     # the w < 0 hemisphere flip
        ref, out = J.plog(a), T.plog(_t(a))
    elif op == "retract":
        ref, out = J.retract(a, d), T.retract(_t(a), _t(d))
    elif op == "local_err":
        ref, out = J.local_err(a, b), T.local_err(_t(a), _t(b))
    else:
        ref, out = J.normalize(3 * a), T.normalize(_t(3 * a))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_quat_to_matrix_matches_jax():
    """Unit quaternions (both hemispheres, the identity and half-turns) to
    rotation matrices, as the chordal initializer reads them."""
    q = _se3_poses(64, 24)[:, 3:]
    q[:8] *= -1.0
    q = np.concatenate([q, np.eye(4, dtype=np.float32)])
    ref = np.asarray(jlie.quat_to_matrix(jnp.asarray(q)))
    out = tlie.quat_to_matrix(_t(q)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)
    np.testing.assert_allclose(out @ np.swapaxes(out, -1, -2),
                               np.broadcast_to(np.eye(3), out.shape),
                               atol=ATOL)


def test_se3_identity_and_groups():
    assert torch.equal(tlie.SE3.identity(),
                       torch.from_numpy(np.array(jlie.SE3.identity())))
    for name in ("SE2", "SE3"):
        G, H = tlie.GROUPS[name], jlie.GROUPS[name]
        assert (G.dim, G.dof, G.point_dim, G.name) == \
            (H.dim, H.dof, H.point_dim, H.name)


@pytest.mark.parametrize("point", ["random", "identity", "prior_eq_edge"])
@pytest.mark.parametrize("op", ["compose_a", "compose_b", "inverse",
                                "apply_a", "apply_pt", "retract", "pexp",
                                "plog", "local_err"])
def test_se3_tangents_match_jax_jacfwd(op, point):
    a, b = _se3_at(point, 32, 24)
    pt, zero = b[:, :3] + 0.5, np.zeros((32, 6), np.float32)
    J, T = jlie.SE3, tlie.SE3
    if op == "compose_a":
        ref = _jac_jax(J.compose, 0, a, b)
        _, tan = T.compose_jvp(_t(a), _t(b), _basis(7), None)
    elif op == "compose_b":
        ref = _jac_jax(J.compose, 1, a, b)
        _, tan = T.compose_jvp(_t(a), _t(b), None, _basis(7))
    elif op == "inverse":
        ref = _jac_jax(J.inverse, 0, a)
        _, tan = T.inverse_jvp(_t(a), _basis(7))
    elif op == "apply_a":
        ref = _jac_jax(J.apply, 0, a, pt)
        _, tan = T.apply_jvp(_t(a), _t(pt), _basis(7), None)
    elif op == "apply_pt":
        ref = _jac_jax(J.apply, 1, a, pt)
        _, tan = T.apply_jvp(_t(a), _t(pt), None, _basis(3))
    elif op == "retract":     # at delta = 0, as the solver takes it
        ref = _jac_jax(J.retract, 1, a, zero)
        _, tan = T.retract_jvp(_t(a), _t(zero), _basis(6))
    elif op == "pexp":        # away from 0: the exp's non-Taylor branch
        d = (0.3 * b[:, :6] if point == "random" else zero)
        ref = _jac_jax(J.pexp, 0, d)
        _, tan = T.pexp_jvp(_t(d), _basis(6))
    elif op == "plog":
        # prior_eq_edge: plog of inv(a) o a, w == 1 exactly (checked).
        c = (np.array(J.compose(J.inverse(a), b)) if point != "random"
             else a)
        if point == "prior_eq_edge":
            assert (c[:, 3] == 1.0).any()
        ref = _jac_jax(J.plog, 0, c)
        _, tan = T.plog_jvp(_t(c), _basis(7))
    else:
        ref = _jac_jax(J.local_err, 1, a, b)
        _, tan = T.local_err_jvp(_t(a), _t(b), _basis(7))
    np.testing.assert_allclose(tan.numpy(), ref, atol=JAC_ATOL)


@pytest.mark.parametrize("point", ["random", "prior_eq_edge"])
def test_se3_prior_residual_jacobian_matches_jax(point):
    """The edge-prior residual plog(inv(prior) o retract(edge, eps)) and
    its Jacobian at eps = 0, the solver's prior factor."""
    edge, prior = _se3_at(point, 32, 25)
    J, T = jlie.SE3, tlie.SE3

    def per_prior(eps, pr, pose):
        return J.plog(J.compose(J.inverse(pr), J.retract(pose, eps)))

    zero = np.zeros((32, 6), np.float32)
    r_ref = np.asarray(jax.vmap(per_prior)(zero, prior, edge))
    J_ref = _jac_jax(per_prior, 0, zero, prior, edge)
    v, dv = T.retract_jvp(_t(edge), _t(zero), _basis(6))
    c, dc = T.compose_jvp(T.inverse(_t(prior)), v, None, dv)
    r, Jt = T.plog_jvp(c, dc)
    np.testing.assert_allclose(r.numpy(), r_ref, atol=ATOL)
    np.testing.assert_allclose(Jt.numpy(), J_ref, atol=JAC_ATOL)


@pytest.mark.parametrize("group", ["SE2", "SE3"])
def test_local_err_tangent_matches_jax_jacfwd(group):
    if group == "SE2":
        a, b = _poses(32, 26), _poses(32, 27)
    else:
        a, b = _se3_poses(32, 26), _se3_poses(32, 27)
    J, T = jlie.GROUPS[group], tlie.GROUPS[group]
    ref = _jac_jax(J.local_err, 1, a, b)
    val, tan = T.local_err_jvp(_t(a), _t(b), _basis(T.dim))
    assert torch.equal(val, T.local_err(_t(a), _t(b)))
    np.testing.assert_allclose(tan.numpy(), ref, atol=JAC_ATOL)


def test_se3_jvp_values_equal_plain_values():
    a, b = _t(_se3_poses(16, 28)), _t(_se3_poses(16, 29))
    d = _t(np.random.default_rng(30).normal(0, 0.3, (16, 6)).astype(
        np.float32))
    T = tlie.SE3
    assert torch.equal(T.compose_jvp(a, b, _basis(7, 16), None)[0],
                       T.compose(a, b))
    assert torch.equal(T.inverse_jvp(a, _basis(7, 16))[0], T.inverse(a))
    assert torch.equal(T.apply_jvp(a, b[:, :3], None, _basis(3, 16))[0],
                       T.apply(a, b[:, :3]))
    assert torch.equal(T.retract_jvp(a, d, _basis(6, 16))[0],
                       T.retract(a, d))
    assert torch.equal(T.plog_jvp(a, _basis(7, 16))[0], T.plog(a))


@pytest.mark.parametrize("op", ["compose", "inverse", "apply", "retract",
                                "pexp", "plog"])
def test_np_se3_bit_identical_to_jax_mirror(op):
    a, b = _se3_poses(64, 31), _se3_poses(64, 32)
    d = 0.1 * b[:, :6]
    J, T = jnp_lie.NpSE3, tnp_lie.NpSE3
    if op == "compose":
        ref, out = J.compose(a, b), T.compose(a, b)
    elif op == "inverse":
        ref, out = J.inverse(a), T.inverse(a)
    elif op == "apply":
        ref, out = J.apply(a, b[:, :3]), T.apply(a, b[:, :3])
    elif op == "retract":
        ref, out = J.retract(a, d), T.retract(a, d)
    elif op == "pexp":
        ref, out = J.pexp(d), T.pexp(d)
    else:
        ref, out = J.plog(a), T.plog(a)
    np.testing.assert_array_equal(out, ref)
    assert tnp_lie.np_group_for(tlie.SE3) is T


def test_se3_compose_path_matches_jax_mirror():
    edges = _se3_poses(6, 33)
    path = [(0, 1), (3, -1), (5, 1), (2, -1)]
    np.testing.assert_array_equal(
        tnp_lie.compose_path(tnp_lie.NpSE3, edges, path),
        jnp_lie.compose_path(jnp_lie.NpSE3, edges, path))


# Rotations exercising every branch of quat_from_matrix (trace > 0, and the
# largest diagonal entry at x, y and z, including trace ~ -1): the rotation
# vectors of tests/test_closure.py.
QUAT_ROTVECS = ([0.1, 0.1, 0.1], [3.0, 0.1, 0.0], [0.0, 3.0, 0.1],
                [0.1, 0.0, 3.0], [np.pi, 0, 0], [0, np.pi, 0])


@pytest.mark.parametrize("w", QUAT_ROTVECS, ids=str)
def test_quat_from_matrix_bit_identical_to_jax_mirror(w):
    T = jnp_lie.NpSE3.pexp(np.asarray([0.0, 0, 0] + list(w), np.float64))
    R = np.stack([jnp_lie.quat_rotate(T[3:], e) for e in np.eye(3)], axis=-1)
    q = tnp_lie.quat_from_matrix(R)
    np.testing.assert_array_equal(q, jnp_lie.quat_from_matrix(R))
    # The same rotation up to the quaternion's sign.
    assert min(np.abs(q - T[3:]).max(), np.abs(q + T[3:]).max()) < 1e-12


def test_camera_sensor_pose_bit_identical_to_jax():
    assert tnp_lie.CAMERA_SENSOR_POSE_SE3.dtype == np.float32
    np.testing.assert_array_equal(tnp_lie.CAMERA_SENSOR_POSE_SE3,
                                  jnp_lie.CAMERA_SENSOR_POSE_SE3)
    np.testing.assert_array_equal(tnp_lie._R_ROBOT_FROM_CAM,
                                  jnp_lie._R_ROBOT_FROM_CAM)
