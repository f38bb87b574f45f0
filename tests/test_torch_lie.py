"""SE(2) operations of the port against the JAX package, on the same seeded
inputs: the torch group (values and hand-written forward-mode tangents) and
the host numpy mirror.

Tolerances: values at atol 1e-5 (f32 trig of angles up to pi; the two
frameworks' sin/cos/atan2 may differ in the last ulps); Jacobians at
atol 1e-4 (products of those values, and the port takes the derivative of
``wrap_angle`` as exactly 1 where JAX's AD evaluates it in f32).  The numpy
mirrors run the same numpy calls and must agree bit for bit.
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
