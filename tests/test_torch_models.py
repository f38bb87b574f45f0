"""Models of the port (RangeBearing2D, Euclidean2D, NoiseIdentity,
SensorPoseNone, the pseudo-Huber kernel) against the JAX package on the same
seeded inputs.

Tolerances: torch values at atol 1e-5 (f32 sqrt/atan2/trig of the two
frameworks may differ in the last ulps at ranges up to ~10); the ``h``
Jacobian at atol 1e-4; the numpy paths (dataset generation, landmark init)
run the same numpy calls as the JAX package's numpy path and must agree bit
for bit.
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
