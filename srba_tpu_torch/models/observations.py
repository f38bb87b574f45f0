"""Observation (sensor) models — port of :mod:`srba_tpu.models.observations`
(so far the range-bearing, Cartesian, stereo-camera and relative-pose
models; the monocular and RGB-D cameras raise by name through the
``OBSERVATION_MODELS`` lookup).

As in the JAX package, ``h``/``residual`` take the landmark already
expressed in the sensor frame (path composition happens in the solver; for
the relative-pose models it is the landmark pose itself), and Jacobians come
from forward mode through these functions: ``h_jvp`` and ``residual_jvp``
return the value and its tangent (a trailing axis of K directions; the
angle wrap has derivative 1).  The point models' functions are
namespace-generic: numpy in gives numpy out (dataset generation and
inverse-model landmark init stay on the host, bit-identical to the JAX
package's numpy path), torch in gives torch out (the solver).

A calibration (:class:`StereoCalib`) holds float32 numpy scalars for the
host path; the torch path takes it as Python floats
(:func:`calib_constants`): a float reaches a kernel as an argument and
enters the arithmetic as float32, with no host->device copy, while a numpy
scalar times a CUDA tensor is not a safe mix.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from srba_tpu_torch.ops.lie import SE2, SE3, _tie_derivative


def _xp(a):
    """Namespace dispatch: numpy in -> numpy out (host path, no device
    launch), anything else -> torch."""
    return np if isinstance(a, np.ndarray) else torch


def _wrap(xp, theta):
    return xp.arctan2(xp.sin(theta), xp.cos(theta))


@dataclass(frozen=True)
class StereoCalib:
    """Rectified stereo calibration (analog of the reference's
    ``TStereoCamera``): identical left/right pinholes separated along +x by
    ``baseline``.  :meth:`make` stores float32 numpy scalars, the values of
    the JAX package's ``StereoCalib.make``."""

    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float

    @staticmethod
    def make(fx=200.0, fy=200.0, cx=160.0, cy=120.0, baseline=0.12,
             dtype=np.float32):
        return StereoCalib(fx=dtype(fx), fy=dtype(fy), cx=dtype(cx),
                           cy=dtype(cy), baseline=dtype(baseline))


def calib_constants(calib):
    """``calib`` with every field a Python float (the form the torch path
    takes; see the module docstring), or None."""
    if calib is None:
        return None
    return dataclasses.replace(calib, **{
        f.name: float(getattr(calib, f.name))
        for f in dataclasses.fields(calib)})


# Small positive floor to keep divisions/atan2 well-defined on padded
# (masked-out) lanes without branching.
_SAFE = 1e-9


class _PointObs:
    """Base for landmark-point observation models."""

    has_inverse_model = True
    is_pose_landmark = False

    @classmethod
    def residual(cls, pred, z):
        return pred - z

    @classmethod
    def residual_jvp(cls, pred, z, dpred):
        """The residual and its tangent (``pred - z`` up to angle wraps,
        whose derivative is 1)."""
        return cls.residual(pred, z), dpred


class _Cartesian(_PointObs):
    """Direct sensor-frame coordinates of the landmark."""

    @staticmethod
    def h(lm_in_sensor, calib=None):
        return lm_in_sensor

    @staticmethod
    def h_jvp(pt, dpt, calib=None):
        return pt, dpt

    @staticmethod
    def inverse(z, calib=None):
        return z


class Cartesian2D(_Cartesian):
    """obs = (x, y)."""

    name = "Cartesian2D"
    obs_dim = 2
    z_dim = 2
    lm_dim = 2
    pose_group = SE2


class Cartesian3D(_Cartesian):
    """obs = (x, y, z)."""

    name = "Cartesian3D"
    obs_dim = 3
    z_dim = 3
    lm_dim = 3
    pose_group = SE3


class RangeBearing2D(_PointObs):
    """obs = (range, yaw) of a 2D landmark from the sensor."""

    name = "RangeBearing2D"
    obs_dim = 2
    z_dim = 2
    lm_dim = 2
    pose_group = SE2

    @staticmethod
    def h(lm_in_sensor, calib=None):
        xp = _xp(lm_in_sensor)
        x, y = lm_in_sensor[..., 0], lm_in_sensor[..., 1]
        r = xp.sqrt(x * x + y * y + _SAFE)
        yaw = xp.arctan2(y, x + _SAFE)
        return xp.stack([r, yaw], axis=-1)

    @classmethod
    def residual(cls, pred, z):
        xp = _xp(pred)
        d = pred - z
        return xp.concatenate([d[..., :1], _wrap(xp, d[..., 1:2])], axis=-1)

    @staticmethod
    def h_jvp(pt, dpt, calib=None):
        """``h`` and its forward-mode tangent (torch; ``dpt [..., 2, K]``)."""
        pred = RangeBearing2D.h(pt, calib)
        x, y = pt[..., 0:1], pt[..., 1:2]
        dx, dy = dpt[..., 0, :], dpt[..., 1, :]
        xs = x + _SAFE
        dr = (x * dx + y * dy) / pred[..., 0:1]
        dyaw = (xs * dy - y * dx) / (xs * xs + y * y)
        return pred, torch.stack([dr, dyaw], dim=-2)

    @staticmethod
    def inverse(z, calib=None):
        xp = _xp(z)
        r, yaw = z[..., 0], z[..., 1]
        return xp.stack([r * xp.cos(yaw), r * xp.sin(yaw)], axis=-1)


class RangeBearing3D(_PointObs):
    """obs = (range, yaw, pitch) of a 3D landmark from the sensor."""

    name = "RangeBearing3D"
    obs_dim = 3
    z_dim = 3
    lm_dim = 3
    pose_group = SE3

    @staticmethod
    def h(lm_in_sensor, calib=None):
        xp = _xp(lm_in_sensor)
        x, y, z = (lm_in_sensor[..., 0], lm_in_sensor[..., 1],
                   lm_in_sensor[..., 2])
        r = xp.sqrt(x * x + y * y + z * z + _SAFE)
        yaw = xp.arctan2(y, x + _SAFE)
        pitch = xp.arctan2(-z, xp.sqrt(x * x + y * y + _SAFE))
        return xp.stack([r, yaw, pitch], axis=-1)

    @classmethod
    def residual(cls, pred, z):
        # Both angles wrap (yaw and pitch).
        xp = _xp(pred)
        d = pred - z
        return xp.concatenate([d[..., :1], _wrap(xp, d[..., 1:3])], axis=-1)

    @staticmethod
    def h_jvp(pt, dpt, calib=None):
        """``h`` and its forward-mode tangent (torch; ``dpt [..., 3, K]``)."""
        pred = RangeBearing3D.h(pt, calib)
        x, y, z = pt[..., 0:1], pt[..., 1:2], pt[..., 2:3]
        dx, dy, dz = dpt[..., 0, :], dpt[..., 1, :], dpt[..., 2, :]
        xs = x + _SAFE
        rho = torch.sqrt(x * x + y * y + _SAFE)
        drho = (x * dx + y * dy) / rho
        dr = (x * dx + y * dy + z * dz) / pred[..., 0:1]
        dyaw = (xs * dy - y * dx) / (xs * xs + y * y)
        # atan2(-z, rho): (rho * (-dz) - (-z) * drho) / (rho^2 + z^2)
        dpitch = (z * drho - rho * dz) / (rho * rho + z * z)
        return pred, torch.stack([dr, dyaw, dpitch], dim=-2)

    @staticmethod
    def inverse(z, calib=None):
        xp = _xp(z)
        r, yaw, pitch = z[..., 0], z[..., 1], z[..., 2]
        cp = xp.cos(pitch)
        return xp.stack(
            [r * cp * xp.cos(yaw), r * cp * xp.sin(yaw), -r * xp.sin(pitch)],
            axis=-1,
        )


class StereoCamera(_PointObs):
    """Rectified stereo pair, obs = (ul, vl, ur, vr); right camera at
    (+baseline, 0, 0) in the left-camera (sensor) frame, which looks along
    +z."""

    name = "StereoCamera"
    obs_dim = 4
    z_dim = 4
    lm_dim = 3
    pose_group = SE3

    @staticmethod
    def h(lm_in_sensor, calib: StereoCalib):
        xp = _xp(lm_in_sensor)
        x, y, zc = (lm_in_sensor[..., 0], lm_in_sensor[..., 1],
                    lm_in_sensor[..., 2])
        inv_z = 1.0 / (np.maximum(zc, 1e-4) if xp is np
                       else torch.clamp_min(zc, 1e-4))
        ul = calib.cx + calib.fx * x * inv_z
        vl = calib.cy + calib.fy * y * inv_z
        ur = calib.cx + calib.fx * (x - calib.baseline) * inv_z
        vr = vl
        return xp.stack([ul, vl, ur, vr], axis=-1)

    @staticmethod
    def h_jvp(pt, dpt, calib: StereoCalib):
        """``h`` and its forward-mode tangent (torch; ``dpt [..., 3, K]``).
        The depth floor ``max(zc, 1e-4)`` has derivative 0.5 at the tie, as
        JAX's AD takes it."""
        pred = StereoCamera.h(pt, calib)
        x, y, zc = pt[..., 0:1], pt[..., 1:2], pt[..., 2:3]
        dx, dy, dz = dpt[..., 0, :], dpt[..., 1, :], dpt[..., 2, :]
        m = torch.clamp_min(zc, 1e-4)
        inv_z = 1.0 / m
        # d(1/m) = -dm / m^2, dm = dz * (derivative of the floor).
        dinv = -(dz * _tie_derivative(zc, 1e-4, above=True)) / (m * m)
        dul = calib.fx * (dx * inv_z + x * dinv)
        dvl = calib.fy * (dy * inv_z + y * dinv)
        dur = calib.fx * (dx * inv_z + (x - calib.baseline) * dinv)
        return pred, torch.stack(torch.broadcast_tensors(dul, dvl, dur, dvl),
                                 dim=-2)

    @staticmethod
    def inverse(z, calib: StereoCalib):
        xp = _xp(z)
        d = z[..., 0] - z[..., 2]
        disparity = (np.maximum(d, 1e-3) if xp is np
                     else torch.clamp_min(d, 1e-3))
        depth = calib.fx * calib.baseline / disparity
        x = (z[..., 0] - calib.cx) / calib.fx * depth
        y = (z[..., 1] - calib.cy) / calib.fy * depth
        return xp.stack([x, y, depth], axis=-1)


class _RelativePoses:
    """Graph-SLAM mode: the 'landmark' is another keyframe's relative pose
    and the observation a measured relative pose; the solver composes the
    path with the landmark pose (no ``apply``) and the residual is the
    group's ``local_err(z, pred)``.  No Schur marginalization applies: the
    pose landmarks are fixed."""

    has_inverse_model = True
    is_pose_landmark = True

    @staticmethod
    def h(lm_pose_in_obs_frame, calib=None):
        return lm_pose_in_obs_frame

    @staticmethod
    def h_jvp(pose, dpose, calib=None):
        return pose, dpose

    @classmethod
    def residual(cls, pred, z):
        return cls.pose_group.local_err(z, pred)

    @classmethod
    def residual_jvp(cls, pred, z, dpred):
        return cls.pose_group.local_err_jvp(z, pred, dpred)

    @staticmethod
    def inverse(z, calib=None):
        return z


class RelativePoses2D(_RelativePoses):
    """Observation = relative SE(2) pose (x, y, yaw)."""

    name = "RelativePoses2D"
    obs_dim = 3   # residual dimension
    z_dim = 3     # stored measurement width (SE2 pose storage)
    lm_dim = 3    # landmark state is an SE2 pose
    pose_group = SE2


class RelativePoses3D(_RelativePoses):
    """Observation = relative SE(3) pose; residual in the tangent (6)."""

    name = "RelativePoses3D"
    obs_dim = 6   # residual dimension (tangent)
    z_dim = 7     # stored measurement width (SE3 pose storage)
    lm_dim = 7    # SE3 pose storage
    pose_group = SE3


OBSERVATION_MODELS = {
    m.name: m
    for m in [Cartesian2D, Cartesian3D, RangeBearing2D, RangeBearing3D,
              StereoCamera, RelativePoses2D, RelativePoses3D]
}
