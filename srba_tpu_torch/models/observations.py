"""Observation (sensor) models — port of :mod:`srba_tpu.models.observations`
(so far only ``RangeBearing2D``; the other eight models raise by name
through the ``OBSERVATION_MODELS`` lookup).

As in the JAX package, ``h``/``residual`` take the landmark already
expressed in the sensor frame (path composition happens in the solver), and
Jacobians come from forward-mode AD of these functions.  The functions are
namespace-generic: numpy in gives numpy out (dataset generation and
inverse-model landmark init stay on the host, bit-identical to the JAX
package's numpy path), torch in gives torch out (the solver).
"""

from __future__ import annotations

import numpy as np
import torch

from srba_tpu_torch.ops.lie import SE2


def _xp(a):
    """Namespace dispatch: numpy in -> numpy out (host path, no device
    launch), anything else -> torch."""
    return np if isinstance(a, np.ndarray) else torch


def _wrap(xp, theta):
    return xp.arctan2(xp.sin(theta), xp.cos(theta))


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

    @classmethod
    def residual_jvp(cls, pred, z, dpred):
        """The residual and its tangent (the angle wrap has derivative 1)."""
        return cls.residual(pred, z), dpred

    @staticmethod
    def inverse(z, calib=None):
        xp = _xp(z)
        r, yaw = z[..., 0], z[..., 1]
        return xp.stack([r * xp.cos(yaw), r * xp.sin(yaw)], axis=-1)


OBSERVATION_MODELS = {m.name: m for m in [RangeBearing2D]}
