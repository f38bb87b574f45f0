"""Landmark parameterizations — port of :mod:`srba_tpu.models.landmarks`.

A landmark lives in the local frame of its *base keyframe* (the first KF
that observed it).  ``Euclidean*`` landmarks are points; ``RelativePoses*``
are whole poses (graph-SLAM mode, where "landmarks" are other keyframes and
the problem degenerates to a relative pose-graph).  ``dim``: state storage
width, ``dof``: tangent width, ``retract``: how an optimizer increment is
applied, ``retract_jvp``: the same with its forward-mode tangent with
respect to the increment only.
"""

from __future__ import annotations

import torch

from srba_tpu_torch.ops.lie import SE2, SE3


class _Point:
    is_pose = False

    @staticmethod
    def retract(pos, delta):
        return pos + delta

    @staticmethod
    def retract_jvp(pos, delta, ddelta):
        """Tangent with respect to ``delta`` only (forward mode)."""
        return pos + delta, ddelta


class Euclidean2D(_Point):
    name = "Euclidean2D"
    dim = 2
    dof = 2


class Euclidean3D(_Point):
    name = "Euclidean3D"
    dim = 3
    dof = 3


class RelativePoses2DLandmark:
    """Graph-SLAM 'fake landmark': an SE(2) pose relative to the base KF."""

    name = "RelativePoses2D"
    dim = 3
    dof = 3
    is_pose = True
    group = SE2
    retract = staticmethod(SE2.retract)
    retract_jvp = staticmethod(SE2.retract_jvp)


class RelativePoses3DLandmark:
    """Graph-SLAM 'fake landmark': an SE(3) pose relative to the base KF."""

    name = "RelativePoses3D"
    dim = 7
    dof = 6
    is_pose = True
    group = SE3
    retract = staticmethod(SE3.retract)
    retract_jvp = staticmethod(SE3.retract_jvp)


LANDMARK_TYPES = {
    m.name: m
    for m in [Euclidean2D, Euclidean3D,
              RelativePoses2DLandmark, RelativePoses3DLandmark]
}


def identity_state(lm_type, dtype=torch.float32, device=None):
    """Initial landmark state (identity pose for pose-landmarks, origin point
    otherwise)."""
    if lm_type.is_pose:
        return lm_type.group.identity(dtype, device)
    return torch.zeros((lm_type.dim,), dtype=dtype, device=device)
