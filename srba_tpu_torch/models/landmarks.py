"""Landmark parameterizations — port of :mod:`srba_tpu.models.landmarks`
(so far only ``Euclidean2D``; the others raise by name through the
``LANDMARK_TYPES`` lookup).

A landmark lives in the local frame of its *base keyframe* (the first KF
that observed it).  ``dim``: state storage width, ``dof``: tangent width,
``retract``: how an optimizer increment is applied.
"""

from __future__ import annotations


class Euclidean2D:
    name = "Euclidean2D"
    dim = 2
    dof = 2
    is_pose = False

    @staticmethod
    def retract(pos, delta):
        return pos + delta

    @staticmethod
    def retract_jvp(pos, delta, ddelta):
        """Tangent with respect to ``delta`` only (forward mode)."""
        return pos + delta, ddelta


LANDMARK_TYPES = {m.name: m for m in [Euclidean2D]}
