"""Host-side (numpy) SE(2) operations — a copy of the SE(2) part of
:mod:`srba_tpu.ops.np_lie` (importing that module would pull in JAX through
``srba_tpu/__init__.py``).

The engine's host bookkeeping (dead-reckoned seeds, global-map recovery,
landmark init) composes a handful of poses at a time; these are the same
formulas as :mod:`srba_tpu_torch.ops.lie` on numpy arrays, so no tiny op
ever becomes a device launch.  ``tests/test_torch_lie.py`` pins them against
the JAX package's numpy mirror.
"""

from __future__ import annotations

import numpy as np

from srba_tpu_torch.utils.registry import lookup


def wrap_angle(theta):
    return np.arctan2(np.sin(theta), np.cos(theta))


class NpSE2:
    dim = 3
    dof = 3
    point_dim = 2

    @staticmethod
    def identity(dtype=np.float32):
        return np.zeros(3, dtype=dtype)

    @staticmethod
    def compose(a, b):
        a, b = np.asarray(a), np.asarray(b)
        ca, sa = np.cos(a[..., 2]), np.sin(a[..., 2])
        return np.stack(
            [
                a[..., 0] + ca * b[..., 0] - sa * b[..., 1],
                a[..., 1] + sa * b[..., 0] + ca * b[..., 1],
                wrap_angle(a[..., 2] + b[..., 2]),
            ],
            axis=-1,
        )

    @staticmethod
    def inverse(a):
        a = np.asarray(a)
        ca, sa = np.cos(a[..., 2]), np.sin(a[..., 2])
        return np.stack(
            [
                -(ca * a[..., 0] + sa * a[..., 1]),
                -(-sa * a[..., 0] + ca * a[..., 1]),
                -a[..., 2],
            ],
            axis=-1,
        )

    @staticmethod
    def apply(a, pt):
        a, pt = np.asarray(a), np.asarray(pt)
        ca, sa = np.cos(a[..., 2]), np.sin(a[..., 2])
        return np.stack(
            [
                a[..., 0] + ca * pt[..., 0] - sa * pt[..., 1],
                a[..., 1] + sa * pt[..., 0] + ca * pt[..., 1],
            ],
            axis=-1,
        )

    @staticmethod
    def pexp(delta):
        return np.asarray(delta)

    @staticmethod
    def plog(pose):
        return np.asarray(pose)

    @classmethod
    def retract(cls, pose, delta):
        return cls.compose(pose, cls.pexp(delta))


NP_GROUPS = {"SE2": NpSE2}


def np_group_for(group):
    """Map a device group descriptor (SE2) to its numpy mirror."""
    return lookup(NP_GROUPS, group.name, "pose group")


def compose_path(np_group, edge_poses: np.ndarray, path) -> np.ndarray:
    """Compose ``T_src<-dst`` along a spanning-tree ``path`` of
    ``(edge_id, sign)`` steps (host-side; the device composes inside the
    solver instead)."""
    T = np_group.identity()
    for eid, sign in path:
        e = edge_poses[eid]
        T = np_group.compose(T, e if sign == 1 else np_group.inverse(e))
    return T
