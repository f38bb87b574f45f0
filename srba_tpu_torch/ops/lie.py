"""Batched SE(2) Lie-group operations on torch tensors — the port of
:mod:`srba_tpu.ops.lie` (SE(3) is not ported yet and raises by name through
the ``GROUPS`` lookup).

Same conventions as the JAX package: poses are flat ``[..., 3] = (x, y,
theta)`` tensors, every function is shape-polymorphic over leading batch
dimensions, and the retraction is the MRPT-style pseudo-exponential whose
Jacobians the solver takes by forward-mode AD at delta = 0.  No
data-dependent control flow: angle wrapping is ``atan2(sin, cos)`` and every
switch is a ``torch.where``, never a multiply by a mask.

Forward mode is written out by hand: each ``*_jvp`` function returns the
value (computed by exactly the same formula as the plain function) and its
tangent.  A tangent has the value's shape plus a trailing axis of K
directions (``[..., 3, K]`` for a pose); ``None`` stands for a zero tangent.
The derivative of ``wrap_angle`` is taken as 1 (it is 1 everywhere except
on the branch cut, like the derivative JAX's AD takes of ``atan2(sin,
cos)``).  ``torch.func.jvp`` gives the same Jacobians but, under ``vmap``,
routes elementwise ops through slow Python decompositions; the
hand-written form is plain batched tensor arithmetic.
"""

from __future__ import annotations

import torch


def _stack_tangent(rows):
    """Stack per-component tangents ``[..., K]`` into ``[..., C, K]``
    (broadcasting, since a constant direction basis has no batch axes)."""
    return torch.stack(torch.broadcast_tensors(*rows), dim=-2)


def wrap_angle(theta):
    """Wrap angles to (-pi, pi] without branching."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


class SE2:
    """SE(2) group descriptor. ``dim``: storage width, ``dof``: tangent
    width."""

    dim = 3
    dof = 3
    point_dim = 2
    name = "SE2"

    @staticmethod
    def identity(dtype=torch.float32, device=None):
        return torch.zeros((3,), dtype=dtype, device=device)

    @staticmethod
    def compose(a, b):
        """Pose of frame C in A given a = T_A<-B, b = T_B<-C."""
        ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
        x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
        y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
        th = wrap_angle(a[..., 2] + b[..., 2])
        return torch.stack([x, y, th], dim=-1)

    @staticmethod
    def inverse(a):
        ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
        x = -(ca * a[..., 0] + sa * a[..., 1])
        y = -(-sa * a[..., 0] + ca * a[..., 1])
        return torch.stack([x, y, -a[..., 2]], dim=-1)

    @staticmethod
    def apply(a, pt):
        """Map points from the child frame into the parent frame."""
        ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
        x = a[..., 0] + ca * pt[..., 0] - sa * pt[..., 1]
        y = a[..., 1] + sa * pt[..., 0] + ca * pt[..., 1]
        return torch.stack([x, y], dim=-1)

    @staticmethod
    def pexp(delta):
        """Pseudo-exponential: tangent (dx, dy, dtheta) -> pose, translation
        direct."""
        return delta

    @staticmethod
    def plog(pose):
        return pose

    @staticmethod
    def retract(pose, delta):
        return SE2.compose(pose, SE2.pexp(delta))

    # -- forward mode (see the module docstring) ---------------------------

    @staticmethod
    def compose_jvp(a, b, da, db):
        c = SE2.compose(a, b)
        if da is None and db is None:
            return c, None
        ca, sa = torch.cos(a[..., 2:3]), torch.sin(a[..., 2:3])
        dx = dy = dt = 0.0
        if db is not None:
            dx = ca * db[..., 0, :] - sa * db[..., 1, :]
            dy = sa * db[..., 0, :] + ca * db[..., 1, :]
            dt = db[..., 2, :]
        if da is not None:
            bx, by = b[..., 0:1], b[..., 1:2]
            dx = dx + da[..., 0, :] + (-sa * bx - ca * by) * da[..., 2, :]
            dy = dy + da[..., 1, :] + (ca * bx - sa * by) * da[..., 2, :]
            dt = dt + da[..., 2, :]
        return c, _stack_tangent([dx, dy, dt])

    @staticmethod
    def inverse_jvp(a, da):
        ai = SE2.inverse(a)
        if da is None:
            return ai, None
        ca, sa = torch.cos(a[..., 2:3]), torch.sin(a[..., 2:3])
        x, y = a[..., 0:1], a[..., 1:2]
        dx, dy, dt = da[..., 0, :], da[..., 1, :], da[..., 2, :]
        return ai, _stack_tangent([
            -(ca * dx + sa * dy + (-sa * x + ca * y) * dt),
            -(-sa * dx + ca * dy + (-ca * x - sa * y) * dt),
            -dt])

    @staticmethod
    def apply_jvp(a, pt, da, dpt):
        p = SE2.apply(a, pt)
        if da is None and dpt is None:
            return p, None
        ca, sa = torch.cos(a[..., 2:3]), torch.sin(a[..., 2:3])
        dx = dy = 0.0
        if dpt is not None:
            dx = ca * dpt[..., 0, :] - sa * dpt[..., 1, :]
            dy = sa * dpt[..., 0, :] + ca * dpt[..., 1, :]
        if da is not None:
            px, py = pt[..., 0:1], pt[..., 1:2]
            dx = dx + da[..., 0, :] + (-sa * px - ca * py) * da[..., 2, :]
            dy = dy + da[..., 1, :] + (ca * px - sa * py) * da[..., 2, :]
        return p, _stack_tangent([dx, dy])

    @staticmethod
    def retract_jvp(pose, delta, ddelta):
        """Tangent with respect to ``delta`` only (the pose is a constant)."""
        return SE2.compose_jvp(pose, SE2.pexp(delta), None, ddelta)

    @staticmethod
    def plog_jvp(pose, dpose):
        return SE2.plog(pose), dpose

    @staticmethod
    def local_err(a, b):
        """Tangent of ``inverse(a) . b`` — residual for relative-pose
        observations."""
        d = SE2.compose(SE2.inverse(a), b)
        return torch.cat([d[..., :2], wrap_angle(d[..., 2:3])], dim=-1)

    @staticmethod
    def normalize(pose):
        return torch.cat([pose[..., :2], wrap_angle(pose[..., 2:3])], dim=-1)


GROUPS = {"SE2": SE2}
