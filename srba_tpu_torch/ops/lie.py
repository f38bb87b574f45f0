"""Batched SE(2)/SE(3) Lie-group operations on torch tensors — the port of
:mod:`srba_tpu.ops.lie`.

Same conventions as the JAX package: poses are flat tensors, SE(2) as
``[..., 3] = (x, y, theta)`` and SE(3) as ``[..., 7] = (tx, ty, tz, qw, qx,
qy, qz)`` (unit quaternion, scalar first); every function is
shape-polymorphic over leading batch dimensions, and the retraction is the
MRPT-style pseudo-exponential whose Jacobians the solver takes by
forward-mode AD at delta = 0.  No data-dependent control flow: angle
wrapping is ``atan2(sin, cos)``, the quaternion exp/log Taylor switches are
``torch.where`` on a safe denominator, and every switch is a
``torch.where``, never a multiply by a mask.

Forward mode is written out by hand: each ``*_jvp`` function returns the
value (computed by exactly the same formula as the plain function) and its
tangent.  A tangent has the value's shape plus a trailing axis of K
directions (``[..., 3, K]`` for an SE(2) pose); ``None`` stands for a zero
tangent.  The derivative of ``wrap_angle`` is taken as 1 (it is 1
everywhere except on the branch cut, like the derivative JAX's AD takes of
``atan2(sin, cos)``); at the ties of ``quat_log``'s ``clip`` and
``maximum`` the derivative is 0.5, as JAX's AD takes it.
``torch.func.jvp`` gives the same Jacobians but, under ``vmap``, routes
elementwise ops through slow Python decompositions; the hand-written form
is plain batched tensor arithmetic.
"""

from __future__ import annotations

import torch

# Small angle threshold for the exp/log Taylor branches (f32-safe), as in
# the JAX package.
_EPS = 1e-8


def _stack_tangent(rows):
    """Stack per-component tangents ``[..., K]`` into ``[..., C, K]``
    (broadcasting, since a constant direction basis has no batch axes)."""
    return torch.stack(torch.broadcast_tensors(*rows), dim=-2)


def _col(x):
    """A value ``[..., C]`` as ``[..., C, 1]``, to broadcast against its
    tangent ``[..., C, K]``."""
    return x[..., None]


def _add(*terms):
    """Sum of tangents, ``None`` (zero) terms skipped; None if all are."""
    out = None
    for t in terms:
        if t is not None:
            out = t if out is None else out + t
    return out


def _cat_tangent(parts):
    """Concatenate tangents ``[..., C_i, K]`` along the component axis,
    broadcasting their batch axes."""
    batch = torch.broadcast_shapes(*[p.shape[:-2] for p in parts])
    return torch.cat([p.expand(batch + p.shape[-2:]) for p in parts], dim=-2)


def _part(t, lo, hi):
    """Components ``lo:hi`` of a tangent (None stays None)."""
    return None if t is None else t[..., lo:hi, :]


def wrap_angle(theta):
    """Wrap angles to (-pi, pi] without branching."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


# ---------------------------------------------------------------------------
# Quaternions: scalar-first (w, x, y, z), unit norm.  The helpers take the
# component axis as ``dim``: -1 for values, -2 for tangents (a value passed
# through ``_col`` broadcasts against a tangent there).
# ---------------------------------------------------------------------------


def _qmul(q1, q2, dim=-1):
    w1, x1, y1, z1 = q1.unbind(dim)
    w2, x2, y2, z2 = q2.unbind(dim)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=dim,
    )


def _cross(a, b, dim=-1):
    # Broadcast first: linalg.cross wants operands of equal rank, and a
    # constant direction basis has no batch axes.
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=dim)


def quat_mul(q1, q2):
    return _qmul(q1, q2)


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_rotate(q, v):
    """Rotate 3-vectors ``v`` by unit quaternions ``q`` (batched)."""
    w, u = q[..., :1], q[..., 1:]
    # v' = v + 2 w (u x v) + 2 u x (u x v)
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def _qexp_parts(omega):
    theta2 = torch.sum(omega * omega, dim=-1, keepdim=True)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    half = 0.5 * theta
    # sin(x/2)/x with Taylor fallback: 0.5 - theta^2/48 for tiny theta.
    small = theta2 < _EPS
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return theta, half, small, k, w


def quat_exp(omega):
    """SO(3) exponential: rotation vector ``[..., 3]`` -> unit quaternion."""
    _, _, _, k, w = _qexp_parts(omega)
    return quat_normalize(torch.cat([w, k * omega], dim=-1))


def _qlog_parts(q):
    # Force the w >= 0 hemisphere so the result angle is in [0, pi].
    sign = torch.where(q[..., :1] < 0.0, -1.0, 1.0)
    q = q * sign
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    vn2 = torch.sum(v * v, dim=-1, keepdim=True)
    vn = torch.sqrt(vn2 + _EPS * _EPS)
    angle = 2.0 * torch.atan2(vn, w)
    small = vn2 < _EPS
    wm = torch.clamp_min(w, _EPS)
    k = torch.where(small, 2.0 / wm, angle / vn)
    return sign, q[..., :1], w, v, vn, angle, small, wm, k


def quat_log(q):
    """Unit quaternion -> rotation vector ``[..., 3]`` (inverse of
    quat_exp)."""
    *_, v, _, _, _, _, k = _qlog_parts(q)
    return k * v


# -- quaternion forward mode (tangents only; see the module docstring) ------


def _qmul_tan(q1, q2, dq1, dq2):
    return _add(None if dq1 is None else _qmul(dq1, _col(q2), -2),
                None if dq2 is None else _qmul(_col(q1), dq2, -2))


def _qnormalize_tan(q, dq):
    """Tangent of ``q / |q|``: ``(dq - qn (qn . dq)) / |q|``."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    qn = _col(q / n)
    return (dq - qn * torch.sum(qn * dq, dim=-2, keepdim=True)) / _col(n)


def _qrotate_tan(q, v, dq, dv):
    w, u = q[..., :1], q[..., 1:]
    uv = _cross(u, v)
    du = _part(dq, 1, 4)
    duv = _add(None if du is None else _cross(du, _col(v), -2),
               None if dv is None else _cross(_col(u), dv, -2))
    inner = _add(None if dq is None else dq[..., :1, :] * _col(uv),
                 _col(w) * duv,
                 None if du is None else _cross(du, _col(uv), -2),
                 _cross(_col(u), duv, -2))
    return _add(dv, 2.0 * inner)


def _qexp_jvp(omega, domega):
    theta, half, small, k, w = _qexp_parts(omega)
    q = torch.cat([w, k * omega], dim=-1)
    if domega is None:
        return quat_normalize(q), None
    om, th, hf = _col(omega), _col(theta), _col(half)
    dtheta2 = 2.0 * torch.sum(om * domega, dim=-2, keepdim=True)
    dtheta = dtheta2 / (2.0 * th)
    s = _col(small)
    dk = torch.where(s, -dtheta2 / 48.0,
                     (0.5 * torch.cos(hf) * th - torch.sin(hf)) * dtheta
                     / (th * th))
    dw = torch.where(s, -dtheta2 / 8.0, -0.5 * torch.sin(hf) * dtheta)
    dq = _cat_tangent([dw, dk * om + _col(k) * domega])
    return quat_normalize(q), _qnormalize_tan(q, dq)


def _tie_derivative(x, bound, above):
    """Derivative JAX's AD takes of ``maximum(x, bound)`` (``above``) or
    ``minimum(x, bound)``: 1 on the side of x, 0 on the other, 0.5 at the
    tie."""
    inside = x > bound if above else x < bound
    return torch.where(inside, 1.0, torch.where(x == bound, 0.5, 0.0))


def _qlog_jvp(q, dq):
    sign, wq, w, v, vn, angle, small, wm, k = _qlog_parts(q)
    out = k * v
    if dq is None:
        return out, None
    dq = dq * _col(sign)
    # clip(wq, -1, 1) is maximum(-1, .) then minimum(1, .) in JAX.
    dclip = (_tie_derivative(wq, -1.0, above=True)
             * _tie_derivative(torch.clamp_min(wq, -1.0), 1.0, above=False))
    dw = dq[..., :1, :] * _col(dclip)
    dv = dq[..., 1:, :]
    W, VN, ANG, V = _col(w), _col(vn), _col(angle), _col(v)
    dvn = torch.sum(V * dv, dim=-2, keepdim=True) / VN
    dangle = 2.0 * (W * dvn - VN * dw) / (VN * VN + W * W)
    dwm = dw * _col(_tie_derivative(w, _EPS, above=True))
    WM = _col(wm)
    dk = torch.where(_col(small), -2.0 * dwm / (WM * WM),
                     (dangle - ANG * dvn / VN) / VN)
    return out, dk * V + _col(k) * dv


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
    def local_err_jvp(a, b, db):
        """Tangent with respect to ``b`` only (``a`` is a constant)."""
        d, dd = SE2.compose_jvp(SE2.inverse(a), b, None, db)
        return torch.cat([d[..., :2], wrap_angle(d[..., 2:3])], dim=-1), dd

    @staticmethod
    def normalize(pose):
        return torch.cat([pose[..., :2], wrap_angle(pose[..., 2:3])], dim=-1)


# ---------------------------------------------------------------------------
# SE(3): pose = (tx, ty, tz, qw, qx, qy, qz).  Acts on 3D points.
# ---------------------------------------------------------------------------


class SE3:
    dim = 7
    dof = 6
    point_dim = 3
    name = "SE3"

    @staticmethod
    def identity(dtype=torch.float32, device=None):
        # A fill, not a host list: no host->device copy on a CUDA device.
        ident = torch.zeros((7,), dtype=dtype, device=device)
        ident[3] = 1.0
        return ident

    @staticmethod
    def compose(a, b):
        t = a[..., :3] + quat_rotate(a[..., 3:], b[..., :3])
        q = quat_mul(a[..., 3:], b[..., 3:])
        return torch.cat([t, quat_normalize(q)], dim=-1)

    @staticmethod
    def inverse(a):
        qi = quat_conj(a[..., 3:])
        return torch.cat([-quat_rotate(qi, a[..., :3]), qi], dim=-1)

    @staticmethod
    def apply(a, pt):
        return a[..., :3] + quat_rotate(a[..., 3:], pt)

    @staticmethod
    def pexp(delta):
        """Pseudo-exp: (dt[3], dw[3]) -> pose; translation direct, rotation
        exp."""
        return torch.cat([delta[..., :3], quat_exp(delta[..., 3:])], dim=-1)

    @staticmethod
    def plog(pose):
        return torch.cat([pose[..., :3], quat_log(pose[..., 3:])], dim=-1)

    @staticmethod
    def retract(pose, delta):
        return SE3.compose(pose, SE3.pexp(delta))

    @staticmethod
    def local_err(a, b):
        return SE3.plog(SE3.compose(SE3.inverse(a), b))

    @staticmethod
    def normalize(pose):
        return torch.cat([pose[..., :3], quat_normalize(pose[..., 3:])],
                         dim=-1)

    # -- forward mode (see the module docstring) ---------------------------
    # The values are computed inline by the plain functions' formulas (the
    # tangents need their intermediates).

    @staticmethod
    def compose_jvp(a, b, da, db):
        aq, bt, bq = a[..., 3:], b[..., :3], b[..., 3:]
        t = a[..., :3] + quat_rotate(aq, bt)
        q = quat_mul(aq, bq)
        c = torch.cat([t, quat_normalize(q)], dim=-1)
        if da is None and db is None:
            return c, None
        daq = _part(da, 3, 7)
        dt = _add(_part(da, 0, 3), _qrotate_tan(aq, bt, daq, _part(db, 0, 3)))
        dq = _qnormalize_tan(q, _qmul_tan(aq, bq, daq, _part(db, 3, 7)))
        return c, _cat_tangent([dt, dq])

    @staticmethod
    def inverse_jvp(a, da):
        qi = quat_conj(a[..., 3:])
        ai = torch.cat([-quat_rotate(qi, a[..., :3]), qi], dim=-1)
        if da is None:
            return ai, None
        dqi = torch.cat([da[..., 3:4, :], -da[..., 4:, :]], dim=-2)
        dt = -_qrotate_tan(qi, a[..., :3], dqi, da[..., :3, :])
        return ai, _cat_tangent([dt, dqi])

    @staticmethod
    def apply_jvp(a, pt, da, dpt):
        p = SE3.apply(a, pt)
        if da is None and dpt is None:
            return p, None
        return p, _add(_part(da, 0, 3),
                       _qrotate_tan(a[..., 3:], pt, _part(da, 3, 7), dpt))

    @staticmethod
    def pexp_jvp(delta, ddelta):
        q, dq = _qexp_jvp(delta[..., 3:], _part(ddelta, 3, 6))
        e = torch.cat([delta[..., :3], q], dim=-1)
        return e, (None if ddelta is None
                   else _cat_tangent([ddelta[..., :3, :], dq]))

    @staticmethod
    def retract_jvp(pose, delta, ddelta):
        """Tangent with respect to ``delta`` only (the pose is a constant)."""
        e, de = SE3.pexp_jvp(delta, ddelta)
        return SE3.compose_jvp(pose, e, None, de)

    @staticmethod
    def plog_jvp(pose, dpose):
        w, dw = _qlog_jvp(pose[..., 3:], _part(dpose, 3, 7))
        v = torch.cat([pose[..., :3], w], dim=-1)
        return v, (None if dpose is None
                   else _cat_tangent([dpose[..., :3, :], dw]))

    @staticmethod
    def local_err_jvp(a, b, db):
        """Tangent with respect to ``b`` only (``a`` is a constant)."""
        return SE3.plog_jvp(*SE3.compose_jvp(SE3.inverse(a), b, None, db))


GROUPS = {"SE2": SE2, "SE3": SE3}
