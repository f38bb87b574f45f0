"""Chordal initialization for global pose-graph optimization — the port of
:mod:`srba_tpu.solver.chordal`.

The LM-PCG optimizer (:mod:`srba_tpu_torch.solver.global_graphslam`) is a
local method: with large accumulated orientation drift (several revolutions
of yaw error) it traps in poor basins.  This is the standard two-stage
chordal initializer, as in the JAX package:

1. **Rotation averaging (chordal relaxation).**  Relax each global rotation
   to an unconstrained ``d x d`` matrix ``M_k`` and minimize the convex
   quadratic ``sum_e w_e ||M_a R_ab - M_b||_F^2`` (+ a gauge anchor on node
   0, + a Tikhonov pull toward the input so disconnected nodes are
   untouched), matrix-free by Jacobi-preconditioned CG; then project each
   ``M_k`` to SO(d) (closed form for d=2; batched SVD for d=3).
2. **Translation recovery.**  With rotations fixed, ``t_b - t_a = R_a t_ab``
   is linear: one more Jacobi-CG on the graph Laplacian.

What differs from the JAX package: the segment sums over edge endpoints are
the fixed-order gather-sums of :class:`~srba_tpu_torch.solver.pgo_ops.
EdgeIncidence` (no atomics), and the CG loops read their exit test on the
host every trip (:func:`~srba_tpu_torch.solver.pgo_ops.pcg`).  With an
``axis_name`` the edge tables are this rank's shard and every sum over
edges is all-reduced where the JAX package ``psum``s it, so the CG exits,
read from reduced values only, agree on every rank.
"""

from __future__ import annotations

import torch

from srba_tpu_torch.ops.lie import quat_to_matrix
from srba_tpu_torch.solver.pgo_ops import EdgeIncidence, HostReads, pcg
from srba_tpu_torch.utils.collectives import (all_reduce_packed,
                                              axis_group, psum)


def _so2_from_theta(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                       -2)


def _matrix_to_quat(R):
    """Batched rotation matrix -> unit quaternion (w, x, y, z); Shepperd's
    method as a branchless 4-way select (``torch.argmax`` takes the first
    index on ties, as ``jnp.argmax`` does)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # Four candidate constructions, each numerically good in its own region.
    sw = torch.sqrt(torch.clamp_min(1.0 + tr, 1e-12)) * 0.5        # = |qw|
    qw_w, qx_w = sw, (m21 - m12) / (4.0 * sw + 1e-30)
    qy_w, qz_w = (m02 - m20) / (4.0 * sw + 1e-30), \
        (m10 - m01) / (4.0 * sw + 1e-30)
    sx = torch.sqrt(torch.clamp_min(1.0 + m00 - m11 - m22, 1e-12)) * 0.5
    qw_x, qx_x = (m21 - m12) / (4.0 * sx + 1e-30), sx
    qy_x, qz_x = (m01 + m10) / (4.0 * sx + 1e-30), \
        (m02 + m20) / (4.0 * sx + 1e-30)
    sy = torch.sqrt(torch.clamp_min(1.0 - m00 + m11 - m22, 1e-12)) * 0.5
    qw_y, qx_y = (m02 - m20) / (4.0 * sy + 1e-30), \
        (m01 + m10) / (4.0 * sy + 1e-30)
    qy_y, qz_y = sy, (m12 + m21) / (4.0 * sy + 1e-30)
    sz = torch.sqrt(torch.clamp_min(1.0 - m00 - m11 + m22, 1e-12)) * 0.5
    qw_z, qx_z = (m10 - m01) / (4.0 * sz + 1e-30), \
        (m02 + m20) / (4.0 * sz + 1e-30)
    qy_z, qz_z = (m12 + m21) / (4.0 * sz + 1e-30), sz

    cands = torch.stack([
        torch.stack([qw_w, qx_w, qy_w, qz_w], -1),
        torch.stack([qw_x, qx_x, qy_x, qz_x], -1),
        torch.stack([qw_y, qx_y, qy_y, qz_y], -1),
        torch.stack([qw_z, qx_z, qy_z, qz_z], -1),
    ], -2)                                                     # [..., 4, 4]
    scores = torch.stack([tr, m00, m11, m22], -1)              # [..., 4]
    pick = torch.nn.functional.one_hot(torch.argmax(scores, -1), 4).to(
        R.dtype)
    q = torch.einsum("...c,...cq->...q", pick, cands)
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-30)


def _project_so(M, d: int):
    """Closest rotation to each ``d x d`` matrix (Frobenius)."""
    if d == 2:
        # argmax_theta <M, R(theta)> -> theta = atan2(m10-m01, m00+m11).
        th = torch.atan2(M[..., 1, 0] - M[..., 0, 1],
                         M[..., 0, 0] + M[..., 1, 1])
        return _so2_from_theta(th), th
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    S = torch.cat([torch.ones(M.shape[:-2] + (2,), dtype=M.dtype,
                              device=M.device), det[..., None]], -1)
    R = (U * S[..., None, :]) @ Vt
    return R, None


def make_chordal_init(group_name: str, cg_iters: int = 300,
                      cg_rtol: float = 1e-7, axis_name=None, mesh=None):
    """Build ``init(G0, ea, eb, z, w) -> G_init`` for the given group
    ("SE2"/"SE3").  Shapes as in the PGO solver; ``w == 0`` rows are
    padding.  Nodes touched by no edge keep their ``G0`` values.  The
    optional ``incidence`` (an :class:`EdgeIncidence` of the edges; built
    from ``ea``/``eb`` when omitted) and ``reads`` (a :class:`HostReads`
    that counts the CG loops' host reads) come from the caller's solve.
    With ``axis_name`` the edges are this rank's shard of ``mesh`` (the
    world when None) and the sums over edges are all-reduced."""
    d = 2 if group_name == "SE2" else 3
    ridge = 1e-6
    group = axis_group(axis_name, mesh)

    def rotmats(G):
        if group_name == "SE2":
            return _so2_from_theta(G[..., 2])
        return quat_to_matrix(G[..., 3:])

    def init(G0, ea, eb, z, w, incidence=None, reads=None):
        K = G0.shape[0]
        inc = incidence if incidence is not None else EdgeIncidence(
            ea.cpu().numpy(), eb.cpu().numpy(), K, ea.shape[0], G0.device)
        reads = reads if reads is not None else HostReads()
        R0 = rotmats(G0)                                        # [K, d, d]
        Rz = rotmats(z)                                         # [E, d, d]
        t0 = G0[..., :d]                                        # [K, d]
        tz = z[..., :d]                                         # [E, d]
        w_sum, w_count = all_reduce_packed(
            (torch.sum(w), torch.sum(w > 0).to(w.dtype)), group)
        w_mean = w_sum / torch.clamp_min(w_count, 1.0)
        anchor = torch.zeros((K,), dtype=G0.dtype, device=G0.device)
        anchor[0] = w_mean                                      # gauge
        pull = anchor + ridge

        # Degree (for the Jacobi preconditioner): per-node sum of incident
        # edge weights + anchor + Tikhonov ridge.
        deg = psum(inc.sum(w, w), group) + anchor + ridge

        # ---- Stage 1: rotation averaging ----------------------------------
        # min sum_e w ||M_a Rz_e - M_b||^2 + anchor ||M_0 - R0_0||^2
        #   + ridge ||M - R0||^2   (the ridge keeps untouched nodes at R0).
        def Hv_rot(M):
            u = (M[ea] @ Rz - M[eb]) * w[:, None, None]
            return psum(inc.sum(u @ Rz.transpose(-1, -2), -u), group) \
                + pull[:, None, None] * M

        dinv = 1.0 / deg
        M, _ = pcg(Hv_rot, lambda r: dinv[:, None, None] * r,
                   pull[:, None, None] * R0, R0, cg_iters, cg_rtol, reads)
        R, th = _project_so(M, d)

        # ---- Stage 2: linear translation recovery -------------------------
        # min sum_e w ||t_b - t_a - R_a tz_e||^2 + anchor + ridge-to-t0.
        b_e = (R[ea] @ tz[..., None])[..., 0] * w[:, None]      # [E, d]

        def Hv_t(t):
            u = (t[eb] - t[ea]) * w[:, None]
            return psum(inc.sum(-u, u), group) + pull[:, None] * t

        rhs_t = psum(inc.sum(-b_e, b_e), group) + pull[:, None] * t0
        t, _ = pcg(Hv_t, lambda r: dinv[:, None] * r, rhs_t, t0, cg_iters,
                   cg_rtol, reads)

        if group_name == "SE2":
            return torch.cat([t, th[:, None]], dim=-1)
        return torch.cat([t, _matrix_to_quat(R)], dim=-1)

    return init
