"""Loop-closure edge bootstrap — a copy of :mod:`srba_tpu.engine.closure`
(host numpy, framework-free): measurement-based initialization of closure
edges.

A loop-closure edge connects the new keyframe to an area center last seen a
full loop ago; every *estimate* of that relative pose (dead reckoning, the
incrementally optimized spanning tree) carries the loop's accumulated
drift, which can put the seed far outside the basin of the local
reprojection LM.  The fix is what a SLAM front-end does: estimate the
closure transform from the *re-observed landmarks themselves*, which is
drift-free.  For models with a single-view inverse sensor model
(range-bearing, Cartesian, stereo): invert the new keyframe's observations
into points in the new frame, rigidly align them (Kabsch, closed form) to
the landmarks' current positions composed into the center frame, polish the
fit in observation space by damped Gauss-Newton, and gate it on its
predicted pose sigma.

The monocular branch (multi-start PnP, ``_mono_pnp`` of the JAX package)
needs ``MonocularCamera`` and comes with it; until then it raises by name.

Host-side numpy by design: a closure fires about once per submap revisit
with a handful of correspondences — tiny, latency-sensitive work that a
device launch would only slow down.  The fits read the engine's host mirror
of float32 state, so a fit whose gate value sits at a threshold can land on
either side in the two packages (a gate tie); the parity tests use
scenarios whose gates are decisive.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from srba_tpu_torch.ops.np_lie import compose_path, quat_from_matrix


def _kabsch(P: np.ndarray, Q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Rigid fit Q ~= R P + t (rows are points, any dim)."""
    mu_p, mu_q = P.mean(0), Q.mean(0)
    H = (P - mu_p).T @ (Q - mu_q)
    U, _, Vt = np.linalg.svd(H)
    d = P.shape[1]
    S = np.eye(d)
    if np.linalg.det(Vt.T @ U.T) < 0:
        S[-1, -1] = -1.0
    R = Vt.T @ S @ U.T
    return R, mu_q - R @ mu_p


def _se2_from_rt(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    return np.asarray([t[0], t[1], np.arctan2(R[1, 0], R[0, 0])], np.float32)


def _se3_from_rt(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Rotation matrix + translation -> (t, quat w-first) 7-vector."""
    return np.concatenate([t, quat_from_matrix(R)]).astype(np.float32)


def _voter_points_in_center(engine, center: int,
                            voters: List[Tuple[int, np.ndarray]]
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Voter landmark positions composed into the CENTER keyframe's frame
    (current estimates; the host mirror must be fresh enough)."""
    st = engine.state
    g = engine.np_group
    depth = engine.parameters.max_tree_depth
    pts, zs = [], []
    for lm, z in voters:
        base = int(st.lm_base[lm])
        if base == center:
            T_cb = None
        else:
            path = engine.graph.path(center, base, depth)
            if path is None:
                continue
            T_cb = compose_path(g, st.k2k_pose, path)
        p = st.lm_state[lm]
        if T_cb is not None:
            p = g.apply(T_cb, p)
        pts.append(np.asarray(p, np.float64))
        zs.append(np.asarray(z, np.float64))
    if not pts:
        return np.zeros((0, st.lm_dim)), np.zeros((0, st.z_dim))
    return np.stack(pts), np.stack(zs)


def _obs_residual_fn(engine, P: np.ndarray, Z: np.ndarray):
    """BATCHED observation-space residual of the closure transform: maps
    center-frame voter points P [M, d] through T (=T_new<-center,
    ``[..., pose_dim]``) and the sensor mounting pose, predicts with the
    model's ``h``, subtracts Z.  Returns ``[..., M * z_dim]``.

    Observation space is the statistically right fit metric: a point
    distance fit (Kabsch) weights the stereo depth direction, whose error
    grows as z^2, equally with the pixel-accurate bearings."""
    model, g = engine.model, engine.np_group
    calib = engine._calib_np
    spinv = engine._sensor_pose_inv.astype(np.float64)
    use_sp = engine._use_sensor_pose
    is_cam = calib is not None

    def residual(T):
        T = np.asarray(T, np.float64)
        q = g.apply(T[..., None, :], P)          # [..., M, d] new-KF frame
        s = g.apply(spinv, q) if use_sp else q   # sensor frame
        pred = np.asarray(model.h(s, calib), np.float64)
        r = pred - Z
        if is_cam:
            # Points behind the camera: saturate (keeps FD finite, repels
            # fits that tunnel through the image plane).
            r = np.where(s[..., 2:3] <= 1e-3, 1e3, r)
        return r.reshape(T.shape[:-1] + (-1,))

    return residual


def _gn_solve_batched(g, residual, T0, dof: int, iters: int = 25
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Damped Gauss-Newton on a BATCH of starts simultaneously, with a
    batched finite-difference Jacobian (one vectorized residual call per
    iteration and tangent dim).

    ``T0`` is [B, pose_dim]; returns ``(T [B, pose_dim], rms [B],
    JtJ [B, dof, dof])`` with JtJ from the final linearization (the
    observability/covariance estimate used for gating)."""
    T = np.asarray(T0, np.float64)
    B = T.shape[0]
    lam = np.full(B, 1e-2)
    r = residual(T)                                        # [B, R]
    R = r.shape[-1]
    err = np.einsum("br,br->b", r, r)
    eye = np.eye(dof)
    eps = 1e-5
    JtJ = np.zeros((B, dof, dof))
    stall = 0
    for _ in range(iters):
        J = np.stack(
            [(residual(g.retract(T, eps * eye[d])) - r) / eps
             for d in range(dof)], axis=-1)                # [B, R, dof]
        JtJ = np.einsum("brd,bre->bde", J, J)
        gvec = np.einsum("brd,br->bd", J, r)
        Hd = JtJ + lam[:, None, None] * eye[None]
        try:
            delta = -np.linalg.solve(Hd, gvec[..., None])[..., 0]
        except np.linalg.LinAlgError:
            break
        T_new = g.retract(T, delta)
        r_new = residual(T_new)
        err_new = np.einsum("br,br->b", r_new, r_new)
        acc = err_new < err                                # NaN -> False
        T = np.where(acc[:, None], T_new, T)
        r = np.where(acc[:, None], r_new, r)
        err = np.where(acc, err_new, err)
        lam = np.where(acc, np.maximum(lam * 0.3, 1e-8),
                       np.minimum(lam * 10.0, 1e6))
        if float(err.min()) / max(R, 1) < 1e-8:
            break                    # best start is at machine noise
        stall = 0 if acc.any() else stall + 1
        if stall >= 3:
            break                    # every start is at its local optimum
    return T, np.sqrt(err / max(R, 1)), JtJ


def _gn_solve(g, residual, T0, dof: int, iters: int = 25
              ) -> Tuple[np.ndarray, float, np.ndarray]:
    """Single-start wrapper over :func:`_gn_solve_batched`."""
    T, rms, JtJ = _gn_solve_batched(
        g, residual, np.asarray(T0, np.float64)[None], dof, iters)
    return T[0], float(rms[0]), JtJ[0]


def _fit_sigma(rms: float, JtJ: np.ndarray, obs_sigma: float = 1.0) -> float:
    """Predicted worst-direction pose sigma of a closure fit: residual
    scale over the square root of JtJ's smallest eigenvalue.  Large either
    when the fit is bad (rms) or when the voter geometry leaves the pose
    underdetermined (clustered voters -> near-singular JtJ) — both cases
    must DEFER the closure rather than insert a poisoned edge."""
    w = np.linalg.eigvalsh(JtJ)
    lam_min = max(float(w[0]), 1e-12)
    return max(rms, obs_sigma) / np.sqrt(lam_min)


def bootstrap_closure_edge(engine, center: int,
                           voters: List[Tuple[int, np.ndarray]],
                           seed: np.ndarray):
    """Estimate the closure edge ``T_new<-center`` from the re-observed
    landmarks.  Returns ``(status, T, gate_ratio, sigma, info)`` — ``info``
    is the fit's full [dof, dof] JtJ (None when no fit ran), carried into
    ``state.k2k_info`` for the global PGO export.  Status:

    * ``"ok"``     — STRONG fit (``sigma <= closure_max_sigma``): create the
      edge now;
    * ``"weak"``   — valid fit with sigma in ``(closure_max_sigma,
      closure_max_sigma * closure_accept_sigma_factor]``: the engine caches
      the best weak fit per area and materializes it only if no strong fit
      arrives first;
    * ``"reject"`` — sigma beyond the weak cap: DEFER (the ECP re-votes on
      later frames);
    * ``"n/a"``    — not applicable (too few usable correspondences,
      collinear voters, pose-landmark mode): the caller falls back to an
      estimate-based seed.

    ``gate_ratio`` is the fit's worst gate value over its (strong)
    threshold; the engine re-verifies non-far fits against an exact mirror.
    ``seed`` serves the monocular fit only (not ported yet).
    """
    model = engine.model
    if model.is_pose_landmark:
        return "n/a", None, np.inf, np.inf, None
    if model.name == "MonocularCamera":
        raise NotImplementedError(
            "the monocular closure fit (_mono_pnp) is not ported to "
            "srba_tpu_torch yet")
    if not model.has_inverse_model:
        return "n/a", None, np.inf, np.inf, None
    P, Z = _voter_points_in_center(engine, center, voters)
    d = engine.lm_type.dim
    dof = engine.group.dof
    max_sigma = engine.parameters.closure_max_sigma
    factor = engine.parameters.closure_accept_sigma_factor

    if P.shape[0] < (2 if d == 2 else 3):
        return "n/a", None, np.inf, np.inf, None
    # Measured points in the NEW keyframe's robot frame.
    pts_new = np.asarray(model.inverse(Z.astype(np.float32),
                                       engine._calib_np), np.float64)
    if engine._use_sensor_pose:
        pts_new = engine.np_group.apply(
            engine._sensor_pose.astype(np.float64), pts_new)
    # Collinearity guard: Kabsch needs spatial extent.
    if np.linalg.matrix_rank(P - P.mean(0), tol=1e-6) < min(d, 2):
        return "n/a", None, np.inf, np.inf, None
    R, t = _kabsch(P, pts_new)      # p_new ~= R p_center + t = T (+) p
    T = _se2_from_rt(R, t) if d == 2 else _se3_from_rt(R, t)
    # Kabsch is only the initial basin: polish in observation space, then
    # gate on the fit's predicted pose sigma.
    residual = _obs_residual_fn(engine, P.astype(np.float64),
                                Z.astype(np.float64))
    T, rms, JtJ = _gn_solve(engine.np_group, residual,
                            np.asarray(T, np.float64), dof)
    sigma = _fit_sigma(rms, JtJ)
    # Accept policy (the inverse-model fits have no pixel gate).
    ratio = 0.0 if max_sigma is None else sigma / max_sigma
    if max_sigma is None or sigma <= max_sigma:
        status = "ok"
    elif sigma <= max_sigma * factor:
        status = "weak"
    else:
        return "reject", None, ratio, sigma, None
    return status, T.astype(np.float32), ratio, sigma, JtJ.astype(np.float32)
