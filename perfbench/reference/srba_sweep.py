"""Plain reference of one map-parallel refinement call (``refine_map``) of a
relative-coordinates stereo SLAM map, in plain PyTorch.

It takes a map (the edge list with its poses and measurement priors, the
landmarks with their base keyframes, and the observations) and does, on
its own, what one sweep does:

* the sweep roots (every ``stride``-th keyframe, two red-black phases);
* each root's window: the keyframes within ``depth`` hops (breadth-first in
  edge order), the edges with both ends inside, the landmarks observed from
  inside, at most ``obs_cap`` of each landmark's latest observations from
  inside, each observation's spanning-tree path of at most ``tree_depth``
  edges from its keyframe to its landmark's base keyframe;
* ownership: an unknown belongs to the first window of a phase that holds
  it; a window that owns nothing is left out;
* each window's Levenberg-Marquardt solve over the unknowns it owns (the
  others fixed), all windows of a phase from the map as the phase found it:
  whitened stereo reprojection errors plus each owned edge's prior
  ``w * prior_scale * |plog(prior^-1 o edge)|^2``; Jacobians of the
  reprojection by autograd, the landmarks eliminated by a Schur complement
  and the reduced system solved by Cholesky; lambda 1e-4, x0.1 on accept,
  x10 on reject, a stop on an accepted step that improves the error by less
  than ``rel_tol``, on six rejects in a row or after ``max_iters`` steps.

Poses are kept as rotation matrices and translations and composed with
matrix products; the control computes every one of them in TF32
(:func:`make_mm`).  The module imports
only numpy and torch.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import List

import numpy as np
import torch


@dataclass
class SweepProblem:
    num_kfs: int
    edge_from: np.ndarray     # [E] int
    edge_to: np.ndarray       # [E] int
    prior: np.ndarray         # [E, 7] prior pose per edge
    prior_w: np.ndarray       # [E] prior weight per edge
    lm_base: np.ndarray       # [L] base keyframe per landmark
    lm_fixed: np.ndarray      # [L] bool
    obs_kf: np.ndarray        # [n] observing keyframe, in ingest order
    obs_lm: np.ndarray        # [n] landmark (dense index)
    obs_z: np.ndarray         # [n, 4]
    calib: tuple              # (fx, fy, cx, cy, baseline)
    sensor_pose: np.ndarray   # [7] T_robot<-camera
    sigma_px: float
    stride: int
    depth: int
    tree_depth: int
    obs_cap: int
    prior_scale: float
    max_iters: int = 20
    lam0: float = 1e-4
    rel_tol: float = 1e-6
    max_consec_rejects: int = 6
    diag_floor: float = 1e-8


@dataclass
class Window:
    phase: int
    root: int
    rows: np.ndarray          # [R] observation ids
    path_edge: np.ndarray     # [R, D] edge ids, -1 unused
    path_sign: np.ndarray     # [R, D] +1 / -1 / 0
    own_edges: np.ndarray     # [nE] edge ids this window optimizes
    own_lms: np.ndarray       # [nL] landmarks this window optimizes


# ---------------------------------------------------------------- geometry

def tf32_round(x):
    """``x`` rounded to TF32 (10 mantissa bits, to nearest, ties to even):
    what a TF32 product reads of a float32 operand."""
    if x.dtype != torch.float32:
        return x
    i = x.detach().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -8192
    # The rounded value, with the gradient of x (autograd Jacobians).
    return x + (i.view(torch.float32) - x).detach()


def make_mm(tf32: bool):
    """The matrix product of a reference: float32 with float32 operands,
    or, for the control, TF32 (each operand rounded to TF32, the sum kept
    in float32), whichever kernel the product runs on."""
    if not tf32:
        return torch.matmul
    return lambda a, b: torch.matmul(tf32_round(a), tf32_round(b))


def quat_to_rot(q):
    w, x, y, z = q.unbind(-1)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        dim=-1)
    return r.reshape(r.shape[:-1] + (3, 3))


def hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([z, -w[..., 2], w[..., 1], w[..., 2], z, -w[..., 0],
                        -w[..., 1], w[..., 0], z], dim=-1).reshape(
                            w.shape[:-1] + (3, 3))


def so3_exp(w):
    """Rodrigues, safe at zero."""
    th2 = torch.sum(w * w, dim=-1)[..., None, None]
    th = torch.sqrt(th2)
    small = th2 < 1e-10
    ths = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(ths) / ths)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(ths)) / (ths * ths))
    K = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * K + b * (K @ K)


def so3_log(R):
    """Rotation vector of R (angle below pi)."""
    v = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2],
                           R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    s = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    c = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0)[..., None]
    th = torch.atan2(s, c)
    small = s < 1e-6
    k = torch.where(small, 1.0 + th * th / 6.0,
                    th / torch.where(small, torch.ones_like(s), s))
    return k * v


def so3_jr_inv(phi):
    th2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    th = torch.sqrt(th2)
    small = th2 < 1e-8
    ths = torch.where(small, torch.ones_like(th), th)
    c = torch.where(small, 1.0 / 12.0 + th2 / 720.0,
                    1.0 / (ths * ths)
                    - (1.0 + torch.cos(ths)) / (2.0 * ths * torch.sin(ths)))
    K = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + 0.5 * K + c * (K @ K)


# ------------------------------------------------------------------- graph

def _adjacency(p: SweepProblem):
    adj: List[list] = [[] for _ in range(p.num_kfs)]
    for e, (a, b) in enumerate(zip(p.edge_from.tolist(),
                                   p.edge_to.tolist())):
        adj[a].append((b, e))
        adj[b].append((a, e))
    return adj


def _bfs(adj, root, depth):
    dist, parent = {root: 0}, {}
    q = deque([root])
    while q:
        n = q.popleft()
        if dist[n] >= depth:
            continue
        for nb, e in adj[n]:
            if nb not in dist:
                dist[nb] = dist[n] + 1
                parent[nb] = (n, e)
                q.append(nb)
    return dist, parent


def plan_windows(p: SweepProblem) -> List[Window]:
    """The windows of both phases of one sweep, with their ownership."""
    adj = _adjacency(p)
    kf_obs: List[list] = [[] for _ in range(p.num_kfs)]
    lm_obs: List[list] = [[] for _ in range(p.lm_base.shape[0])]
    for o, (k, l) in enumerate(zip(p.obs_kf.tolist(), p.obs_lm.tolist())):
        kf_obs[k].append(o)
        lm_obs[l].append(o)
    ef, et = p.edge_from.tolist(), p.edge_to.tolist()
    trees = {}

    def tree(src):
        if src not in trees:
            trees[src] = _bfs(adj, src, p.tree_depth)
        return trees[src]

    roots = list(range(0, p.num_kfs, p.stride))
    out = []
    for phase in (0, 1):
        claimed_e, claimed_l = set(), set()
        for root in roots[phase::2]:
            inside = set(_bfs(adj, root, p.depth)[0])
            opt_e = [e for e in range(len(ef))
                     if ef[e] in inside and et[e] in inside]
            if not opt_e:
                continue
            lms = sorted({p.obs_lm[o] for k in inside for o in kf_obs[k]})
            rows, pe, ps = [], [], []
            for l in lms:
                obs = [o for o in lm_obs[l] if p.obs_kf[o] in inside]
                for o in obs[-p.obs_cap:]:
                    src, dst = int(p.obs_kf[o]), int(p.lm_base[l])
                    dist, parent = tree(src)
                    if dst not in dist:
                        continue
                    steps, n = [], dst
                    while n != src:
                        par, e = parent[n]
                        steps.append((e, 1 if ef[e] == par else -1))
                        n = par
                    steps.reverse()
                    rows.append(o)
                    pe.append([e for e, _ in steps]
                              + [-1] * (p.tree_depth - len(steps)))
                    ps.append([s for _, s in steps]
                              + [0] * (p.tree_depth - len(steps)))
            if not rows:
                continue
            row_lms = sorted({int(p.obs_lm[o]) for o in rows})
            own_e = [e for e in opt_e if e not in claimed_e]
            own_l = [l for l in row_lms
                     if not p.lm_fixed[l] and l not in claimed_l]
            if not own_e and not own_l:
                continue
            claimed_e.update(own_e)
            claimed_l.update(own_l)
            out.append(Window(phase, root, np.asarray(rows, np.int64),
                              np.asarray(pe, np.int64),
                              np.asarray(ps, np.int64),
                              np.asarray(own_e, np.int64),
                              np.asarray(own_l, np.int64)))
    return out


# ------------------------------------------------------------------ solver

def _segment_sum(index, values, n):
    """Rows of ``values`` summed by ``index`` into ``n`` rows, in an order
    that is the same on every run (an accumulating ``index_put_`` sorts;
    ``index_add_`` adds atomically on the card, in no fixed order)."""
    out = torch.zeros((n,) + values.shape[1:], dtype=values.dtype,
                      device=values.device)
    return out.index_put_((index,), values, accumulate=True)


class MapState:
    """Edge poses as (t, R) and landmark positions, on one device."""

    def __init__(self, t, R, lm):
        self.t, self.R, self.lm = t, R, lm

    @staticmethod
    def from_arrays(edges7, lms, dtype, device):
        e = torch.as_tensor(np.asarray(edges7, np.float64), dtype=dtype,
                            device=device)
        return MapState(e[:, :3].contiguous(), quat_to_rot(e[:, 3:]),
                        torch.as_tensor(np.asarray(lms, np.float64),
                                        dtype=dtype, device=device))

    def clone(self):
        return MapState(self.t.clone(), self.R.clone(), self.lm.clone())

    def to(self, dtype):
        return MapState(self.t.to(dtype), self.R.to(dtype),
                        self.lm.to(dtype))


class WindowSolver:
    """One window's residuals, normal equations and LM solve."""

    def __init__(self, p: SweepProblem, w: Window, device,
                 tf32: bool = False):
        self.p, self.w, self.dev = p, w, device
        self.mm = make_mm(tf32)
        dev = device
        self.rows_lm = torch.as_tensor(p.obs_lm[w.rows], device=dev)
        self.z = torch.as_tensor(p.obs_z[w.rows], device=dev)
        self.pe = torch.as_tensor(w.path_edge, device=dev)
        self.ps = torch.as_tensor(w.path_sign, device=dev)
        e_index = -np.ones(len(p.edge_from), np.int64)
        e_index[w.own_edges] = np.arange(len(w.own_edges))
        l_index = -np.ones(len(p.lm_base), np.int64)
        l_index[w.own_lms] = np.arange(len(w.own_lms))
        pe = np.where(w.path_edge >= 0, w.path_edge, 0)
        slot = np.where(w.path_edge >= 0, e_index[pe], -1)
        self.slot_own = torch.as_tensor(slot, device=dev)       # [R, D]
        self.lm_own = torch.as_tensor(l_index[p.obs_lm[w.rows]], device=dev)
        self.own_e = torch.as_tensor(w.own_edges, device=dev)
        self.own_l = torch.as_tensor(w.own_lms, device=dev)
        pw = p.prior_w[w.own_edges] * p.prior_scale
        self.has_prior = bool(np.any(pw > 0))
        self.prior_w = torch.as_tensor(pw, device=dev)
        self.prior = torch.as_tensor(
            np.asarray(p.prior[w.own_edges], np.float64), device=dev)
        sp = torch.as_tensor(np.asarray(p.sensor_pose, np.float64),
                             device=dev)
        self._sp = sp

    # -- residuals --------------------------------------------------------

    def _consts(self, dt):
        sp = self._sp.to(dt)
        Rs = quat_to_rot(sp[3:])
        return Rs.transpose(-1, -2), -(self.mm(Rs.transpose(-1, -2), sp[:3]))

    def reprojection(self, st: MapState, dp=None, dl=None):
        """Whitened residuals ``[R, 4]`` of the window's rows; ``dp [R, D,
        6]`` and ``dl [R, 3]`` are first-order tangents at the rows' own
        edges and landmark (for autograd at zero)."""
        p = self.p
        dt = st.t.dtype
        R_n = self.pe.shape[0]
        D = self.pe.shape[1]
        idx = torch.clamp_min(self.pe, 0)
        Re, te = st.R[idx], st.t[idx]                    # [R, D, 3, 3]
        if dp is not None:
            eye = torch.eye(3, dtype=dt, device=Re.device)
            te = te + self.mm(Re, dp[..., :3, None])[..., 0]
            Re = self.mm(Re, eye + hat(dp[..., 3:]))
        sign = self.ps[..., None, None].to(dt)
        Rinv = Re.transpose(-1, -2)
        tinv = -self.mm(Rinv, te[..., None])[..., 0]
        eye = torch.eye(3, dtype=dt, device=Re.device).expand_as(Re)
        Rstep = torch.where(sign > 0.5, Re, torch.where(sign < -0.5, Rinv,
                                                        eye))
        tstep = torch.where(sign[..., 0] > 0.5, te,
                            torch.where(sign[..., 0] < -0.5, tinv,
                                        torch.zeros_like(te)))
        RT = eye[:, 0]
        tT = torch.zeros((R_n, 3), dtype=dt, device=Re.device)
        for k in range(D):
            tT = tT + self.mm(RT, tstep[:, k, :, None])[..., 0]
            RT = self.mm(RT, Rstep[:, k])
        lm = st.lm[self.rows_lm]
        if dl is not None:
            lm = lm + dl
        pt = self.mm(RT, lm[..., None])[..., 0] + tT
        Rsi, tsi = self._consts(dt)
        ps = self.mm(Rsi, pt[..., None])[..., 0] + tsi
        fx, fy, cx, cy, b = p.calib
        iz = 1.0 / torch.clamp_min(ps[:, 2], 1e-4)
        ul = cx + fx * ps[:, 0] * iz
        vl = cy + fy * ps[:, 1] * iz
        ur = cx + fx * (ps[:, 0] - b) * iz
        h = torch.stack([ul, vl, ur, vl], dim=-1)
        return (h - self.z.to(dt)) / p.sigma_px

    def prior_terms(self, st: MapState, jac: bool):
        """Weighted prior residuals ``[nE, 6]`` of the owned edges and, with
        ``jac``, their Jacobians ``[nE, 6, 6]``."""
        dt = st.t.dtype
        pr = self.prior.to(dt)
        Rp = quat_to_rot(pr[:, 3:])
        Re, te = st.R[self.own_e], st.t[self.own_e]
        Rc = self.mm(Rp.transpose(-1, -2), Re)
        tc = self.mm(Rp.transpose(-1, -2),
                     (te - pr[:, :3])[..., None])[..., 0]
        phi = so3_log(Rc)
        sw = torch.sqrt(self.prior_w.to(dt))[:, None]
        r = torch.cat([tc, phi], dim=-1) * sw
        if not jac:
            return r, None
        J = torch.zeros((r.shape[0], 6, 6), dtype=dt, device=r.device)
        J[:, :3, :3] = Rc
        J[:, 3:, 3:] = so3_jr_inv(phi)
        return r, J * sw[..., None]

    def error(self, st: MapState):
        r = self.reprojection(st)
        err = torch.sum(r * r)
        if self.has_prior:
            rp, _ = self.prior_terms(st, False)
            err = err + torch.sum(rp * rp)
        return err

    # -- LM -----------------------------------------------------------------

    def _normal_equations(self, st: MapState):
        R_n, D = self.pe.shape
        dt, dev = st.t.dtype, st.t.device
        nE, nL = self.own_e.shape[0], self.own_l.shape[0]
        dp = torch.zeros((R_n, D, 6), dtype=dt, device=dev,
                         requires_grad=True)
        dl = torch.zeros((R_n, 3), dtype=dt, device=dev, requires_grad=True)
        with torch.enable_grad():
            r = self.reprojection(st, dp, dl)
            Jp, Jl = [], []
            for k in range(4):
                gp, gl = torch.autograd.grad(r[:, k].sum(), (dp, dl),
                                             retain_graph=k < 3)
                Jp.append(gp)
                Jl.append(gl)
        r = r.detach()
        Jp = torch.stack(Jp, dim=1)                      # [R, 4, D, 6]
        Jl = torch.stack(Jl, dim=1)                      # [R, 4, 3]
        # Owned edge columns: a dense [R, 4, nE, 6] block.
        Jd = torch.zeros((R_n, 4, max(nE, 1), 6), dtype=dt, device=dev)
        rows = torch.arange(R_n, device=dev)
        for d in range(D):
            m = self.slot_own[:, d] >= 0
            if bool(m.any()):
                Jd[rows[m], :, self.slot_own[m, d], :] = Jp[m, :, d, :]
        Jd = Jd[:, :, :nE].reshape(R_n, 4, nE * 6)
        Jflat = Jd.reshape(R_n * 4, nE * 6)
        Hpp = self.mm(Jflat.T, Jflat)
        gp = self.mm(Jflat.T, r.reshape(-1))
        lmask = (self.lm_own >= 0).to(dt)[:, None, None]
        Jl = Jl * lmask
        li = torch.clamp_min(self.lm_own, 0)
        Hll = _segment_sum(li, self.mm(Jl.transpose(1, 2), Jl), nL)
        gl = _segment_sum(li, self.mm(Jl.transpose(1, 2), r[..., None])[..., 0],
                          nL)
        Hpl = _segment_sum(li, self.mm(Jd.transpose(1, 2), Jl), nL)
        if self.has_prior and nE:
            rp, Jpr = self.prior_terms(st, True)
            blk = self.mm(Jpr.transpose(1, 2), Jpr)
            Hpp = Hpp + torch.block_diag(*blk)
            gp = gp + self.mm(Jpr.transpose(1, 2),
                              rp[..., None])[..., 0].reshape(-1)
        return Hpp, gp, Hll, gl, Hpl

    def _step(self, st: MapState, lam):
        p = self.p
        Hpp, gp, Hll, gl, Hpl = self._normal_equations(st)
        nE, nL = self.own_e.shape[0], self.own_l.shape[0]
        dt, dev = st.t.dtype, st.t.device
        eye3 = torch.eye(3, dtype=dt, device=dev)
        Hll_d = Hll + eye3 * (lam * torch.diagonal(Hll, dim1=-2, dim2=-1)
                              + p.diag_floor)[..., None, :]
        Hinv = torch.linalg.inv(Hll_d)
        Hpp_d = Hpp + torch.diag(lam * torch.diagonal(Hpp) + p.diag_floor)
        if nE:
            WH = self.mm(Hpl, Hinv)                          # [nL, P, 3]
            S = Hpp_d - self.mm(WH.permute(1, 0, 2).reshape(nE * 6, -1),
                               Hpl.permute(0, 2, 1).reshape(-1, nE * 6))
            rhs = -gp + self.mm(WH, gl[..., None])[..., 0].sum(0)
            L, info = torch.linalg.cholesky_ex(S)
            if int(info) != 0:
                return None
            dpv = torch.cholesky_solve(rhs[:, None], L)[:, 0]
            dlv = self.mm(Hinv, (-gl - self.mm(Hpl.transpose(1, 2), dpv)
                                 )[..., None])[..., 0]
        else:
            dpv = torch.zeros((0,), dtype=dt, device=dev)
            dlv = self.mm(Hinv, (-gl)[..., None])[..., 0]
        return dpv.reshape(nE, 6), dlv

    def _retract(self, st: MapState, dpv, dlv):
        new = st.clone()
        if dpv.shape[0]:
            Re, te = st.R[self.own_e], st.t[self.own_e]
            new.t[self.own_e] = te + self.mm(Re, dpv[:, :3, None])[..., 0]
            new.R[self.own_e] = self.mm(Re, so3_exp(dpv[:, 3:]))
        if dlv.shape[0]:
            new.lm[self.own_l] = st.lm[self.own_l] + dlv
        return new

    def solve(self, st: MapState) -> MapState:
        p = self.p
        err = float(self.error(st))
        lam, rej = p.lam0, 0
        for _ in range(p.max_iters):
            step = self._step(st, lam)
            if step is None:
                err_new = float("nan")
            else:
                cand = self._retract(st, *step)
                err_new = float(self.error(cand))
            accept = np.isfinite(err_new) and err_new < err
            if accept:
                lam = max(lam * 0.1, 1e-10)
                improved = (err - err_new) > p.rel_tol * (err + 1e-12)
                st, err, rej = cand, err_new, 0
                if not improved:
                    break
            else:
                lam = min(lam * 10.0, 1e8)
                rej += 1
                if rej >= p.max_consec_rejects:
                    break
            if err <= 1e-12:
                break
        return st


def sweep(p: SweepProblem, windows: List[Window], st: MapState,
          tf32: bool = False, phases=(0, 1)) -> MapState:
    """One ``refine_map(sweeps=1)`` call from ``st`` (not modified); with
    ``tf32`` every matrix product in TF32.  ``phases`` and the ``windows``
    given choose what is solved (the planted faults leave some out)."""
    for phase in phases:
        base = st
        st = base.clone()
        for w in windows:
            if w.phase != phase:
                continue
            out = WindowSolver(p, w, base.t.device, tf32).solve(base)
            st.t[w.own_edges] = out.t[w.own_edges]
            st.R[w.own_edges] = out.R[w.own_edges]
            st.lm[w.own_lms] = out.lm[w.own_lms]
    return st


def window_errors(p: SweepProblem, windows: List[Window], st: MapState):
    """Each window's objective at ``st`` (its dtype), as a numpy array."""
    with torch.no_grad():
        return np.asarray([float(WindowSolver(p, w, st.t.device).error(st))
                           for w in windows])
