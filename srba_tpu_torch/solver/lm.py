"""Levenberg-Marquardt with Schur-complement landmark marginalization — the
port of :mod:`srba_tpu.solver.lm` to torch.

Same design as the JAX package (see its module docstring): each observation
gathers its padded (<= depth-D) spanning-tree path of edge poses, composes
them, and forward-mode AD at delta = 0 gives the exact Jacobian with respect
to every path edge's tangent and the landmark; the pose Jacobian is
scattered into a dense ``[N*od, E*pdof]`` window Jacobian by a one-hot
contraction; landmark blocks stay batched ``[L, ldof, ldof]`` and are
inverted by :func:`srba_tpu_torch.ops.block_linalg.spd_inverse` (the CUDA
kernel on the card); the reduced camera system is solved by a
Jacobi-equilibrated dense Cholesky.

What differs from the JAX package, and why:

* Jacobians: forward mode written out by hand (the ``*_jvp`` functions of
  the group, landmark and observation model), batched over observations
  with one tangent direction per column of J — what ``jacfwd`` under
  ``vmap`` computes in the JAX package (see :mod:`srba_tpu_torch.ops.lie`
  for why not ``torch.func``).
* Segment sums over ``obs_lm`` (duplicate indices) are one-hot matmuls, not
  ``index_add_``: on CUDA ``index_add_`` sums duplicates with atomics in an
  order that changes from run to run, while a matmul of fixed shape is
  bitwise reproducible.  (The JAX package's own pose-side reduction is the
  same one-hot contraction.)  The segmented normal equations
  (``neq="segmented"``, three ``segment_sum``s keyed by path-edge indices
  in the JAX package) sort their keys once per solve (a stable sort) and
  then sum each segment's rows in that fixed order
  (:func:`segment_plan`, :func:`segment_sum`), so reruns are bitwise equal
  with no process-wide determinism switch.
* The LM loop runs exactly ``min(iters_cap, max_iters)`` trips, a number the
  host knows, and freezes the state with a device-side ``done`` mask:
  nothing is read back from the device, and the final state, ``iters`` and
  ``lam`` equal those of the JAX package's ``lax.while_loop``.  A rejected
  trip rebuilds the normal equations instead of reusing them; they are
  bitwise identical because the state did not move.
* ``torch.linalg.cholesky`` raises on a non-SPD matrix where JAX's
  ``cho_factor`` yields NaN; ``cholesky_ex`` with ``info != 0`` turned into
  a NaN solution keeps the LM loop's reject-on-non-finite path.
* Precision: every product is true f32.  The port never enables TF32
  (``torch.backends.cuda.matmul.allow_tf32`` stays False), the analog of
  the JAX package's ``default_matmul_precision("highest")`` pin.
* Masking uses ``torch.where``, never a multiply, wherever a padded row
  could carry a NaN into a sum.
* Observation sharding (``SolverConfig.axis_name``): the batch's
  observation tables are this rank's shard of a mesh
  (:mod:`srba_tpu_torch.parallel.sharding`); the partial normal equations
  ``(Hp, gp, Hf, gf, Hpf)`` are summed over the ranks in ONE
  ``dist.all_reduce`` round per LM iteration (the JAX package's
  ``_psum_packed``) and the error sum in one more, each before the
  replicated edge priors are added; the reduced system is solved whole on
  every rank.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from srba_tpu_torch.models.landmarks import LANDMARK_TYPES
from srba_tpu_torch.models.observations import OBSERVATION_MODELS
from srba_tpu_torch.ops.block_linalg import spd_inverse
from srba_tpu_torch.ops.lie import GROUPS
from srba_tpu_torch.ops.robust import pseudo_huber_cost, pseudo_huber_weight
from srba_tpu_torch.utils.collectives import (all_reduce_packed,
                                              axis_group, psum)
from srba_tpu_torch.utils.device import resolve_device
from srba_tpu_torch.utils.registry import lookup


@dataclass
class WindowBatch:
    """Padded, fixed-shape device view of one optimization window (same
    fields as the JAX package's ``WindowBatch``)."""

    edge_pose: torch.Tensor   # [E, pose_dim] involved kf2kf edge poses
    edge_opt: torch.Tensor    # [E] 1.0 = unknown in this window, 0.0 = fixed
    lm_state: torch.Tensor    # [L, lm_dim]
    lm_opt: torch.Tensor      # [L] 1.0 = unknown, 0.0 = fixed/pad
    obs_z: torch.Tensor       # [N, z_dim]
    obs_lm: torch.Tensor      # [N] int local landmark index
    path_edge: torch.Tensor   # [N, D] int local edge index (0 on pad steps)
    path_sign: torch.Tensor   # [N, D] +1 fwd / -1 rev / 0 pad
    obs_valid: torch.Tensor   # [N] 1.0 = real observation
    whitener: torch.Tensor    # [od, od] Lambda^{1/2} noise whitening
    sensor_pose_inv: torch.Tensor  # [pose_dim] inverse sensor mounting pose
    # Observation-model calibration with Python-float fields
    # (models.observations.calib_constants), or None.
    calib: Any = None
    # Optional per-edge measurement priors: residual
    # sqrt(w) * plog(inv(prior) o edge) per opt edge.  None = no priors.
    edge_prior: Optional[torch.Tensor] = None     # [E, pose_dim]
    edge_prior_w: Optional[torch.Tensor] = None   # [E] weight (0 = none)
    # Optional iteration cap, a HOST int (None = cfg.max_iters): the loop
    # runs exactly min(iters_cap, max_iters) trips without reading the
    # device (see the module docstring).
    iters_cap: Optional[int] = None

    def to(self, device) -> "WindowBatch":
        """Copy every array field (tensor or numpy, dtype kept) to
        ``device``."""
        return dataclasses.replace(self, **{
            f.name: torch.as_tensor(getattr(self, f.name), device=device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), (torch.Tensor, np.ndarray))})


@dataclass(frozen=True)
class SolverConfig:
    """Static solver specialization (same fields as the JAX package's
    ``SolverConfig``; see there for each knob's rationale)."""

    obs_model: str
    pose_group: str
    lm_type: str
    max_depth: int                 # D: padded spanning-tree path length
    solver: str = "schur_dense_cholesky"   # | "no_schur_dense_cholesky"
    use_sensor_pose: bool = False
    use_robust_kernel: bool = False
    kernel_param: float = 1.0
    max_iters: int = 20
    lam0: float = 1e-4
    lam_up: float = 10.0
    lam_down: float = 0.1
    lam_min: float = 1e-10
    lam_max: float = 1e8
    rel_tol: float = 1e-6
    diag_floor: float = 1e-8
    max_consec_rejects: int = 6
    neq: str = "onehot"            # | "segmented"
    # The mesh axis the observation tables are sharded over (None = one
    # device): sums over observations are all-reduced over it.
    axis_name: Optional[str] = None


PORTED_SOLVERS = {"schur_dense_cholesky": "schur_dense_cholesky",
                  "no_schur_dense_cholesky": "no_schur_dense_cholesky"}
PORTED_NEQ = {"onehot": "onehot", "segmented": "segmented"}


def _resolve(cfg: SolverConfig):
    lookup(PORTED_SOLVERS, cfg.solver, "solver")
    lookup(PORTED_NEQ, cfg.neq, "normal-equation backend (neq)")
    return (lookup(GROUPS, cfg.pose_group, "pose group"),
            lookup(OBSERVATION_MODELS, cfg.obs_model, "observation model"),
            lookup(LANDMARK_TYPES, cfg.lm_type, "landmark type"))


def segment_plan(keys: torch.Tensor, num_segments: int):
    """The fixed order of a segment sum over ``keys`` (any shape, values in
    ``[0, num_segments)``): the stable-sort permutation of the flattened
    keys and the start offset of each segment in it (``num_segments + 1``
    entries).  Built once per solve: the keys are the window's structure,
    which no LM iteration changes."""
    sorted_keys, perm = torch.sort(keys.reshape(-1).to(torch.int64),
                                   stable=True)
    bounds = torch.arange(num_segments + 1, dtype=torch.int64,
                          device=keys.device)
    return perm, torch.searchsorted(sorted_keys, bounds)


def segment_sum(x: torch.Tensor, plan) -> torch.Tensor:
    """Sum of the rows of ``x`` [M, ...] per segment of ``plan``
    (:func:`segment_plan`) -> [num_segments, ...]: ``segment_reduce`` over
    the rows gathered into key order, each segment a contiguous run given
    by the offsets; an empty segment sums to 0.  Unlike ``index_add_`` on
    CUDA floats, whose atomics land in scheduling order, the result does
    not change from run to run (held bitwise on the card by
    ``chip_smoke.py`` phase 17 and ``tests/test_torch_cuda.py``)."""
    perm, offsets = plan
    rows = x.reshape(x.shape[0], -1)[perm]
    out = torch.segment_reduce(rows, "sum", offsets=offsets, axis=0,
                               unsafe=True)
    return out.reshape((offsets.shape[0] - 1,) + tuple(x.shape[1:]))


def segment_plans(path_edge: torch.Tensor, obs_lm: torch.Tensor, E: int,
                  L: int):
    """The segmented backend's three key orders over W windows
    (``path_edge [W, N, D]``, ``obs_lm [W, N]``, indices local to each
    window, keys offset by window): path-edge pairs (W*E*E segments),
    path edges (W*E), and (landmark, path edge) pairs (W*L*E).  One window
    is W = 1, offset 0."""
    W = path_edge.shape[0]
    w = torch.arange(W, dtype=torch.int64, device=path_edge.device)
    pe = path_edge.to(torch.int64)                           # [W, N, D]
    return (
        segment_plan(w[:, None, None, None] * (E * E)
                     + pe[..., :, None] * E + pe[..., None, :], W * E * E),
        segment_plan(w[:, None, None] * E + pe, W * E),
        segment_plan(w[:, None, None] * (L * E)
                     + obs_lm.to(torch.int64)[..., None] * E + pe,
                     W * L * E))


def scaled_chol_solve(H: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Dense Cholesky with symmetric Jacobi equilibration, over any leading
    batch axes: x = S (SHS)^-1 S rhs with S = diag(H)^{-1/2} (see the JAX
    package for why).  A matrix that is not SPD gives a NaN solution (its
    row alone, in a batch), as JAX's cho_factor does, so the LM loop
    rejects the step."""
    s = torch.rsqrt(torch.clamp_min(torch.diagonal(H, dim1=-2, dim2=-1),
                                    1e-20))
    Hs = H * s[..., :, None] * s[..., None, :]
    # upper=True reads the upper triangle, like cho_factor's default.
    U, info = torch.linalg.cholesky_ex(Hs, upper=True)
    x = torch.cholesky_solve((rhs * s)[..., None], U, upper=True)[..., 0]
    return torch.where((info == 0)[..., None], s * x, torch.nan)


def lm_state(cfg: SolverConfig, shape, dtype, device):
    """The LM loop's starting ``(lam, rej, done, it)``, each of ``shape``
    (``()`` for one window, ``(W,)`` for a batch)."""
    return (torch.full(shape, cfg.lam0, dtype=dtype, device=device),
            torch.zeros(shape, dtype=torch.int32, device=device),
            torch.zeros(shape, dtype=torch.bool, device=device),
            torch.zeros(shape, dtype=torch.int32, device=device))


def lm_update(cfg: SolverConfig, err, err_new, lam, rej, done, it):
    """One LM iteration's accept and stop rule, elementwise per window.
    Returns ``(accept, err, lam, rej, done, it)``; the caller keeps the
    candidate state where ``accept``."""
    active = torch.logical_not(done)
    ok = torch.isfinite(err_new)
    accept = active & (err_new < err) & ok
    lam = torch.where(
        active,
        torch.where(accept,
                    torch.clamp_min(lam * cfg.lam_down, cfg.lam_min),
                    torch.clamp_max(lam * cfg.lam_up, cfg.lam_max)),
        lam)
    rej = torch.where(active, torch.where(accept, 0, rej + 1), rej)
    improved = (err - err_new) > cfg.rel_tol * (err + 1e-12)
    converged = accept & torch.logical_not(improved)
    # Stop on: converged accept; repeated rejects; tiny error.
    stop = converged | (rej >= cfg.max_consec_rejects) | (err <= 1e-12)
    done = done | (active & stop)
    err = torch.where(accept, err_new, err)
    it = it + active.to(torch.int32)
    return accept, err, lam, rej, done, it


def make_linearize(cfg: SolverConfig):
    """The residual side of the solver (the counterpart of the JAX
    package's ``_make_per_obs_residual`` under ``vmap``/``jacfwd``).

    Returns ``(linearize, prior_linearize)``:
    ``linearize(edge_pose, lm_state, batch, jac) -> (r [N, od], J)`` gives
    the whitened residual of every observation and, with ``jac``, its
    Jacobian ``J [N, od, D*pdof + ldof]`` with respect to the tangent
    perturbation of the observation's D path edges (column blocks in path
    order) and its landmark, at zero perturbation;
    ``prior_linearize(edge_pose, batch, jac) -> (r [E, pdof], J)`` gives the
    per-edge prior residuals plog(inv(prior) o retract(edge, 0)) and their
    Jacobians [E, pdof, pdof] with respect to the edge tangent.  J is None
    without ``jac``.
    """
    group, model, lmt = _resolve(cfg)
    pdof, ldof = group.dof, lmt.dof
    D = cfg.max_depth
    eps_dim = D * pdof + ldof

    def _linearize(edge_pose, lm_state, b: WindowBatch, jac: bool):
        # Forward mode, one tangent direction per column of J.
        N = b.obs_z.shape[0]
        dt, dev = edge_pose.dtype, edge_pose.device
        ep = edge_pose[b.path_edge]                         # [N, D, pose_dim]
        lm0 = lm_state[b.obs_lm]                            # [N, lm_dim]
        basis = (torch.eye(eps_dim, dtype=dt, device=dev) if jac else None)
        # All D path steps at once: e = retract(edge, 0), its inverse, then
        # the per-step select by the path sign.
        e, de = group.retract_jvp(
            ep, torch.zeros(ep.shape[:-1] + (pdof,), dtype=dt, device=dev),
            None if basis is None
            else basis[: D * pdof].reshape(D, pdof, eps_dim))
        e_inv, de_inv = group.inverse_jvp(e, de)
        sign = b.path_sign[..., None]                       # [N, D, 1]
        ident = group.identity(dt, dev)
        step = torch.where(sign > 0.5, e,
                           torch.where(sign < -0.5, e_inv, ident))
        dstep = None if basis is None else torch.where(
            sign[..., None] > 0.5, de,
            torch.where(sign[..., None] < -0.5, de_inv, 0.0))
        T, dT = ident.expand(N, ident.shape[0]), None
        for k in range(D):  # static unroll: D is small (tree depth)
            T, dT = group.compose_jvp(
                T, step[:, k], dT, None if dstep is None else dstep[:, k])
        lm, dlm = lmt.retract_jvp(
            lm0, torch.zeros((N, ldof), dtype=dt, device=dev),
            None if basis is None else basis[D * pdof:])
        if model.is_pose_landmark:
            # graph-SLAM: compose with the landmark pose, don't project
            pred, dpred = group.compose_jvp(T, lm, dT, dlm)
        else:
            pt, dpt = group.apply_jvp(T, lm, dT, dlm)
            if cfg.use_sensor_pose:
                # Into the sensor frame; the mount is a constant (no
                # tangent of its own).
                pt, dpt = group.apply_jvp(b.sensor_pose_inv, pt, None, dpt)
            if basis is None:
                pred = model.h(pt, b.calib)
            else:
                pred, dpred = model.h_jvp(pt, dpt, b.calib)
        if basis is None:
            r = model.residual(pred, b.obs_z)
            return r @ b.whitener.T, None   # whitener @ r, per observation
        r, dr = model.residual_jvp(pred, b.obs_z, dpred)
        return (r @ b.whitener.T,
                torch.einsum("ij,njk->nik", b.whitener, dr))

    def _prior_linearize(edge_pose, b: WindowBatch, jac: bool):
        E = edge_pose.shape[0]
        dt, dev = edge_pose.dtype, edge_pose.device
        ddelta = (torch.eye(pdof, dtype=dt, device=dev).expand(E, pdof, pdof)
                  if jac else None)
        v, dv = group.retract_jvp(
            edge_pose, torch.zeros((E, pdof), dtype=dt, device=dev), ddelta)
        c, dc = group.compose_jvp(group.inverse(b.edge_prior), v, None, dv)
        return group.plog_jvp(c, dc)

    return _linearize, _prior_linearize


def make_solver_impl(cfg: SolverConfig, mesh=None):
    """Build the LM optimizer for one problem configuration.  It runs on
    whatever device its batch lives on.

    Returns ``(solve, eval_error)`` with
    ``solve(batch) -> (edge_pose, lm_state, info)`` where ``info`` is a dict
    of 0-dim device tensors (``err_init``, ``err_final``, ``iters``,
    ``lam``, ``num_obs``) — nothing is read back to the host.

    With ``cfg.axis_name`` set, the batch's observation tables are this
    rank's shard: the sums over observations are all-reduced over the
    ``axis_name`` dimension of ``mesh`` (the whole world's group when
    ``mesh`` is None), two rounds per LM iteration (normal equations,
    error) plus one for ``err_init`` and one for ``num_obs``, and every rank
    ends with the same result.  :func:`srba_tpu_torch.parallel.sharding.
    make_spmd_solver` shards a full batch and calls this.
    """
    group, _, lmt = _resolve(cfg)
    reduce_group = axis_group(cfg.axis_name, mesh)
    pdof = group.dof
    D = cfg.max_depth
    _linearize, _prior_linearize = make_linearize(cfg)

    def _prior_residuals(edge_pose, b: WindowBatch):
        """Per-edge prior residuals [E, pdof] and their effective weights [E]
        (prior weight x opt mask)."""
        r, _ = _prior_linearize(edge_pose, b, jac=False)
        w = b.edge_prior_w * b.edge_opt
        return torch.where(w[:, None] > 0, r, 0.0), w

    def _error(edge_pose, lm_state, b: WindowBatch):
        r, _ = _linearize(edge_pose, lm_state, b, jac=False)
        # where, not multiply: a NaN residual on a masked (padded) row must
        # not poison the sum.
        r = torch.where(b.obs_valid[:, None] > 0, r, 0.0)
        sq = torch.sum(r * r, dim=-1) * b.obs_valid
        if cfg.use_robust_kernel:
            err = torch.sum(pseudo_huber_cost(sq, cfg.kernel_param)
                            * b.obs_valid)
        else:
            err = torch.sum(sq)
        err = psum(err, reduce_group)
        if b.edge_prior is not None:
            # Every rank holds the whole edge table: the prior cost is added
            # after the sum over ranks, once.
            rp, wp = _prior_residuals(edge_pose, b)
            err = err + torch.sum(torch.sum(rp * rp, dim=-1) * wp)
        return err

    def _segment_plans(b: WindowBatch):
        """The segmented backend's key orders (None for one-hot)."""
        if cfg.neq != "segmented":
            return None
        return segment_plans(b.path_edge[None], b.obs_lm[None],
                             b.edge_pose.shape[0], b.lm_state.shape[0])

    def _build_normal_eqs(edge_pose, lm_state, b: WindowBatch, plans=None):
        N, od = b.obs_z.shape[0], b.whitener.shape[0]
        E, L = b.edge_pose.shape[0], b.lm_state.shape[0]
        P = E * pdof
        dt, dev = edge_pose.dtype, edge_pose.device

        # r [N, od], J [N, od, D*pdof + ldof]
        r, J = _linearize(edge_pose, lm_state, b, jac=True)

        # Mask padded rows with `where` (NaN-proof), then apply the IRLS row
        # scale: robust weight (frozen at linearization) x validity.
        valid = b.obs_valid[:, None] > 0
        r = torch.where(valid, r, 0.0)
        J = torch.where(valid[..., None], J, 0.0)
        sq = torch.sum(r * r, dim=-1)
        w = (pseudo_huber_weight(sq, cfg.kernel_param)
             if cfg.use_robust_kernel else torch.ones_like(sq))
        scale = torch.sqrt(w) * b.obs_valid                    # [N]
        r = r * scale[:, None]
        J = J * scale[:, None, None]

        Jp_blocks = J[..., : D * pdof].reshape(N, od, D, pdof)
        Jl = J[..., D * pdof:]                                 # [N, od, ldof]
        Jl = Jl * b.lm_opt[b.obs_lm][:, None, None]

        # Deterministic segment sum over obs_lm: one-hot [L, N] matmul.
        seg_onehot = (b.obs_lm[None, :] == torch.arange(
            L, device=dev, dtype=b.obs_lm.dtype)[:, None]).to(dt)

        def seg(x):
            return (seg_onehot @ x.reshape(N, -1)).reshape(
                (L,) + tuple(x.shape[1:]))

        Hf = seg(torch.einsum("noi,noj->nij", Jl, Jl))         # [L, l, l]
        gf = seg(torch.einsum("noi,no->ni", Jl, r))            # [L, l]

        if plans is None:
            # Scatter path-edge blocks into the dense window Jacobian with a
            # one-hot contraction.
            onehot = (b.path_edge[..., None] == torch.arange(
                E, device=dev, dtype=b.path_edge.dtype)).to(dt)  # [N, D, E]
            Jp = torch.einsum("nodp,nde->noep", Jp_blocks, onehot)
            Jp = Jp * b.edge_opt[None, None, :, None]
            Jp2 = Jp.reshape(N * od, P)
            Hp = Jp2.T @ Jp2                                   # [P, P]
            gp = Jp2.T @ r.reshape(N * od)                     # [P]
            Hpf = seg(torch.einsum("nop,noi->npi", Jp.reshape(N, od, P),
                                   Jl))
        else:
            # Segmented: per-depth-pair block products reduced by key —
            # never materializes the [N*od, P] dense Jacobian.  Padded path
            # slots carry exactly-zero blocks (their step is the identity
            # whatever the tangent), so their index-0 targets are
            # unaffected.
            plan_pp, plan_e, plan_le = plans
            ldof = Jl.shape[-1]
            emask = b.edge_opt[b.path_edge.to(torch.int64)]     # [N, D]
            Jb = Jp_blocks * emask[:, None, :, None]           # [N,od,D,p]
            Bpp = torch.einsum("nodi,noep->ndeip", Jb, Jb)     # [N,D,D,p,p]
            Hp = segment_sum(Bpp.reshape(N * D * D, pdof, pdof), plan_pp)
            Hp = Hp.reshape(E, E, pdof, pdof).permute(0, 2, 1, 3) \
                .reshape(P, P)
            gb = torch.einsum("nodi,no->ndi", Jb, r)           # [N, D, p]
            gp = segment_sum(gb.reshape(N * D, pdof), plan_e).reshape(P)
            Cpl = torch.einsum("nodi,nol->ndil", Jb, Jl)       # [N,D,p,l]
            Hpf = segment_sum(Cpl.reshape(N * D, pdof, ldof),
                              plan_le).reshape(L, P, ldof)
        # The sum over the ranks' observation shards, in one round.
        Hp, gp, Hf, gf, Hpf = all_reduce_packed((Hp, gp, Hf, gf, Hpf),
                                          reduce_group)

        if b.edge_prior is not None:
            # Edge measurement priors: block-diagonal H += w JtJ, g += w Jtr
            # per opt edge (replicated: added after the sum over ranks).
            rp, Jpr = _prior_linearize(edge_pose, b, jac=True)  # Jpr [E,p,p]
            wp = b.edge_prior_w * b.edge_opt
            rp = torch.where(wp[:, None] > 0, rp, 0.0)
            Jpr = torch.where(wp[:, None, None] > 0, Jpr, 0.0)
            Hblk = wp[:, None, None] * torch.einsum("eij,eik->ejk", Jpr, Jpr)
            gblk = wp[:, None] * torch.einsum("eij,ei->ej", Jpr, rp)
            # Hp is a fresh tensor: add the E diagonal blocks in place.
            Hp.view(E, pdof, E, pdof).diagonal(dim1=0, dim2=2).add_(
                Hblk.permute(1, 2, 0))
            gp = gp + gblk.reshape(P)
        return Hp, gp, Hf, gf, Hpf

    def _solve_delta(Hp, gp, Hf, gf, Hpf, lam, b: WindowBatch):
        epm = torch.repeat_interleave(b.edge_opt, pdof)        # [P]
        diag_p = torch.diagonal(Hp)
        Hp_d = Hp + torch.diag(lam * diag_p + cfg.diag_floor + (1.0 - epm))

        diag_f = torch.diagonal(Hf, dim1=-2, dim2=-1)          # [L, ldof]
        bump = lam * diag_f + cfg.diag_floor + (1.0 - b.lm_opt)[:, None]
        Hf_d = Hf + torch.diag_embed(bump)

        if cfg.solver == "no_schur_dense_cholesky":
            # Full-system dense Cholesky (no landmark marginalization, so no
            # SPD block inverse) — the reference's no-Schur solver engine.
            L, ldof = Hf.shape[0], Hf.shape[-1]
            P, Q = Hp.shape[0], L * ldof
            Hpf_full = Hpf.permute(1, 0, 2).reshape(P, Q)
            Hf_full = torch.zeros((L, ldof, L, ldof), dtype=Hf.dtype,
                                  device=Hf.device)
            Hf_full.diagonal(dim1=0, dim2=2).copy_(Hf_d.permute(1, 2, 0))
            H = torch.cat([torch.cat([Hp_d, Hpf_full], dim=1),
                           torch.cat([Hpf_full.T, Hf_full.reshape(Q, Q)],
                                     dim=1)], dim=0)
            delta = -scaled_chol_solve(H, torch.cat([gp, gf.reshape(Q)]))
            dp = delta[:P] * epm
            df = delta[P:].reshape(L, ldof) * b.lm_opt[:, None]
            return dp.reshape(-1, pdof), df

        # The batched SPD inverse: the hand-written CUDA kernel on the card.
        Hf_inv = spd_inverse(Hf_d)                             # [L, l, l]

        HpfHi = torch.einsum("lpi,lij->lpj", Hpf, Hf_inv)      # [L, P, l]
        A = Hp_d - torch.einsum("lpj,lqj->pq", HpfHi, Hpf)
        rhs = gp - torch.einsum("lpj,lj->p", HpfHi, gf)
        dp = -scaled_chol_solve(A, rhs) * epm                 # [P]
        # Back-substitute landmarks: df = Hf_inv (-gf - Hpf^T dp).
        df = torch.einsum(
            "lij,lj->li", Hf_inv,
            -gf - torch.einsum("lpi,p->li", Hpf, dp)
        ) * b.lm_opt[:, None]
        return dp.reshape(-1, pdof), df

    def _apply(edge_pose, lm_state, dp, df):
        return group.retract(edge_pose, dp), lmt.retract(lm_state, df)

    def solve(b: WindowBatch):
        dt, dev = b.edge_pose.dtype, b.edge_pose.device
        err0 = _error(b.edge_pose, b.lm_state, b)
        it_cap = (cfg.max_iters if b.iters_cap is None
                  else min(int(b.iters_cap), cfg.max_iters))

        edge, lm, err = b.edge_pose, b.lm_state, err0
        lam, rej, done, it = lm_state(cfg, (), dt, dev)
        plans = _segment_plans(b) if it_cap > 0 else None
        for _ in range(it_cap):
            Hp, gp, Hf, gf, Hpf = _build_normal_eqs(edge, lm, b, plans)
            dp, df = _solve_delta(Hp, gp, Hf, gf, Hpf, lam, b)
            cand_e, cand_l = _apply(edge, lm, dp, df)
            err_new = _error(cand_e, cand_l, b)
            accept, err, lam, rej, done, it = lm_update(
                cfg, err, err_new, lam, rej, done, it)
            edge = torch.where(accept, cand_e, edge)
            lm = torch.where(accept, cand_l, lm)
        info = {
            "err_init": err0,
            "err_final": err,
            "iters": it,
            "lam": lam,
            "num_obs": psum(torch.sum(b.obs_valid), reduce_group),
        }
        return edge, lm, info

    def eval_error(b: WindowBatch):
        return _error(b.edge_pose, b.lm_state, b)

    return solve, eval_error


def make_lm_solver(cfg: SolverConfig, device="cuda"):
    """Single-device LM optimizer on ``device`` (see
    :func:`make_solver_impl`); each call moves its batch there first.
    ``device="cuda"`` without CUDA raises; an ``axis_name`` too (a sharded
    solve is :func:`srba_tpu_torch.parallel.sharding.make_spmd_solver`'s)."""
    if cfg.axis_name is not None:
        raise ValueError("make_lm_solver is the single-device solver; use "
                         "srba_tpu_torch.parallel.make_spmd_solver for "
                         f"axis_name={cfg.axis_name!r}")
    dev = resolve_device(device)
    solve, eval_error = make_solver_impl(cfg)
    return (lambda b: solve(b.to(dev)), lambda b: eval_error(b.to(dev)))


def get_solver(cfg: SolverConfig, device="cuda"):
    """Cached :func:`make_lm_solver`: one ``(solve, eval_error)`` pair per
    ``(cfg, device)``, as the JAX package's ``get_solver`` compiles once
    per ``cfg``.  ``device="cuda"`` without CUDA raises."""
    return _cached_solver(cfg, resolve_device(device))


@functools.lru_cache(maxsize=None)
def _cached_solver(cfg: SolverConfig, device: torch.device):
    return make_lm_solver(cfg, device)
