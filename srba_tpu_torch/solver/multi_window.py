"""Map-parallel refinement: many local windows optimized in ONE batched
solve — port of :mod:`srba_tpu.solver.multi_window`.

The design is the JAX package's (see its module docstring): windows around
many roots are solved simultaneously as a block-coordinate
Levenberg-Marquardt sweep over the whole map; **ownership masking** gives
every unknown (edge / landmark) to exactly ONE window per sweep, so the
writes back into the masters are disjoint; the windows are padded to a
COMMON bucket shape and stacked on a leading ``W`` axis.

Where the JAX package ``vmap``s its whole single-window solve over ``W``,
the port writes the batched solve out (:func:`make_batched_solver`), with
the LM state of every window kept apart:

* **Linearization on flattened rows.**  The W windows become one window of
  ``W*E`` edges, ``W*L`` landmarks and ``W*N`` observation rows (path-edge
  indices offset by ``w*E``, landmark indices by ``w*L``), and the solver's
  own ``make_linearize`` runs on it unchanged.
* **Normal equations per window** with batched products: one-hots
  ``[W, L, N]`` and ``[W, N, D, E]`` (never a ``[W*L, W*N]`` one, which
  grows as W^2), or the segmented reduction with window-offset keys.
* **One SPD-kernel launch per LM iteration** on the stacked landmark blocks
  of every window, ``[W*L, l, l]``.
* **A batched Jacobi-equilibrated Cholesky** on ``[W, P, P]``: a window
  whose factorization fails (``info != 0``) gets a NaN step, so only that
  window rejects.
* **LM state per window**: ``lam``, ``rej``, ``done``, ``err`` and ``it``
  are ``[W]`` vectors under the single-window solver's accept rule.

The sweep's write is the JAX package's: ``master.index_add_(ids, delta)``
with the delta zeroed (``torch.where``) outside a window's ownership.
Ownership is disjoint, so a row gets at most one non-zero delta and its
duplicate and padding slots add exact zeros: the result does not depend on
the order of ``index_add_``'s atomics.

On a mesh (:func:`make_sweep_step_mesh`) the ``W`` axis is split over the
ranks: each rank solves its windows against the same masters, adds its
masked deltas into zeroed fields, and the fields are summed over the ranks
in one all-reduce.  Ownership is disjoint, so each master row sums one
delta and exact zeros, whatever the order: the result is deterministic.

Repeated sweeps converge like Gauss-Seidel over areas; pair with the global
PGO (:mod:`srba_tpu_torch.solver.global_graphslam`) for long-range error.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import torch
import torch.distributed as dist

from srba_tpu_torch.ops.block_linalg import spd_inverse
from srba_tpu_torch.ops.robust import pseudo_huber_cost, pseudo_huber_weight
from srba_tpu_torch.parallel.sharding import shard_rows
from srba_tpu_torch.solver.lm import (SolverConfig, WindowBatch, _resolve,
                                      lm_state, lm_update, make_linearize,
                                      scaled_chol_solve, segment_plans,
                                      segment_sum)
from srba_tpu_torch.solver.master import _to_device
from srba_tpu_torch.utils.collectives import all_reduce_packed

SWEEP_AXIS = "win"


def make_batched_solver(cfg: SolverConfig):
    """The LM optimizer of :func:`srba_tpu_torch.solver.lm.make_solver_impl`
    over ``W`` windows at once.

    Its batch is a :class:`WindowBatch` whose per-window fields carry a
    leading ``W`` axis (``edge_pose [W, E, pose_dim]``, ``obs_lm [W, N]``,
    ``path_edge [W, N, D]``, ...; indices local to each window) and whose
    ``whitener``, ``sensor_pose_inv`` and ``calib`` are shared.  Returns
    ``(solve, eval_error)``: ``solve(batch) -> (edge_pose [W, E, pose_dim],
    lm_state [W, L, lm_dim], info)`` with ``info`` a dict of ``[W]`` device
    tensors (the single-window keys), ``eval_error(batch) -> [W]``.  Each
    window's result is the single-window solver's on that window, up to the
    order of f32 sums."""
    group, _, lmt = _resolve(cfg)
    pdof, ldof, D = group.dof, lmt.dof, cfg.max_depth
    _linearize, _prior_linearize = make_linearize(cfg)

    def _sizes(b: WindowBatch):
        W, E = b.edge_opt.shape
        return W, E, b.lm_opt.shape[1], b.obs_valid.shape[1]

    def _flat(b: WindowBatch) -> WindowBatch:
        """The W windows as one window of W*E edges, W*L landmarks and W*N
        rows (state fields left out: the loop passes them)."""
        W, E, L, N = _sizes(b)
        w = torch.arange(W, device=b.obs_lm.device, dtype=b.obs_lm.dtype)
        return WindowBatch(
            edge_pose=None, edge_opt=b.edge_opt.reshape(W * E),
            lm_state=None, lm_opt=b.lm_opt.reshape(W * L),
            obs_z=b.obs_z.reshape(W * N, -1),
            obs_lm=(b.obs_lm + w[:, None] * L).reshape(W * N),
            path_edge=(b.path_edge + w[:, None, None] * E).reshape(W * N, D),
            path_sign=b.path_sign.reshape(W * N, D),
            obs_valid=b.obs_valid.reshape(W * N),
            whitener=b.whitener, sensor_pose_inv=b.sensor_pose_inv,
            calib=b.calib,
            edge_prior=(None if b.edge_prior is None
                        else b.edge_prior.reshape(W * E, -1)),
            edge_prior_w=(None if b.edge_prior_w is None
                          else b.edge_prior_w.reshape(W * E)))

    def _errors(edge, lm, b: WindowBatch, fb: WindowBatch):
        W, E, L, N = _sizes(b)
        ef, lf = edge.reshape(W * E, -1), lm.reshape(W * L, -1)
        r, _ = _linearize(ef, lf, fb, jac=False)
        # where, not multiply: a NaN residual on a padded row must not
        # poison its window's sum.
        r = torch.where(fb.obs_valid[:, None] > 0, r, 0.0)
        sq = (torch.sum(r * r, dim=-1) * fb.obs_valid).reshape(W, N)
        if cfg.use_robust_kernel:
            sq = pseudo_huber_cost(sq, cfg.kernel_param) * b.obs_valid
        err = torch.sum(sq, dim=1)
        if fb.edge_prior is not None:
            rp, _ = _prior_linearize(ef, fb, jac=False)
            wp = fb.edge_prior_w * fb.edge_opt
            rp = torch.where(wp[:, None] > 0, rp, 0.0)
            err = err + torch.sum(
                (torch.sum(rp * rp, dim=-1) * wp).reshape(W, E), dim=1)
        return err

    def _segment_plans(b: WindowBatch):
        """Window-offset keys of the segmented backend (None for one-hot)."""
        if cfg.neq != "segmented":
            return None
        W, E, L, _ = _sizes(b)
        return segment_plans(b.path_edge, b.obs_lm, E, L)

    def _build_normal_eqs(edge, lm, b: WindowBatch, fb: WindowBatch, plans):
        W, E, L, N = _sizes(b)
        od = b.whitener.shape[0]
        P = E * pdof
        dt, dev = edge.dtype, edge.device
        r, J = _linearize(edge.reshape(W * E, -1), lm.reshape(W * L, -1),
                          fb, jac=True)
        # Mask padded rows with `where` (NaN-proof), then the IRLS row scale
        # (robust weight frozen at linearization) x validity.
        valid = fb.obs_valid[:, None] > 0
        r = torch.where(valid, r, 0.0)
        J = torch.where(valid[..., None], J, 0.0)
        sq = torch.sum(r * r, dim=-1)
        w = (pseudo_huber_weight(sq, cfg.kernel_param)
             if cfg.use_robust_kernel else torch.ones_like(sq))
        scale = torch.sqrt(w) * fb.obs_valid
        r = (r * scale[:, None]).reshape(W, N, od)
        J = (J * scale[:, None, None]).reshape(W, N, od, -1)

        Jp_blocks = J[..., : D * pdof].reshape(W, N, od, D, pdof)
        lm_opt_obs = torch.gather(b.lm_opt, 1, b.obs_lm.to(torch.int64))
        Jl = J[..., D * pdof:] * lm_opt_obs[..., None, None]  # [W,N,od,l]

        # Per-window segment sums over obs_lm: one-hot [W, L, N] products.
        seg_onehot = (b.obs_lm[:, None, :] == torch.arange(
            L, device=dev, dtype=b.obs_lm.dtype)[None, :, None]).to(dt)

        def seg(x):
            return torch.bmm(seg_onehot, x.reshape(W, N, -1)).reshape(
                (W, L) + tuple(x.shape[2:]))

        Hf = seg(torch.einsum("wnoi,wnoj->wnij", Jl, Jl))   # [W, L, l, l]
        gf = seg(torch.einsum("wnoi,wno->wni", Jl, r))      # [W, L, l]

        if plans is None:
            onehot = (b.path_edge[..., None] == torch.arange(
                E, device=dev, dtype=b.path_edge.dtype)).to(dt)  # [W,N,D,E]
            Jp = torch.einsum("wnodp,wnde->wnoep", Jp_blocks, onehot)
            Jp = Jp * b.edge_opt[:, None, None, :, None]
            Jp2 = Jp.reshape(W, N * od, P)
            Hp = torch.bmm(Jp2.transpose(1, 2), Jp2)        # [W, P, P]
            gp = torch.bmm(Jp2.transpose(1, 2),
                           r.reshape(W, N * od, 1))[..., 0]  # [W, P]
            Hpf = seg(torch.einsum("wnop,wnoi->wnpi",
                                   Jp.reshape(W, N, od, P), Jl))
        else:
            plan_pp, plan_e, plan_le = plans
            pe = b.path_edge.to(torch.int64)
            emask = torch.gather(b.edge_opt, 1, pe.reshape(W, N * D)) \
                .reshape(W, N, D)
            Jb = Jp_blocks * emask[:, :, None, :, None]     # [W,N,od,D,p]
            Bpp = torch.einsum("wnodi,wnoep->wndeip", Jb, Jb)
            Hp = segment_sum(Bpp.reshape(W * N * D * D, pdof, pdof), plan_pp)
            Hp = Hp.reshape(W, E, E, pdof, pdof).permute(0, 1, 3, 2, 4) \
                .reshape(W, P, P)
            gb = torch.einsum("wnodi,wno->wndi", Jb, r)
            gp = segment_sum(gb.reshape(W * N * D, pdof), plan_e) \
                .reshape(W, P)
            Cpl = torch.einsum("wnodi,wnol->wndil", Jb, Jl)
            Hpf = segment_sum(Cpl.reshape(W * N * D, pdof, ldof),
                              plan_le).reshape(W, L, P, ldof)

        if fb.edge_prior is not None:
            # Edge priors: block-diagonal H += w JtJ, g += w Jtr per edge.
            rp, Jpr = _prior_linearize(edge.reshape(W * E, -1), fb, jac=True)
            wp = fb.edge_prior_w * fb.edge_opt
            rp = torch.where(wp[:, None] > 0, rp, 0.0)
            Jpr = torch.where(wp[:, None, None] > 0, Jpr, 0.0)
            Hblk = wp[:, None, None] * torch.einsum("eij,eik->ejk", Jpr, Jpr)
            gblk = wp[:, None] * torch.einsum("eij,ei->ej", Jpr, rp)
            Hp.view(W, E, pdof, E, pdof).diagonal(dim1=1, dim2=3).add_(
                Hblk.reshape(W, E, pdof, pdof).permute(0, 2, 3, 1))
            gp = gp + gblk.reshape(W, P)
        return Hp, gp, Hf, gf, Hpf

    def _solve_delta(Hp, gp, Hf, gf, Hpf, lam, b: WindowBatch):
        W, E, L, _ = _sizes(b)
        epm = torch.repeat_interleave(b.edge_opt, pdof, dim=1)  # [W, P]
        diag_p = torch.diagonal(Hp, dim1=-2, dim2=-1)
        Hp_d = Hp + torch.diag_embed(
            lam[:, None] * diag_p + cfg.diag_floor + (1.0 - epm))
        diag_f = torch.diagonal(Hf, dim1=-2, dim2=-1)        # [W, L, l]
        Hf_d = Hf + torch.diag_embed(
            lam[:, None, None] * diag_f + cfg.diag_floor
            + (1.0 - b.lm_opt)[..., None])

        if cfg.solver == "no_schur_dense_cholesky":
            # Full-system dense Cholesky per window (no SPD block inverse).
            P, Q = E * pdof, L * ldof
            Hpf_full = Hpf.permute(0, 2, 1, 3).reshape(W, P, Q)
            Hf_full = torch.zeros((W, L, ldof, L, ldof), dtype=Hf.dtype,
                                  device=Hf.device)
            Hf_full.diagonal(dim1=1, dim2=3).copy_(Hf_d.permute(0, 2, 3, 1))
            H = torch.cat([torch.cat([Hp_d, Hpf_full], dim=2),
                           torch.cat([Hpf_full.transpose(1, 2),
                                      Hf_full.reshape(W, Q, Q)], dim=2)],
                          dim=1)
            delta = -scaled_chol_solve(
                H, torch.cat([gp, gf.reshape(W, Q)], dim=1))
            dp = delta[:, :P] * epm
            df = delta[:, P:].reshape(W, L, ldof) * b.lm_opt[..., None]
            return dp.reshape(W, E, pdof), df

        # ONE launch of the batched SPD inverse (the CUDA kernel on the
        # card) over every window's landmark blocks: [W*L, l, l].
        Hf_inv = spd_inverse(Hf_d.reshape(W * L, ldof, ldof)) \
            .reshape(W, L, ldof, ldof)
        HpfHi = torch.einsum("wlpi,wlij->wlpj", Hpf, Hf_inv)  # [W, L, P, l]
        A = Hp_d - torch.einsum("wlpj,wlqj->wpq", HpfHi, Hpf)
        rhs = gp - torch.einsum("wlpj,wlj->wp", HpfHi, gf)
        dp = -scaled_chol_solve(A, rhs) * epm               # [W, P]
        df = torch.einsum(
            "wlij,wlj->wli", Hf_inv,
            -gf - torch.einsum("wlpi,wp->wli", Hpf, dp)
        ) * b.lm_opt[..., None]
        return dp.reshape(W, E, pdof), df

    def solve(b: WindowBatch):
        W = b.edge_opt.shape[0]
        dt, dev = b.edge_pose.dtype, b.edge_pose.device
        fb = _flat(b)
        err0 = _errors(b.edge_pose, b.lm_state, b, fb)
        it_cap = (cfg.max_iters if b.iters_cap is None
                  else min(int(b.iters_cap), cfg.max_iters))

        edge, lm, err = b.edge_pose, b.lm_state, err0
        lam, rej, done, it = lm_state(cfg, (W,), dt, dev)
        plans = _segment_plans(b) if it_cap > 0 else None
        for _ in range(it_cap):
            neqs = _build_normal_eqs(edge, lm, b, fb, plans)
            dp, df = _solve_delta(*neqs, lam, b)
            cand_e = group.retract(edge, dp)
            cand_l = lmt.retract(lm, df)
            err_new = _errors(cand_e, cand_l, b, fb)
            accept, err, lam, rej, done, it = lm_update(
                cfg, err, err_new, lam, rej, done, it)
            edge = torch.where(accept[:, None, None], cand_e, edge)
            lm = torch.where(accept[:, None, None], cand_l, lm)
        info = {
            "err_init": err0,
            "err_final": err,
            "iters": it,
            "lam": lam,
            "num_obs": torch.sum(b.obs_valid, dim=1),
        }
        return edge, lm, info

    def eval_error(b: WindowBatch):
        return _errors(b.edge_pose, b.lm_state, b, _flat(b))

    return solve, eval_error


def _agg_info(info):
    """One sweep phase's info: sums of errors and observations, maxima of
    iterations and lambda (the JAX package's aggregation)."""
    return {
        "err_init": torch.sum(info["err_init"]),
        "err_final": torch.sum(info["err_final"]),
        "iters": torch.max(info["iters"]),
        "lam": torch.max(info["lam"]),
        "num_obs": torch.sum(info["num_obs"]),
    }


def _make_solve_windows(cfg: SolverConfig):
    """``solve_windows(pose_master, prior_master, lm_master, ints, obs_z,
    whitener, sensor_pose_inv, calib, E, L, N) -> (edge_ids [W, E], dp,
    lm_ids [W, L], dl, info)``: the windows of ``ints``/``obs_z`` (host
    arrays, uploaded once) solved in one batched solve against the masters,
    with their deltas zeroed (``torch.where``) outside each window's
    ownership and ``info`` of ``[W]`` tensors."""
    solve, _ = make_batched_solver(cfg)
    D = cfg.max_depth

    def solve_windows(pose_master, prior_master, lm_master, ints, obs_z,
                      whitener, sensor_pose_inv, calib, E, L, N):
        dev = pose_master.device
        pose_dim = pose_master.shape[1]
        ints = _to_device(torch.as_tensor(ints, dtype=torch.int32), dev)
        obs_z = _to_device(torch.as_tensor(obs_z, dtype=torch.float32), dev)
        W = ints.shape[0]
        cols = [E, E, L, L, N, N, N * D, N * D]
        edge_ids, edge_opt, lm_ids, lm_opt, obs_lm, obs_valid, path_edge, \
            path_sign = torch.split(ints, cols, dim=1)
        edge_opt, lm_opt = edge_opt.to(torch.float32), lm_opt.to(torch.float32)
        edge_pose = pose_master[edge_ids]                    # [W, E, pd]
        prior_rows = prior_master[edge_ids]
        lm_state = lm_master[lm_ids]
        batch = WindowBatch(
            edge_pose=edge_pose, edge_opt=edge_opt,
            lm_state=lm_state, lm_opt=lm_opt,
            obs_z=obs_z, obs_lm=obs_lm.contiguous(),
            path_edge=path_edge.reshape(W, N, D),
            path_sign=path_sign.reshape(W, N, D).to(torch.float32),
            obs_valid=obs_valid.to(torch.float32),
            whitener=whitener, sensor_pose_inv=sensor_pose_inv, calib=calib,
            edge_prior=prior_rows[..., :pose_dim],
            edge_prior_w=prior_rows[..., pose_dim])
        new_edge, new_lm, info = solve(batch)
        # Masked deltas (where, not multiply): an unowned or padding slot
        # adds exactly 0 whatever its solve produced.
        dp = torch.where(edge_opt[..., None] > 0, new_edge - edge_pose, 0.0)
        dl = torch.where(lm_opt[..., None] > 0, new_lm - lm_state, 0.0)
        return edge_ids, dp, lm_ids, dl, info

    return solve_windows


@functools.lru_cache(maxsize=None)
def make_sweep_step(cfg: SolverConfig):
    """Single-device sweep: ``step(pose_master, prior_master, lm_master,
    ints [W, T], obs_z [W, N, z_dim], whitener, sensor_pose_inv, calib, E,
    L, N) -> (pose_master, lm_master, info)``.  ``ints`` (int32) and
    ``obs_z`` (f32) are host arrays: row w is window w's
    :func:`~srba_tpu_torch.solver.master.pack_window_ints` buffer (its opt
    masks are the ownership masks) and its observations; each is uploaded
    once.  The masters are updated in place (returned for symmetry with the
    JAX package's donated ones); ``info`` holds 0-dim device tensors."""
    solve_windows = _make_solve_windows(cfg)

    def step(pose_master, prior_master, lm_master, ints, obs_z,
             whitener, sensor_pose_inv, calib, E, L, N):
        edge_ids, dp, lm_ids, dl, info = solve_windows(
            pose_master, prior_master, lm_master, ints, obs_z, whitener,
            sensor_pose_inv, calib, E, L, N)
        pose_master.index_add_(0, edge_ids.reshape(-1),
                               dp.reshape(-1, pose_master.shape[1]))
        lm_master.index_add_(0, lm_ids.reshape(-1),
                             dl.reshape(-1, lm_master.shape[1]))
        return pose_master, lm_master, _agg_info(info)

    return step


@functools.lru_cache(maxsize=None)
def make_sweep_step_mesh(cfg: SolverConfig, mesh):
    """The mesh-sharded sweep: :func:`make_sweep_step`'s ``step``, with the
    ``W`` windows (a multiple of the mesh size, every rank passing all of
    them) split over ``mesh``'s ranks, rank r solving windows ``[r*W/n,
    (r+1)*W/n)``.  Every rank holds the same masters; each adds its masked
    deltas into zeroed fields, which are summed over the ranks with the
    info's sums in one all-reduce round (the info's maxima in a second),
    and then into the masters.  Every rank ends with the same masters and
    info."""
    solve_windows = _make_solve_windows(cfg)
    (axis,) = mesh.mesh_dim_names
    group = mesh.get_group(axis)

    def step(pose_master, prior_master, lm_master, ints, obs_z,
             whitener, sensor_pose_inv, calib, E, L, N):
        rows = shard_rows(len(ints), mesh)
        edge_ids, dp, lm_ids, dl, info = solve_windows(
            pose_master, prior_master, lm_master, ints[rows], obs_z[rows],
            whitener, sensor_pose_inv, calib, E, L, N)
        dpose = torch.zeros_like(pose_master).index_add_(
            0, edge_ids.reshape(-1), dp.reshape(-1, pose_master.shape[1]))
        dlm = torch.zeros_like(lm_master).index_add_(
            0, lm_ids.reshape(-1), dl.reshape(-1, lm_master.shape[1]))
        agg = _agg_info(info)
        sums = ("err_init", "err_final", "num_obs")
        dpose, dlm, *summed = all_reduce_packed(
            (dpose, dlm) + tuple(agg[k] for k in sums), group)
        # The maxima as the per-window aggregation takes them.
        iters, lam = all_reduce_packed(
            (agg["iters"].to(agg["lam"].dtype), agg["lam"]), group,
            op=dist.ReduceOp.MAX)
        pose_master.add_(dpose)
        lm_master.add_(dlm)
        out = dict(zip(sums, summed))
        out.update(iters=iters.to(agg["iters"].dtype), lam=lam)
        return pose_master, lm_master, out

    return step


def plan_sweep_roots(engine, stride: Optional[int] = None,
                     offset: int = 0) -> List[int]:
    """Sweep roots covering the map: every ``stride`` keyframes (default:
    the ECP submap size, else max_optimize_depth).  ``offset`` staggers the
    root lattice between sweeps so window boundaries move (alternating
    sweeps relax the unknowns a fixed boundary would freeze)."""
    if stride is None:
        stride = getattr(engine.ecp, "submap_size", None) \
            or engine.parameters.max_optimize_depth
    stride = max(1, int(stride))
    start = int(offset) % stride
    roots = list(range(start, engine.num_keyframes, stride))
    if start != 0:
        roots = [0] + roots   # keep the map origin covered
    return roots

