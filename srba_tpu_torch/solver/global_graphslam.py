"""Global pose-graph optimization (PGO) — the port of
:mod:`srba_tpu.solver.global_graphslam`, the consumer of
:func:`srba_tpu_torch.io.export.get_global_graphslam_problem`.

Same algorithm as the JAX package (see its module docstring): matrix-free
Gauss-Newton/LM with block-Jacobi-preconditioned CG over the edge-block
structure of H = JᵀJ (per edge two ``[dof, dof]`` Jacobian blocks, never a
sparse matrix), node 0 the gauge, optional chordal initialization
(:mod:`srba_tpu_torch.solver.chordal`), pseudo-Huber IRLS, per-component and
anisotropic per-edge information, power-of-two node/edge buckets.

What differs from the JAX package, and why:

* Jacobians: forward mode written out by hand (the group's ``*_jvp``
  functions with a ``[.., 2*dof]`` direction basis on both endpoint
  tangents) where JAX takes ``jacfwd``; see :mod:`srba_tpu_torch.ops.lie`.
* Segment sums over edge endpoints: fixed-order gather-sums through a
  per-node incidence table (:class:`~srba_tpu_torch.solver.pgo_ops.
  EdgeIncidence`), bitwise reproducible on CUDA (no atomics).
* Loops: JAX runs the LM and CG loops as ``lax.while_loop`` on the device.
  Here both are host loops that read their exit test on the host every
  iteration (:func:`~srba_tpu_torch.solver.pgo_ops.pcg` for CG), so
  decisions, ``iters`` and ``cg_iters_total`` are the JAX loop's.  The
  reads are counted under the profiler counter ``pgo_host_syncs`` (with
  ``pgo_solves``).
* The block-Jacobi blocks are inverted by
  :func:`~srba_tpu_torch.ops.block_linalg.spd_inverse`: the CUDA kernel on
  the card.
* Every product is true f32 (TF32 is never enabled), the analog of JAX's
  ``default_matmul_precision("highest")`` pin.
* The solve runs on an explicit ``device``; ``"cuda"`` without CUDA raises.
* The edge-sharded SPMD path (``mesh=``, :func:`make_pgo_spmd`,
  ``PGOConfig.axis_name``): nodes are replicated and every rank takes its
  rows of the edge tables, with an ``EdgeIncidence`` of its own live
  edges; Jᵀr, H·v, the block diagonal, the error and the error floor are
  all-reduced where the JAX package ``psum``s them.  The host-read loop
  exits then read only reduced values, so every rank takes the same
  decisions.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from srba_tpu_torch.ops.block_linalg import spd_inverse
from srba_tpu_torch.ops.lie import GROUPS
from srba_tpu_torch.parallel.sharding import mesh_device, shard_rows
from srba_tpu_torch.solver.pgo_ops import EdgeIncidence, HostReads, pcg
from srba_tpu_torch.utils.collectives import axis_group, psum
from srba_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class PGOConfig:
    """The JAX package's ``PGOConfig``: same fields, same defaults (see
    there for the measurements behind each)."""

    group: str
    max_outer: int = 30          # LM iterations (each re-linearizes)
    cg_iters: int = 50           # CG iterations per LM step
    lam0: float = 1e-4
    lam_up: float = 10.0
    lam_down: float = 0.1
    lam_min: float = 1e-10
    lam_max: float = 1e8
    # An accepted step whose relative error decrease is below rel_tol
    # certifies the fixed point (1e-5 is the f32-appropriate stop).
    rel_tol: float = 1e-5
    cg_rtol: float = 1e-6
    # Consecutive rejected steps before declaring a local optimum.
    max_consec_rejects: int = 3
    # Mean robust cost per valid edge below this is converged regardless of
    # relative progress.
    abs_tol_per_edge: float = 5e-6
    # Pseudo-Huber tangent-norm scale of the robust edge loss (IRLS); None
    # = quadratic.
    robust_delta: Optional[float] = None
    # Weight of the rotation components of the tangent residual.
    rot_weight: float = 1.0
    # Chordal initialization (solver/chordal.py) before LM-PCG.
    chordal_init: bool = False
    chordal_cg_iters: int = 300
    # Anisotropic per-edge information: the solve whitens every edge with a
    # ``Wsqrt`` [E, dof, dof] operand.
    use_edge_info: bool = False
    # Mesh axis the edge tables are sharded over (None = one device): every
    # edge-indexed reduction is all-reduced over it.
    axis_name: Optional[str] = None


def _make_residual(group):
    def residual(Ga, Gb, z, eps_a, eps_b):
        """Tangent residual of one edge constraint z = T_a<-b."""
        a = group.retract(Ga, eps_a)
        b = group.retract(Gb, eps_b)
        pred = group.compose(group.inverse(a), b)   # T_a<-b from globals
        return group.plog(group.compose(group.inverse(z), pred))
    return residual


def _make_residual_jacobians(group):
    """``(Ga, Gb, z) -> (r [E, dof], A [E, dof, dof], B [E, dof, dof])``: the
    residual of :func:`_make_residual` at zero tangents and its Jacobians
    with respect to ``eps_a`` (A) and ``eps_b`` (B), by hand-written forward
    mode over a ``2*dof`` direction basis (JAX: ``jacfwd`` per argument)."""
    dof = group.dof

    def residual_jacobians(Ga, Gb, z):
        dt, dev = Ga.dtype, Ga.device
        zeros = torch.zeros(Ga.shape[:-1] + (dof,), dtype=dt, device=dev)
        basis = torch.eye(2 * dof, dtype=dt, device=dev)
        a, da = group.retract_jvp(Ga, zeros, basis[:dof])
        b, db = group.retract_jvp(Gb, zeros, basis[dof:])
        ai, dai = group.inverse_jvp(a, da)
        pred, dpred = group.compose_jvp(ai, b, dai, db)
        c, dc = group.compose_jvp(group.inverse(z), pred, None, dpred)
        r, dr = group.plog_jvp(c, dc)
        return r, dr[..., :dof], dr[..., dof:]

    return residual_jacobians


@contextmanager
def _scope(profiler, name: str, device: torch.device):
    """A profiler scope that waits for the device before it closes, so the
    host clock attributes device time to the scope that queued it.  Only a
    solve given a profiler pays for those waits."""
    if profiler is None or not profiler.enabled:
        yield
        return
    with profiler.scope(name):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _make_pgo(cfg: PGOConfig, mesh=None):
    """Build ``solve(G0, ea, eb, z, w, lam0, Wsqrt=None, incidence=None,
    profiler=None) -> (G_opt, info)`` for one configuration.  Operands are
    tensors on one device (``lam0`` a float); ``w`` carries validity (0 =
    padding edge) and constraint weight; ``incidence`` is the
    :class:`EdgeIncidence` of the edges (built from all of them when
    omitted).  ``info`` holds the JAX package's keys as Python numbers.
    With ``cfg.axis_name`` the edge operands are this rank's shard of
    ``mesh`` (the world when None) and the sums over edges are
    all-reduced."""
    reduce_group = axis_group(cfg.axis_name, mesh)
    group = GROUPS[cfg.group]
    dof = group.dof
    res_fn = _make_residual(group)
    res_jac = _make_residual_jacobians(group)
    # Tangent layout is [translation, rotation]: SE2 dof 3 = 2+1, SE3 dof
    # 6 = 3+3.
    t_dim = 2 if dof == 3 else 3

    def _comp(dt, dev):
        """Per-component information weights (translation 1, rotation
        cfg.rot_weight)."""
        return torch.cat([torch.ones((t_dim,), dtype=dt, device=dev),
                          torch.full((dof - t_dim,), cfg.rot_weight,
                                     dtype=dt, device=dev)])

    def _sq(r, w, comp, Wsqrt):
        """Per-edge whitened squared tangent norm s_e [E] of residuals r."""
        if Wsqrt is not None:
            r = torch.einsum("eij,ej->ei", Wsqrt, r)
        return torch.sum(r * r * comp[None, :], dim=-1) * w

    def _robust_cost(s):
        """Pseudo-Huber rho(s) on the squared norm; identity without a
        robust delta."""
        if cfg.robust_delta is None:
            return s
        d2 = cfg.robust_delta * cfg.robust_delta
        return 2.0 * d2 * (torch.sqrt(1.0 + s / d2) - 1.0)

    def _robust_weight(s):
        """IRLS weight rho'(s)."""
        if cfg.robust_delta is None:
            return torch.ones_like(s)
        d2 = cfg.robust_delta * cfg.robust_delta
        return 1.0 / torch.sqrt(1.0 + s / d2)

    def linearize(G, ea, eb, z, w, comp, Wsqrt):
        """Residuals r [E,dof] and Jacobian blocks A,B [E,dof,dof] wrt the
        tangents of the two incident nodes, weighted (static weight w,
        per-component weights, the robust IRLS weight of the same
        residuals, optional anisotropic information shape Wsqrt)."""
        r, A, B = res_jac(G[ea], G[eb], z)
        rw = _robust_weight(_sq(r, w, comp, Wsqrt))
        if Wsqrt is not None:
            r = torch.einsum("eij,ej->ei", Wsqrt, r)
            A = torch.einsum("eij,ejk->eik", Wsqrt, A)
            B = torch.einsum("eij,ejk->eik", Wsqrt, B)
        sw = torch.sqrt(w * rw)[:, None] * torch.sqrt(comp)[None, :]
        return r * sw, A * sw[..., None], B * sw[..., None]

    def build_ops(inc, ea, eb, A, B, gauge_mask):
        """Matrix-free H·v and Jᵀr over the edge-block structure."""

        def JT(r):
            # [K, dof] <- AᵀrA summed at node a, BᵀrB at node b
            return psum(inc.sum(torch.einsum("eij,ei->ej", A, r),
                                torch.einsum("eij,ei->ej", B, r)),
                        reduce_group) * gauge_mask[:, None]

        def Hv(v):
            v = v * gauge_mask[:, None]
            u = (torch.einsum("eij,ej->ei", A, v[ea])
                 + torch.einsum("eij,ej->ei", B, v[eb]))
            return JT(u)

        def block_diag():
            # [K, dof, dof] block-Jacobi preconditioner blocks of H
            return psum(inc.sum(torch.einsum("eij,eik->ejk", A, A),
                                torch.einsum("eij,eik->ejk", B, B)),
                        reduce_group)

        return JT, Hv, block_diag

    def solve(G0, ea, eb, z, w, lam0, Wsqrt=None, incidence=None,
              profiler=None):
        if cfg.use_edge_info != (Wsqrt is not None):
            raise ValueError("Wsqrt must be given exactly when "
                             "PGOConfig.use_edge_info is set")
        K = G0.shape[0]
        dt, dev = G0.dtype, G0.device
        inc = incidence if incidence is not None else EdgeIncidence(
            ea.cpu().numpy(), eb.cpu().numpy(), K, ea.shape[0], dev)
        reads = HostReads()
        comp = _comp(dt, dev)
        gauge_mask = torch.ones((K,), dtype=dt, device=dev)
        gauge_mask[0] = 0.0
        err_floor = cfg.abs_tol_per_edge * psum(torch.sum(w > 0),
                                                reduce_group)
        zeros = torch.zeros(ea.shape + (dof,), dtype=dt, device=dev)

        def err_of(G):
            r = res_fn(G[ea], G[eb], z, zeros, zeros)
            return psum(torch.sum(_robust_cost(_sq(r, w, comp, Wsqrt))),
                        reduce_group)

        if cfg.chordal_init:
            from srba_tpu_torch.solver.chordal import make_chordal_init
            with _scope(profiler, "pgo_chordal", dev):
                G0 = make_chordal_init(cfg.group, cfg.chordal_cg_iters,
                                       cg_rtol=cfg.cg_rtol,
                                       axis_name=cfg.axis_name, mesh=mesh)(
                    G0, ea, eb, z, w, incidence=inc, reads=reads)
        with _scope(profiler, "pgo_eval", dev):
            err0 = err_of(G0)
            done = err0 <= err_floor
        G, err = G0, err0
        lam = torch.full((), lam0, dtype=dt, device=dev)
        rej = torch.zeros((), dtype=torch.int32, device=dev)
        cg_total = 0
        it = 0
        while it < cfg.max_outer and not reads.flag(done):
            with _scope(profiler, "pgo_linearize", dev):
                r, A, B = linearize(G, ea, eb, z, w, comp, Wsqrt)
                JT, Hv, block_diag = build_ops(inc, ea, eb, A, B,
                                               gauge_mask)
                g = JT(r)                               # [K, dof]
                D = block_diag()                        # [K, dof, dof]
                # LM damping on the block diagonal (+1 on gauge/empty rows
                # to keep the preconditioner and the system SPD).
                damp = lam * torch.diagonal(D, dim1=-2, dim2=-1) + 1e-8
                D_d = D + torch.diag_embed(damp + (1.0 - gauge_mask)[:, None])
                # Batched small-SPD inverse: the CUDA kernel on the card.
                Minv = spd_inverse(D_d)
            with _scope(profiler, "pgo_cg", dev):
                delta, cg_used = pcg(
                    lambda v: Hv(v) + damp * v * gauge_mask[:, None],
                    lambda v: torch.einsum("kij,kj->ki", Minv, v),
                    -g, torch.zeros_like(g), cfg.cg_iters, cfg.cg_rtol,
                    reads)
            with _scope(profiler, "pgo_eval", dev):
                delta = delta * gauge_mask[:, None]
                G_cand = group.retract(G, delta)
                err_new = err_of(G_cand)
                accept = (err_new < err) & torch.isfinite(err_new)
                G = torch.where(accept, G_cand, G)
                lam = torch.where(
                    accept, torch.clamp_min(lam * cfg.lam_down, cfg.lam_min),
                    torch.clamp_max(lam * cfg.lam_up, cfg.lam_max))
                improved = (err - err_new) > cfg.rel_tol * (err + 1e-30)
                rej = torch.where(accept, 0, rej + 1)
                done = ((accept & ~improved)
                        | (rej >= cfg.max_consec_rejects))
                err = torch.where(accept, err_new, err)
                done = done | (err <= err_floor)
                cg_total = cg_total + cg_used
            it += 1
        # done means LM reached its fixed point; otherwise the iteration
        # budget ran out (the caller escalates).  One download for info.
        vals = torch.stack([err0, err, lam, done.to(dt)]).cpu().tolist()
        reads.n += 1
        info = {"err_init": vals[0], "err_final": vals[1], "iters": it,
                "lam": vals[2], "cg_iters_total": cg_total,
                "converged": int(vals[3])}
        if profiler is not None and profiler.enabled:
            profiler.count("pgo_solves")
            profiler.count("pgo_host_syncs", reads.n)
            # A level, not an event count: the widest table solved with.
            profiler.counters["pgo_incidence_width"] = max(
                profiler.counters["pgo_incidence_width"], inc.width)
        return G, info

    return solve


@functools.lru_cache(maxsize=None)
def make_pgo_spmd(cfg: PGOConfig, mesh):
    """Edge-sharded SPMD PGO over ``mesh``'s single axis: nodes replicated,
    edge tables split, per-edge reductions all-reduced (see
    ``PGOConfig.axis_name``).  Returns ``solve(G0, ea, eb, z, w, lam0,
    Wsqrt=None, num_live=None, profiler=None) -> (G_opt, info)``, as the
    single-device solve's, where the edge operands are the FULL tables as
    host arrays, the same on every rank, their row count a multiple of the
    mesh size (pad with ``w = 0`` edges), the first ``num_live`` rows (all
    by default) the live edges.  Each rank uploads its rows ``[r*E/W,
    (r+1)*E/W)`` and their :class:`EdgeIncidence` (its live rows only) to
    the mesh's device; ``G0`` (host or tensor) is replicated.  Every rank
    ends with the same result.  Cached per ``(cfg, mesh)``."""
    (axis,) = mesh.mesh_dim_names
    if cfg.axis_name != axis:
        cfg = dataclasses.replace(cfg, axis_name=axis)
    inner = _make_pgo(cfg, mesh)
    dev = mesh_device(mesh)

    def solve(G0, ea, eb, z, w, lam0, Wsqrt=None, num_live=None,
              profiler=None):
        rows = shard_rows(len(ea), mesh)
        n_live = len(ea) if num_live is None else int(num_live)
        n_live = min(max(n_live - rows.start, 0), rows.stop - rows.start)
        G0 = torch.as_tensor(G0, dtype=torch.float32, device=dev)

        def shard(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a)[rows], dtype=dtype,
                                   device=dev)

        ea_s, eb_s = np.asarray(ea)[rows], np.asarray(eb)[rows]
        inc = EdgeIncidence(ea_s[:n_live], eb_s[:n_live], G0.shape[0],
                            len(ea_s), dev)
        return inner(G0, shard(ea, torch.int64), shard(eb, torch.int64),
                     shard(z), shard(w), lam0,
                     None if Wsqrt is None else shard(Wsqrt),
                     incidence=inc, profiler=profiler)

    return solve


def optimize_global_pose_graph(problem: dict,
                               cfg: PGOConfig | None = None,
                               weights: np.ndarray | None = None,
                               mesh=None, max_escalations: int = 1,
                               lam0: float | None = None,
                               device="cuda", profiler=None):
    """Optimize an exported global pose-graph problem (the dict produced by
    :func:`srba_tpu_torch.io.export.get_global_graphslam_problem`) on
    ``device`` (``"cuda"`` without CUDA raises; there is no CPU fallback).

    Returns ``(nodes_opt [K, pose_dim] numpy, info dict)``, as the JAX
    package's function does: node 0 is the gauge (held fixed), unreachable
    nodes keep their input values, ``weights`` [E] default to the problem's
    ``edge_weights`` (else 1), a problem with ``edge_info_sqrt`` [E, dof,
    dof] switches ``use_edge_info`` on, ``lam0`` warm-starts the LM
    damping, and a solve that ends at the iteration cap unconverged is
    re-entered from its iterate and lambda (chordal init off) up to
    ``max_escalations`` times, with a warning on stderr if it still has not
    converged.  ``profiler`` (a :class:`~srba_tpu_torch.utils.profiler.
    Profiler`) records the scopes ``pgo_chordal``, ``pgo_linearize``,
    ``pgo_cg`` and ``pgo_eval`` (each waits for the device before it
    closes), the counters ``pgo_solves`` and ``pgo_host_syncs``, and
    ``pgo_incidence_width``, the width of the incidence table.  With
    ``mesh`` the edges are split over its ranks (:func:`make_pgo_spmd`,
    escalations too; the edge bucket padded to a multiple of the mesh
    size), on the mesh's device, which must be of ``device``'s type."""
    dev = resolve_device(device)
    if mesh is not None:
        if mesh_device(mesh).type != dev.type:
            raise ValueError(f"device {str(device)!r} on a "
                             f"{mesh.device_type} mesh")
        dev = mesh_device(mesh)
    group_name = problem["group"]
    if cfg is None:
        cfg = PGOConfig(group=group_name)
    assert cfg.group == group_name
    nodes = np.asarray(problem["nodes"], np.float32)
    edges = problem["edges"]
    E = len(edges)
    K = nodes.shape[0]
    if E == 0:
        return nodes, {"err_init": 0.0, "err_final": 0.0, "iters": 0,
                       "converged": 1}
    ea = np.asarray([e["from"] for e in edges], np.int32)
    eb = np.asarray([e["to"] for e in edges], np.int32)
    z = np.stack([np.asarray(e["rel_pose"], np.float32) for e in edges])
    if weights is None:
        weights = problem.get("edge_weights")
    w = (np.ones(E, np.float32) if weights is None
         else np.asarray(weights, np.float32))
    Wsqrt = problem.get("edge_info_sqrt")
    if Wsqrt is not None:
        Wsqrt = np.asarray(Wsqrt, np.float32)
        cfg = dataclasses.replace(cfg, use_edge_info=True)
    elif cfg.use_edge_info:
        dof = 3 if nodes.shape[1] == 3 else 6
        Wsqrt = np.tile(np.eye(dof, dtype=np.float32), (E, 1, 1))

    # Power-of-two shape buckets, as in the JAX package (there they bound
    # the number of compiled programs): padding nodes are identities with
    # no edge (damped diagonal identity, delta exactly 0), padding edges
    # have weight 0 and are anchored at node 0.
    Kp = max(256, 1 << (K - 1).bit_length())
    Ep = max(256, 1 << (E - 1).bit_length())
    if Kp != K:
        pad_nodes = np.tile(nodes[:1] * 0, (Kp - K, 1))
        if nodes.shape[1] == 7:
            pad_nodes[:, 3] = 1.0        # identity quaternion
        nodes = np.concatenate([nodes, pad_nodes])
    if mesh is not None:
        Ep = -(-Ep // mesh.size()) * mesh.size()
    # The incidence table holds the live edges only: the Ep - E padding
    # edges would all sit at node 0 and widen it to their number, and they
    # add exact zeros.
    inc = None if mesh is not None else EdgeIncidence(ea, eb, Kp, Ep, dev)
    if Ep != E:   # pad with weight-0 self-anchored edges
        pad = Ep - E
        ea = np.concatenate([ea, np.zeros(pad, np.int32)])
        eb = np.concatenate([eb, np.zeros(pad, np.int32)])
        z = np.concatenate([z, np.tile(z[:1], (pad, 1))])
        w = np.concatenate([w, np.zeros(pad, np.float32)])
        if Wsqrt is not None:
            Wsqrt = np.concatenate([Wsqrt, np.tile(
                np.eye(Wsqrt.shape[-1], dtype=np.float32), (pad, 1, 1))])

    def to_dev(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    if mesh is not None:
        def solve(cfg, G0, lam):
            return make_pgo_spmd(cfg, mesh)(
                G0, ea, eb, z, w, lam, Wsqrt, num_live=E, profiler=profiler)
    else:
        ea_d, eb_d = to_dev(ea, torch.int64), to_dev(eb, torch.int64)
        z_d, w_d = to_dev(z), to_dev(w)
        Wsqrt_d = None if Wsqrt is None else to_dev(Wsqrt)

        def solve(cfg, G0, lam):
            return _make_pgo(cfg)(G0, ea_d, eb_d, z_d, w_d, lam, Wsqrt_d,
                                  incidence=inc, profiler=profiler)

    G, info = solve(cfg, to_dev(nodes), cfg.lam0 if lam0 is None else lam0)
    err0, iters = float(info["err_init"]), float(info["iters"])
    # Unconverged at the iteration cap: warm-restart from the current
    # iterate AND current lambda, with chordal init off (it would reset the
    # iterate).
    esc = 0
    while not bool(info["converged"]) and esc < max_escalations:
        esc += 1
        G, info = solve(dataclasses.replace(cfg, chordal_init=False), G,
                        info["lam"])
        iters += float(info["iters"])
    if not bool(info["converged"]):
        print(f"[srba] WARNING: global PGO unconverged after {iters:.0f} LM "
              f"iterations ({esc} escalations); err "
              f"{err0:.3e}->{float(info['err_final']):.3e}",
              file=sys.stderr, flush=True)
    out = {k: float(v) for k, v in info.items()}
    out.update(err_init=err0, iters=iters, escalations=float(esc))
    return G.cpu().numpy()[:K], out
