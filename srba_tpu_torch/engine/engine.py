"""SrbaEngine — the public API orchestrator, port of
:mod:`srba_tpu.engine.engine` (the reference's ``RbaEngine``).

Ported so far: the device-master incremental path on SE(2) and SE(3) for
every observation model — range-bearing, Cartesian, and the monocular,
stereo and RGB-D cameras (with their calibration and an SE(3) sensor
mount); monocular landmarks without an init are held pending and
materialized by deferred two-view triangulation
(:mod:`srba_tpu_torch.engine.triangulate`) — graph-SLAM mode
(relative-pose observations of earlier keyframes as fixed pose landmarks,
with a kf2kf edge to every observed keyframe beyond the tree depth), the
chain and local-areas edge-creation policies with measurement-bootstrapped
loop closures (:mod:`srba_tpu_torch.engine.closure`: Kabsch for models
with an inverse, multi-start PnP for the monocular camera; strong fits
become edges at once, weak ones wait for a stronger fit or age out,
rejected areas cool down), odometry/dead-reckoned edge seeds, and the
global-map entry points ``optimize_global`` (the global pose-graph
optimization over all kf2kf edges, periodic or terminal, written back into
the device masters) and ``bfs_visitor``.  That is what configs #1-#5 run.
Beside it: the host-window mode (``device_master=False``: the host state
is authoritative, each window is uploaded, solved and written back),
``optimize_edges`` (an explicit list of unknowns), and the map-parallel
``refine_map`` (block-coordinate sweeps of many windows in one batched
solve, :mod:`srba_tpu_torch.solver.multi_window`).  And the mesh paths
(:mod:`srba_tpu_torch.parallel`): ``SrbaEngine(mesh=...)`` solves every
window observation-sharded over the mesh's ranks, ``refine_map(mesh=...)``
splits a sweep's windows over them and ``optimize_global(mesh=...)`` the
global pose graph's edges; every rank passes the same full host arrays.

Per keyframe the host does the integer work (allocation, edge-creation
policy, spanning-tree paths, window selection — in the device-master mode
by the native C++ core, :mod:`srba_tpu_torch.native`, as the JAX engine
does — closure fits on the host mirror) and the device runs ONE step over
the padded window (:mod:`srba_tpu_torch.solver.master`); nothing is read
back until a caller or a closure fit asks for state.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from srba_tpu_torch.ecps import ClassicLinearRBA
from srba_tpu_torch.engine.closure import bootstrap_closure_edge
from srba_tpu_torch.engine.device_master import DeviceMaster
from srba_tpu_torch.engine.state import ProblemState
from srba_tpu_torch.graph.spantree import KeyframeGraph
from srba_tpu_torch.models.landmarks import (LANDMARK_TYPES, Euclidean2D,
                                             Euclidean3D)
from srba_tpu_torch.models.noise import NoiseIdentity
from srba_tpu_torch.engine.triangulate import MonoTriangulator
from srba_tpu_torch.models.observations import (OBSERVATION_MODELS,
                                                CameraCalib, StereoCalib,
                                                calib_constants)
from srba_tpu_torch.models.sensor_pose import SensorPoseNone
from srba_tpu_torch.ops.np_lie import np_group_for
from srba_tpu_torch.parallel.sharding import make_spmd_solver, mesh_device
from srba_tpu_torch.solver.lm import SolverConfig, WindowBatch, get_solver
from srba_tpu_torch.solver.master import INFO_KEYS
from srba_tpu_torch.solver.window import build_window, write_back
from srba_tpu_torch.utils.device import resolve_device
from srba_tpu_torch.utils.profiler import Profiler
from srba_tpu_torch.utils.registry import lookup


@dataclass
class SrbaParams:
    """Runtime parameters — the fields of the JAX package's ``SrbaParams``
    (analog of the reference's ``TSRBAParameters``) that the ported path
    reads, with the same defaults; see there for each knob's rationale."""

    max_tree_depth: int = 4
    max_optimize_depth: int = 4
    use_robust_kernel: bool = False
    kernel_param: float = 3.0
    verbose: int = 0
    extra_obs_per_lm_cap: Optional[int] = None
    # Loop-closure bootstrap (engine/closure.py): closure edges start from a
    # fit to the re-observed landmarks, not from drifted estimates.
    closure_bootstrap: bool = True
    # Pixel-RMS gate of the monocular fit: worse fits are rejected (the
    # area cools down and the ECP re-votes on later frames).
    closure_gate_px: float = 25.0
    # A fit whose predicted worst-direction pose sigma is below this is
    # STRONG (edge now); up to ``closure_accept_sigma_factor`` times it is
    # WEAK (held pending, weighted 1/sigma^2); beyond, the area is deferred.
    # None disables sigma gating.
    closure_max_sigma: Optional[float] = 0.3
    closure_accept_sigma_factor: float = 3.0
    # Keyframes an area center is skipped after its fit hard-rejects.
    closure_retry_cooldown: int = 4
    # Keyframes a weak fit waits for a strong one before it becomes an edge.
    closure_pending_flush_age: int = 8
    # Edge measurement priors: the edge's creation-time measured value
    # (odometry) kept as a weak factor of weight 1/sigma^2 in every window
    # solve (scaled down by hop count for dead-reckoned seeds).  None
    # disables the priors.
    edge_prior_sigma: Optional[float] = 0.05
    # Reference sigma of closure-edge information in the global PGO export
    # (io/export.py): a closure fit with this sigma keeps weight 1, others
    # scale quadratically (clipped).
    closure_prior_sigma: float = 0.25
    # Staleness budget (optimization steps) of the host mirror behind the
    # edge-seed cache and the closure fits, and the async prefetch cadence
    # (every max_age/2).
    closure_mirror_max_age: int = 16
    # Fits on a stale mirror whose gate ratio is <= this (every accept, by
    # design) are redone against an exact sync before an edge goes in; far
    # rejects are deferred without the blocking download.
    closure_reverify_band: float = 2.0
    max_iters: int = 20
    # Iteration cap of ordinary per-keyframe incremental steps
    # (closure-active frames and explicit optimize_local_area calls run
    # ``max_iters``).
    incremental_max_iters: int = 10
    lam0: float = 1e-4
    rel_tol: float = 1e-6
    solver: str = "schur_dense_cholesky"
    # Monocular front-end (engine/triangulate.py): a new landmark seen
    # without an init is held pending and materialized by two-view midpoint
    # triangulation once a sighting with at least this parallax exists
    # (its buffered observations replayed).  None requires every monocular
    # init from the caller (the reference's contract).
    mono_min_parallax_deg: Optional[float] = 1.0


@dataclass
class Observation:
    """One landmark sighting handed to ``define_new_keyframe``.

    ``fixed_rel_pos``: landmark with exactly known position in its base frame
    (excluded from optimization).  ``init_rel_pos``: explicit initial value
    for a new unknown landmark (default: the inverse sensor model; for the
    monocular camera, deferred triangulation, or a ``ValueError`` with
    ``mono_min_parallax_deg=None``)."""

    lm_id: int
    z: Any
    fixed_rel_pos: Optional[Any] = None
    init_rel_pos: Optional[Any] = None


@dataclass
class TNewKeyFrameInfo:
    """Result of ``define_new_keyframe`` (reference ``TNewKeyFrameInfo``)."""

    kf_id: int = -1
    created_edge_ids: List[int] = field(default_factory=list)
    optimize_results: Dict[str, float] = field(default_factory=dict)


class SrbaEngine:
    def __init__(
        self,
        obs_model: str,
        lm_type: Optional[str] = None,
        ecp: Any = None,
        noise: Any = None,
        sensor_pose: Any = None,
        calib: Any = None,
        params: Optional[SrbaParams] = None,
        device_master: bool = True,
        mesh=None,
        device="cuda",
    ):
        # SPMD window solves: with a mesh, every window is solved
        # observation-sharded over its ranks (each rank passes the same full
        # host arrays; see parallel/multihost.py), on the rank's device.
        # The device-master mode is single-device, so a mesh forces the
        # host-window mode, as in the JAX package.
        if mesh is not None:
            if resolve_device(device).type != mesh.device_type:
                raise ValueError(f"device {str(device)!r} on a "
                                 f"{mesh.device_type} mesh")
            device_master = False
            device = mesh_device(mesh)
        self.mesh = mesh
        if calib is not None and not isinstance(calib,
                                                (CameraCalib, StereoCalib)):
            raise NotImplementedError(
                "calibrated observation models take a CameraCalib or a "
                f"StereoCalib; calib {type(calib).__name__} is not ported "
                "to srba_tpu_torch")
        self.model = lookup(OBSERVATION_MODELS, obs_model,
                            "observation model")
        self.group = self.model.pose_group
        self.np_group = np_group_for(self.group)
        if lm_type is None:
            if self.model.is_pose_landmark:
                lm_type = self.model.name  # RelativePoses2D/3D landmark
            else:
                lm_type = (Euclidean2D.name if self.model.lm_dim == 2
                           else Euclidean3D.name)
        self.lm_type = lookup(LANDMARK_TYPES, lm_type, "landmark type")
        self.ecp = ecp if ecp is not None else ClassicLinearRBA()
        self.noise = noise if noise is not None else NoiseIdentity(1.0)
        self.sensor_pose = (sensor_pose if sensor_pose is not None
                            else SensorPoseNone())
        # Host calibration (float32 numpy scalars: inverse-model landmark
        # inits and closure fits) and its device form (Python floats).
        self.calib = calib
        self._calib_np = calib
        self._calib_dev = calib_constants(calib)
        self.parameters = params if params is not None else SrbaParams()
        self.profiler = Profiler()

        self.state = ProblemState(
            pose_dim=self.group.dim,
            lm_dim=self.lm_type.dim,
            z_dim=self.model.z_dim,
        )
        self.graph = KeyframeGraph(self.parameters.max_tree_depth)
        # Device-resident master state: the authoritative copy of edge poses
        # and landmark states lives on ``device``; the host numpy tables
        # above are a lazily refreshed mirror.  Without it (the host-window
        # mode) the host tables are authoritative and each window solve
        # uploads its window and writes the result back.
        self.device = resolve_device(device)
        self.device_master = (
            DeviceMaster(self.group.dim, self.lm_type.dim,
                         device=self.device)
            if device_master else None)
        # Native (C++) host graph service (srba_tpu_torch.native): builds
        # every device-master window (and the refine_map sweep windows);
        # the Python graph above keeps serving the public traversal APIs.
        # The Python builder takes its place only where no g++ exists,
        # SRBA_TPU_TORCH_NO_NATIVE is set or the tree is deeper than the
        # C++ core's buffers.  The host-window mode keeps the Python
        # builder, which gathers the window's floats.
        self.native = None
        if device_master:
            from srba_tpu_torch.native import get_lib
            from srba_tpu_torch.native.core import MAX_TREE_DEPTH, NativeCore
            if (get_lib() is not None
                    and self.parameters.max_tree_depth <= MAX_TREE_DEPTH):
                self.native = NativeCore(self.parameters.max_tree_depth)
        # The device-master windows' padded (E, L, N) per optimize depth: a
        # window is padded to at least the last shape at its depth, so
        # shapes never shrink (the JAX package's ratchet), whichever builder
        # runs.
        self._window_caps = {}

        self._whitener = np.asarray(
            self.noise.whitener(self.model.obs_dim), np.float32)
        sp = np.asarray(self.sensor_pose.pose_for(self.group), np.float32)
        self._sensor_pose = sp
        self._sensor_pose_inv = np.asarray(self.np_group.inverse(sp),
                                           np.float32)
        self._use_sensor_pose = not self.sensor_pose.is_identity

        # External feature id -> dense internal landmark index.
        self._lm_id_map: Dict[int, int] = {}
        # Dead-reckoned global pose per KF (host, odometry-composed): seeds
        # primary-link edge initials without device syncs.
        self._G_dr: List[np.ndarray] = []
        # Throttled optimized-global-pose cache for edge seeding without
        # odometry: (num_kfs at build, G array, dist map).
        self._seed_cache = None
        self._seed_cache_max_age = 25
        # Area centers whose last closure fit hard-rejected: center -> first
        # keyframe id allowed to retry (SrbaParams.closure_retry_cooldown).
        self._closure_cooldown: Dict[int, int] = {}
        # Best WEAK closure fit per area center, held pending until a strong
        # fit supersedes it or the flush age passes:
        # center -> {sigma, T, info, kf, first_kf}.
        self._closure_pending: Dict[int, Dict[str, Any]] = {}
        # Step seq of the last accepted closure's refinement: a stale mirror
        # is never accepted from before this point.
        self._closure_barrier_seq = 0
        self._tri = None   # lazy MonoTriangulator (monocular deferred inits)

        self._solver_cfg = SolverConfig(
            obs_model=self.model.name,
            pose_group=self.group.name,
            lm_type=self.lm_type.name,
            max_depth=self.parameters.max_tree_depth,
            use_sensor_pose=self._use_sensor_pose,
            use_robust_kernel=self.parameters.use_robust_kernel,
            kernel_param=self.parameters.kernel_param,
            max_iters=self.parameters.max_iters,
            lam0=self.parameters.lam0,
            rel_tol=self.parameters.rel_tol,
            solver=self.parameters.solver,
        )

    # ------------------------------------------------------------------
    # Internal: state mutation + device staging
    # ------------------------------------------------------------------

    def _add_edge(self, from_kf: int, to_kf: int, pose: np.ndarray,
                  prior_w: float = 0.0, sigma: float = 0.0,
                  info=None) -> int:
        e = self.state.add_edge(from_kf, to_kf, pose, prior_w=prior_w,
                                sigma=sigma, info=info)
        if self.device_master is not None:
            self.device_master.stage_edge(pose, prior_w)
        self.graph.add_edge(from_kf, to_kf)
        if self.native is not None:
            self.native.add_edge(from_kf, to_kf)
        return e

    def _add_landmark(self, base_kf: int, st: np.ndarray,
                      fixed: bool = False) -> int:
        l = self.state.add_landmark(base_kf, st, fixed=fixed)
        if self.device_master is not None:
            self.device_master.stage_landmark(st)
        if self.native is not None:
            self.native.add_landmark(base_kf, fixed)
        return l

    def sync(self, max_age: int = 0) -> None:
        """Refresh the host mirror of edge poses / landmark states from the
        device masters (one download; no-op when clean).  ``max_age``
        accepts a mirror up to that many optimization steps stale, though
        never one from before the last accepted closure's refinement (the
        barrier: after a closure the map moves wholesale).  A no-op in the
        host-window mode, whose host tables are authoritative."""
        if self.device_master is None:
            return
        self.device_master.sync_to_host(
            self.state.k2k_pose, self.state.lm_state, max_age=max_age,
            min_seq=self._closure_barrier_seq if max_age else 0)

    def fence(self) -> None:
        """Wait for all queued device work WITHOUT downloading state (use
        around timing sections; ``sync`` additionally refreshes the host
        mirror; a no-op in the host-window mode, whose solves end in a
        download)."""
        if self.device_master is not None:
            self.device_master.fence()

    # ------------------------------------------------------------------
    # Core per-frame API
    # ------------------------------------------------------------------

    def define_new_keyframe(
        self,
        observations: Sequence[Observation],
        run_local_optimization: bool = True,
        edge_init: Optional[Dict[int, Any]] = None,
    ) -> TNewKeyFrameInfo:
        """Add a keyframe with its observations: allocate, run the
        edge-creation policy, ingest observations (initializing new landmarks
        via the inverse sensor model), then locally optimize."""
        info = TNewKeyFrameInfo()
        prof = self.profiler
        with prof.scope("define_new_keyframe"):
            with prof.scope("alloc"):
                kf_id = self.state.add_keyframe()
                self.graph.add_keyframe()
                if self.native is not None:
                    self.native.add_keyframe()
                info.kf_id = kf_id

            known_lms = [self._lm_id_map[o.lm_id] for o in observations
                         if o.lm_id in self._lm_id_map]

            with prof.scope("ecp"):
                out = self.ecp.edges_for_new_kf(
                    self.state, self.graph, kf_id, known_lms)
                if isinstance(out, tuple):
                    primary_targets, closure_targets = out
                else:  # user policy returning a flat list: all primary
                    primary_targets, closure_targets = list(out), []
                closure_created = self._create_edges(
                    kf_id, primary_targets, closure_targets, edge_init,
                    observations, info)
                if self.model.is_pose_landmark:
                    self._create_graph_slam_edges(kf_id, observations, info)

            with prof.scope("ingest"):
                # Batch the inverse-sensor-model landmark inits: one call
                # per keyframe instead of one per new landmark.
                inits = self._batch_landmark_inits(observations)
                for i, o in enumerate(observations):
                    self.add_observation(
                        kf_id, o.lm_id, o.z,
                        fixed_rel_pos=o.fixed_rel_pos,
                        init_rel_pos=inits.get(i, o.init_rel_pos),
                    )

            if run_local_optimization and kf_id > 0:
                with prof.scope("optimize_local_area"):
                    # A fresh closure edge is refined at the FULL tree depth,
                    # whose window reaches the revisited area's landmarks on
                    # both sides of the closure.
                    depth = self.parameters.max_optimize_depth
                    if closure_created:
                        depth = max(depth, self.parameters.max_tree_depth)
                    # Closure-ACTIVE frames (an edge was created OR the ECP
                    # voted one, even if the fit deferred) run the full
                    # budget (iteration cap 0 = max_iters).
                    closure_active = closure_created or bool(closure_targets)
                    info.optimize_results = self.optimize_local_area(
                        kf_id, depth,
                        _iters_cap=(0 if closure_active else
                                    self.parameters.incremental_max_iters))
            elif self.device_master is not None:
                # No solve this frame: still push staged rows to the device
                # masters so they stay authoritative.
                self.device_master.flush_append()

            dm = self.device_master   # None in the host-window mode
            if dm is not None and closure_created:
                # The refinement step just queued moves the map wholesale:
                # raise the staleness barrier and start a post-closure
                # prefetch now.
                self._closure_barrier_seq = dm.step_seq
                dm.maybe_prefetch(self.parameters.closure_mirror_max_age,
                                  force=True)
            elif dm is not None:
                # Steady async prefetch cadence (internally throttled to
                # every max_age/2 steps): stale-tolerant consumers (closure
                # fits, the seed cache) take an already-landed copy instead
                # of a blocking download.
                dm.maybe_prefetch(self.parameters.closure_mirror_max_age)
        if self.parameters.verbose >= 1:
            print(f"[srba] kf={kf_id} edges+={len(info.created_edge_ids)} "
                  f"opt={info.optimize_results}")
        return info

    def _create_edges(self, kf_id: int, primary_targets, closure_targets,
                      edge_init, observations,
                      info: TNewKeyFrameInfo) -> bool:
        """Create the new keyframe's primary (local) and loop-closure edges,
        flush aged-out weak closure fits and record the keyframe's
        dead-reckoned global pose.  Primary seeds: the given odometry
        (``edge_init``), else the dead-reckoned trajectory, else the
        throttled optimized global estimate.  Closure seeds: a fit to the
        re-observed landmarks (``closure_bootstrap``).  Returns whether a
        closure edge was created."""
        g = self.np_group
        par = self.parameters
        # Dead-reckoned global estimate of the NEW keyframe, anchored by any
        # provided edge_init (odometry).
        G_dr_new = None
        if edge_init:
            for t0, e0 in edge_init.items():
                if 0 <= t0 < kf_id and t0 < len(self._G_dr):
                    G_dr_new = g.compose(
                        self._G_dr[t0],
                        g.inverse(np.asarray(e0, np.float32)))
                    break

        def _seed_from(G_new, G_t):
            # Edge stores T_new<-t;  G[new] = G[t] o inv(T).
            return np.asarray(g.compose(g.inverse(G_new), G_t), np.float32)

        synced_for_boot = False
        closure_created = False
        p_sigma = par.edge_prior_sigma
        if self.model.is_pose_landmark:
            # Graph-SLAM mode: every observation IS a direct edge
            # measurement, so windows are never visually degenerate and an
            # odometry prior would double-count/outvote the loop-closure
            # observations (whose whitened weight the prior knows nothing
            # about).
            p_sigma = None
        for which, targets in (("primary", primary_targets),
                               ("closure", closure_targets)):
            for t in targets:
                # Prior weight: how much the seed is a MEASUREMENT.
                prior_w = 0.0
                fit_info = None   # closure fit JtJ (anisotropic)
                if edge_init is not None and t in edge_init:
                    init = np.asarray(edge_init[t], np.float32)
                    if p_sigma:
                        prior_w = 1.0 / (p_sigma * p_sigma)
                elif which == "primary" and G_dr_new is not None \
                        and t < len(self._G_dr):
                    # Local link: dead-reckoned seed.
                    init = _seed_from(G_dr_new, self._G_dr[t])
                    if p_sigma:
                        # Composition of ~|kf-t| odometry steps: variance
                        # grows linearly with hop count.
                        hops = max(abs(kf_id - t), 1)
                        prior_w = 1.0 / (p_sigma * p_sigma * hops)
                else:
                    # Distant re-visit (or no odometry anchor): seed from the
                    # optimized global estimate.
                    g_new = self._global_est_new(G_dr_new)
                    g_t = self._global_est(t)
                    if g_new is not None and g_t is not None:
                        init = _seed_from(g_new, g_t)
                    else:
                        init = g.identity()
                sigma = 0.0
                if which == "closure" and par.closure_bootstrap:
                    if kf_id < self._closure_cooldown.get(t, 0):
                        continue   # recently hard-rejected: defer
                    pend = self._closure_pending.get(t)
                    if pend is not None and G_dr_new is not None \
                            and pend["kf"] < len(self._G_dr):
                        # The cached weak fit is the best seed: compose it
                        # forward by the few-frame dead-reckoned delta.
                        init = np.asarray(g.compose(
                            _seed_from(G_dr_new, self._G_dr[pend["kf"]]),
                            pend["T"]), np.float32)
                    with self.profiler.scope("closure_bootstrap"):
                        status, T, sigma, fit_info, synced_for_boot = \
                            self._fit_closure(t, observations, init,
                                              synced_for_boot)
                    if status == "ok":
                        init = np.asarray(T, np.float32)
                        # Measured-covariance weighting: the fit's own sigma
                        # (floored at the odometry-grade edge_prior_sigma)
                        # sets the prior weight.
                        sigma = max(float(sigma),
                                    par.edge_prior_sigma or 0.05)
                        if p_sigma:
                            prior_w = 1.0 / (sigma * sigma)
                        self._closure_pending.pop(t, None)
                    elif status == "weak":
                        # Cache the best weak fit; it becomes an edge only
                        # if no strong fit arrives (flush below).
                        if pend is None or sigma < pend["sigma"]:
                            self._closure_pending[t] = {
                                "sigma": float(sigma),
                                "T": np.asarray(T, np.float32),
                                "info": fit_info,
                                "kf": kf_id,
                                "first_kf": (pend or {}).get("first_kf",
                                                             kf_id)}
                        continue      # defer edge creation
                    elif status == "reject":
                        self._closure_cooldown[t] = (
                            kf_id + par.closure_retry_cooldown)
                        continue      # defer: the ECP re-votes later
                    else:
                        sigma = 0.0   # n/a: estimate-based seed
                e = self._add_edge(kf_id, t, init, prior_w=prior_w,
                                   sigma=sigma, info=fit_info)
                info.created_edge_ids.append(e)
                if which == "closure":
                    closure_created = True
                    # An edge to this center now exists: a pending weak fit
                    # must not flush a duplicate later.
                    self._closure_pending.pop(t, None)

        # Flush aged-out pending weak closures: no strong fit arrived within
        # the flush window, so the best weak fit becomes the edge, valued at
        # its own fit and weighted by its sigma.  Edge endpoints are
        # (kf_at_fit, center); the graph is append-only, so an edge at a
        # slightly older keyframe is always valid.
        if self._closure_pending:
            age = par.closure_pending_flush_age
            for c in [c for c, r in self._closure_pending.items()
                      if kf_id - r["first_kf"] >= age]:
                info.created_edge_ids.append(
                    self._add_pending_closure(c, p_sigma))
                closure_created = True

        # Record the new KF's dead-reckoned global pose: prefer the odometry
        # anchor; else derive from the first created edge.
        if G_dr_new is None and info.created_edge_ids:
            e0 = info.created_edge_ids[0]
            t0 = int(self.state.k2k_to[e0])
            if t0 < len(self._G_dr):
                G_dr_new = g.compose(self._G_dr[t0],
                                     g.inverse(self.state.k2k_pose[e0]))
        self._G_dr.append(G_dr_new if G_dr_new is not None
                          else np.asarray(g.identity(), np.float32))
        return closure_created

    def _fit_closure(self, center: int, observations, init, synced: bool):
        """One closure fit to ``center`` (engine/closure.py) on a loosely
        fresh mirror (at most ``closure_mirror_max_age`` steps old, synced
        once per frame); a fit that passes or nearly passes is redone on the
        exact device state before anyone acts on it.  Returns ``(status, T,
        sigma, info, synced)``.  Counts each fit's outcome and each
        re-verifying download in the profiler (``closure_<status>``,
        ``closure_reverify_syncs``)."""
        par = self.parameters
        voters = self._closure_voters(observations, center)
        if voters and not synced:
            # A reject on slightly stale data just re-votes next frame, so
            # no blocking download is spent here.
            self.sync(max_age=par.closure_mirror_max_age)
            synced = True
        status, T, ratio, sigma, fit_info = bootstrap_closure_edge(
            self, center, voters, init)
        if self.device_master is not None and self.device_master.dirty \
                and status != "n/a" \
                and ratio <= par.closure_reverify_band:
            # Fresh voter positions flip marginal outcomes in BOTH
            # directions, so accepts, weaks and near rejects all re-verify
            # against the exact state (one blocking download); far rejects
            # cost nothing.
            self.profiler.count("closure_reverify_syncs")
            self.sync()
            status, T, ratio, sigma, fit_info = bootstrap_closure_edge(
                self, center, voters, init)
        self.profiler.count(f"closure_{status}")
        return status, T, sigma, fit_info, synced

    def _add_pending_closure(self, center: int, p_sigma) -> int:
        """Turn the pending weak fit to ``center`` into its edge (counted
        as ``closure_flushed``)."""
        self.profiler.count("closure_flushed")
        rec = self._closure_pending.pop(center)
        sig = max(rec["sigma"], self.parameters.edge_prior_sigma or 0.05)
        return self._add_edge(
            rec["kf"], center, rec["T"],
            prior_w=(1.0 / (sig * sig) if p_sigma else 0.0),
            sigma=sig, info=rec.get("info"))

    def flush_pending_closures(self) -> int:
        """Materialize every still-pending weak closure fit now (normally
        they flush after ``closure_pending_flush_age`` keyframes; call this
        before a terminal global refinement so fits cached near the end of
        a sequence are not lost).  Returns the number of edges created.
        ``optimize_global`` and ``refine_map`` call it first."""
        n = 0
        for c in list(self._closure_pending):
            self._add_pending_closure(c, self.parameters.edge_prior_sigma)
            n += 1
        return n

    def _closure_voters(self, observations, center: int):
        """Re-observed landmarks usable to bootstrap a closure edge to
        ``center``: known landmarks whose base KF is reachable from the
        center within the tree depth."""
        out = []
        depth = self.parameters.max_tree_depth
        for o in observations:
            lm = self._lm_id_map.get(o.lm_id)
            if lm is None:
                continue
            base = int(self.state.lm_base[lm])
            if base == center or self.graph.path(
                    center, base, depth) is not None:
                out.append((lm, np.asarray(o.z, np.float32)))
        return out

    def _create_graph_slam_edges(self, kf_id: int, observations,
                                 info: TNewKeyFrameInfo) -> None:
        """Graph-SLAM mode: observing a keyframe that is unreachable within
        the tree depth IS a loop closure — create the kf2kf edge,
        initialized from the measured relative pose itself (no prior)."""
        for o in observations:
            j = o.lm_id
            if not 0 <= j < kf_id:
                raise ValueError(
                    "graph-SLAM observations must reference existing "
                    f"keyframes; got {j} at kf {kf_id}")
            if self.graph.path(kf_id, j,
                               self.parameters.max_tree_depth) is None:
                e = self._add_edge(kf_id, j, np.asarray(o.z, np.float32))
                info.created_edge_ids.append(e)

    def _seed_globals(self):
        """Optimized global estimate, rebuilt at most every
        ``_seed_cache_max_age`` KFs from a stale-tolerant mirror; newer KFs
        are covered by dead-reckoned increments from the cache's anchor."""
        c = self._seed_cache
        if c is None or (self.state.num_kfs - c[0]
                         > self._seed_cache_max_age):
            G, dist = self.create_complete_spanning_tree(
                0, _mirror_max_age=self.parameters.closure_mirror_max_age)
            c = (self.state.num_kfs, G, dist)
            self._seed_cache = c
        return c

    def _global_est(self, k):
        """Global estimate of existing KF k (None if unknown)."""
        g = self.np_group
        n0, G, dist = self._seed_globals()
        if k < len(G) and k in dist:
            return G[k]
        anchor = n0 - 1
        if anchor in dist and k < len(self._G_dr) \
                and anchor < len(self._G_dr):
            return g.compose(G[anchor], g.compose(
                g.inverse(self._G_dr[anchor]), self._G_dr[k]))
        return None

    def _global_est_new(self, G_dr_new):
        """Global estimate of the NEW keyframe (pre-edges)."""
        if G_dr_new is None:
            return None
        g = self.np_group
        n0, G, dist = self._seed_globals()
        anchor = n0 - 1
        if anchor in dist and anchor < len(self._G_dr):
            return g.compose(G[anchor], g.compose(
                g.inverse(self._G_dr[anchor]), G_dr_new))
        return G_dr_new

    def add_observation(self, kf_id: int, lm_id: int, z,
                        fixed_rel_pos=None, init_rel_pos=None) -> int:
        """Register one observation; first sighting of a landmark makes
        ``kf_id`` its base KF and initializes its relative state (reference
        ``add_observation`` + ``inverse_sensor_model``).

        Returns the observation id, or -1 when the landmark is monocular
        with no init and the deferred-triangulation front-end is on: the
        sighting is buffered (``num_pending_landmarks``) and replayed once
        the landmark triangulates, based at its first sighting's KF."""
        z = np.asarray(z, np.float32)
        if z.shape != (self.model.z_dim,):
            raise ValueError(
                f"observation must be {self.model.z_dim}-d, got {z.shape}")
        internal = self._lm_id_map.get(lm_id)
        if internal is None and self.model.is_pose_landmark:
            # Graph-SLAM mode: the 'landmark' for keyframe j is the IDENTITY
            # pose fixed at base j itself, so every observation of j
            # constrains the spanning-tree path of kf2kf edges between
            # observer and j.
            internal = self._add_landmark(
                lm_id, np.asarray(self.np_group.identity(), np.float32),
                fixed=True)
            self._lm_id_map[lm_id] = internal
        if internal is None:
            # New landmark: allocate with base = observing KF.
            if fixed_rel_pos is not None:
                st = np.asarray(fixed_rel_pos, np.float32)
                internal = self._add_landmark(kf_id, st, fixed=True)
            elif (init_rel_pos is None and not self.model.has_inverse_model
                  and self.parameters.mono_min_parallax_deg is not None):
                # Monocular deferred init: buffer the sighting; materialize
                # by two-view triangulation once parallax suffices.
                tri = self._triangulator()
                tri.hold(lm_id, kf_id, z)
                hit = tri.try_init(lm_id)
                if hit is None:
                    return -1          # still pending
                base_kf, pt, buffered = hit
                internal = self._add_landmark(base_kf, pt, fixed=False)
                self._lm_id_map[lm_id] = internal
                oid = -1
                for kf_b, z_b in buffered:   # replay (this sighting too)
                    if self.native is not None:
                        self.native.add_observation(kf_b, internal)
                    oid = self.state.add_observation(kf_b, internal, z_b)
                return oid
            else:
                st = self._init_landmark(z, init_rel_pos)
                internal = self._add_landmark(kf_id, st, fixed=False)
            self._lm_id_map[lm_id] = internal
        if self.native is not None:
            self.native.add_observation(kf_id, internal)
        return self.state.add_observation(kf_id, internal, z)

    def _batch_landmark_inits(self, observations) -> Dict[int, np.ndarray]:
        """Inverse-sensor-model inits for this frame's brand-new landmarks,
        computed in one batched host call.  Returns {obs_list_index: init}
        (none for a model without an inverse)."""
        if not self.model.has_inverse_model:
            return {}
        idxs, seen = [], set()
        for i, o in enumerate(observations):
            if (o.lm_id in self._lm_id_map or o.lm_id in seen
                    or o.fixed_rel_pos is not None
                    or o.init_rel_pos is not None):
                continue
            seen.add(o.lm_id)
            idxs.append(i)
        if not idxs:
            return {}
        zs = np.stack([np.asarray(observations[i].z, np.float32)
                       for i in idxs])
        # Numpy-in -> numpy-out inverse model (host path, no device hop).
        pts = np.asarray(self.model.inverse(zs, self._calib_np), np.float32)
        if self._use_sensor_pose and not self.model.is_pose_landmark:
            pts = self.np_group.apply(self._sensor_pose, pts)
        return {i: pts[j] for j, i in enumerate(idxs)}

    def _triangulator(self) -> MonoTriangulator:
        if self._tri is None:
            self._tri = MonoTriangulator(
                self, min_parallax_deg=self.parameters.mono_min_parallax_deg)
        return self._tri

    def _init_landmark(self, z: np.ndarray, init_rel_pos) -> np.ndarray:
        if init_rel_pos is not None:
            return np.asarray(init_rel_pos, np.float32)
        if not self.model.has_inverse_model:
            raise ValueError(
                f"{self.model.name} has no single-view inverse sensor model; "
                "pass init_rel_pos (or fixed_rel_pos) for new landmarks, or "
                "enable the deferred-triangulation front-end "
                "(SrbaParams.mono_min_parallax_deg)")
        # Inverse model gives the landmark in the SENSOR frame; map it into
        # the base-KF (robot) frame through the mounting pose.
        pt = np.asarray(self.model.inverse(z, self._calib_np), np.float32)
        if self.model.is_pose_landmark:
            return pt
        if self._use_sensor_pose:
            pt = self.np_group.apply(self._sensor_pose, pt)
        return pt.astype(np.float32)

    # ------------------------------------------------------------------
    # Optimization
    # ------------------------------------------------------------------

    def optimize_local_area(self, root_kf: int,
                            win_size: Optional[int] = None,
                            restrict_edges=None, restrict_lms=None,
                            _iters_cap: int = 0) -> Dict[str, float]:
        """BFS window around ``root_kf`` -> padded window -> LM+Schur ->
        write back (reference ``optimize_local_area``).  With
        ``restrict_edges`` / ``restrict_lms`` (sets of global ids) the
        unknowns are limited to those lists (``optimize_edges``); the others
        in the window stay fixed and come back bit-identical.

        Device-master mode: one device step (append + gather + solve +
        scatter), returning a :class:`LazyInfo` (nothing is downloaded until
        a value is read).  Host-window mode: the window is uploaded, solved
        by :func:`~srba_tpu_torch.solver.lm.get_solver`'s solver, fetched in
        one download and written into the host state (profiler scopes
        ``device_solve`` and ``write_back``), returning a dict of floats."""
        depth = (win_size if win_size is not None
                 else self.parameters.max_optimize_depth)
        master = self.device_master
        with self.profiler.scope("window_build"):
            built = self._build_window(root_kf, depth,
                                       self.parameters.max_tree_depth)
        if built is None:
            if master is not None:
                master.flush_append()
            return {"skipped": 1.0}
        arrays, plan = built

        if restrict_edges is not None:
            arrays.edge_opt *= np.asarray(
                [g in restrict_edges for g in arrays.edge_gids], np.float32)
            plan.edge_opt &= np.asarray(
                [g in restrict_edges for g in plan.edge_ids], bool)
        if restrict_lms is not None:
            arrays.lm_opt *= np.asarray(
                [g in restrict_lms for g in arrays.lm_gids], np.float32)
            plan.lm_opt &= np.asarray(
                [g in restrict_lms for g in plan.lm_ids], bool)

        if master is not None:
            # Append staged rows + gather + LM+Schur + scatter-back in ONE
            # step; nothing is downloaded (info values are fetched lazily).
            with self.profiler.scope("device_step"):
                return master.step(
                    self._solver_cfg, self._whitener, self._sensor_pose_inv,
                    self.calib,
                    arrays.edge_gids, arrays.edge_opt, arrays.lm_gids,
                    arrays.lm_opt, arrays.obs_lm, arrays.obs_valid,
                    arrays.path_edge, arrays.path_sign, arrays.obs_z,
                    iters_cap=_iters_cap)

        with self.profiler.scope("device_solve"):
            # Host arrays of the solver's dtypes; the solver uploads them
            # (with a mesh, each rank its shard of the observation rows).
            def host(a, dtype=np.float32):
                return np.asarray(a, dtype)

            batch = WindowBatch(
                edge_pose=host(arrays.edge_pose),
                edge_opt=host(arrays.edge_opt),
                lm_state=host(arrays.lm_state), lm_opt=host(arrays.lm_opt),
                obs_z=host(arrays.obs_z),
                obs_lm=host(arrays.obs_lm, np.int32),
                path_edge=host(arrays.path_edge, np.int32),
                path_sign=host(arrays.path_sign),
                obs_valid=host(arrays.obs_valid),
                whitener=host(self._whitener),
                sensor_pose_inv=host(self._sensor_pose_inv),
                calib=self._calib_dev,
                edge_prior=host(arrays.edge_prior),
                edge_prior_w=host(arrays.edge_prior_w),
                # The runtime LM iteration cap (0 = the full budget).
                iters_cap=_iters_cap if _iters_cap > 0 else None)
            if self.mesh is not None:
                solve, _ = make_spmd_solver(self._solver_cfg, self.mesh)
            else:
                solve, _ = get_solver(self._solver_cfg, self.device)
            edge_pose, lm_state, dev_info = solve(batch)
            # ONE download: the window's state and its info together.
            flat = torch.cat(
                [edge_pose.reshape(-1), lm_state.reshape(-1)]
                + [dev_info[k].to(torch.float32).reshape(1)
                   for k in INFO_KEYS]).cpu().numpy()
        n_e, n_l = edge_pose.numel(), lm_state.numel()
        with self.profiler.scope("write_back"):
            write_back(self.state, plan,
                       flat[:n_e].reshape(edge_pose.shape),
                       flat[n_e: n_e + n_l].reshape(lm_state.shape))
        return {k: float(v) for k, v in zip(INFO_KEYS, flat[n_e + n_l:])}

    def optimize_edges(self, k2k_edge_ids: Sequence[int],
                       landmark_ids: Optional[Sequence[int]] = None
                       ) -> Dict[str, float]:
        """Explicit-list variant (reference ``optimize_edges``): optimize
        EXACTLY the given edges (and landmarks, if listed — else every
        in-window non-fixed landmark), using the observations of the window
        rooted at the newest keyframe touching the edge set, with the full
        LM budget."""
        if not k2k_edge_ids:
            return {"skipped": 1.0}
        root = max(max(int(self.state.k2k_from[e]), int(self.state.k2k_to[e]))
                   for e in k2k_edge_ids)
        return self.optimize_local_area(
            root, self.parameters.max_optimize_depth,
            restrict_edges=set(int(e) for e in k2k_edge_ids),
            restrict_lms=(None if landmark_ids is None
                          else set(int(l) for l in landmark_ids)))

    def refine_map(self, sweeps: int = 1, stride: Optional[int] = None,
                   depth: Optional[int] = None, mesh=None,
                   prior_scale: float = 0.02) -> Dict[str, float]:
        """Map-parallel refinement: block-coordinate LM sweeps over the whole
        map — windows around every ``stride``-th keyframe are solved
        SIMULTANEOUSLY in one batched solve per phase, each unknown owned by
        exactly one window per sweep (disjoint writes; see
        :mod:`srba_tpu_torch.solver.multi_window`).  Each sweep is two
        red-black phases over a root lattice staggered by half a stride
        every other sweep.  Requires the device-master mode.

        ``prior_scale`` scales the edge measurement priors' weights inside
        the sweep windows (the device prior table itself is untouched); the
        JAX package's docstring gives the measurement behind the default
        0.02.  With ``mesh`` each phase's windows are split over its ranks
        (:func:`~srba_tpu_torch.solver.multi_window.make_sweep_step_mesh`;
        padded with windows that own nothing to a multiple of the mesh
        size), every rank holding the same masters on the mesh's device.
        Returns ``{"windows": ...}`` and the last phase's aggregated info
        (summed errors and observations, largest iterations and lambda)."""
        from srba_tpu_torch.solver.master import pack_window_ints
        from srba_tpu_torch.solver.multi_window import (make_sweep_step,
                                                        make_sweep_step_mesh,
                                                        plan_sweep_roots)

        dm = self.device_master
        if dm is None:
            raise ValueError("refine_map requires the device-master engine "
                             "mode (device_master=True)")
        if mesh is not None:
            if mesh_device(mesh) != self.device:
                raise ValueError(f"a mesh on {mesh_device(mesh)} for masters "
                                 f"on {self.device}")
        self.flush_pending_closures()
        dm.flush_append()
        tree_depth = self.parameters.max_tree_depth
        depth = depth or self.parameters.max_optimize_depth
        step = (make_sweep_step(self._solver_cfg) if mesh is None
                else make_sweep_step_mesh(self._solver_cfg, mesh))
        dm.ensure_operands(self._whitener, self._sensor_pose_inv, self.calib)
        # Scale the prior WEIGHT column for the sweep on a copy: dm.prior
        # keeps the incremental path's priors.
        prior_in = dm.prior
        if prior_scale != 1.0:
            prior_in = dm.prior.clone()
            prior_in[:, self.group.dim] *= float(prior_scale)
        info_out: Dict[str, float] = {"windows": 0.0}
        dev_info = None

        if stride is None:
            stride = getattr(self.ecp, "submap_size", None) \
                or self.parameters.max_optimize_depth
        stride = max(1, int(stride))
        for si in range(max(1, int(sweeps)) * 2):
            # Stagger the root lattice between FULL sweeps (offset shifts by
            # half a stride every other sweep) so window boundaries move;
            # within a sweep, red-black phases keep adjacent windows from
            # updating simultaneously (each phase's windows are far apart,
            # neighbors update one after the other).
            offset = ((si // 2) % 2) * (stride // 2)
            all_roots = plan_sweep_roots(self, stride, offset=offset)
            roots = [all_roots[0::2], all_roots[1::2]][si % 2]
            wins = self._sweep_windows(roots, depth, tree_depth)
            if not wins:
                continue  # this parity phase is empty; others may not be

            # Common bucket shape + stacking.
            E = max(a.edge_gids.shape[0] for a, _, _ in wins)
            L = max(a.lm_gids.shape[0] for a, _, _ in wins)
            N = max(a.obs_z.shape[0] for a, _, _ in wins)
            W = len(wins)
            if mesh is not None:
                W = -(-W // mesh.size()) * mesh.size()
            T = 2 * E + 2 * L + 2 * N + 2 * N * tree_depth
            ints = np.zeros((W, T), np.int32)
            obs_z = np.zeros((W, N, self.state.z_dim), np.float32)

            def pad_to(a, n):
                out = np.zeros((n,) + a.shape[1:], a.dtype)
                out[: a.shape[0]] = a
                return out

            for wi, (a, e_own, l_own) in enumerate(wins):
                ints[wi] = pack_window_ints(
                    pad_to(a.edge_gids, E), pad_to(e_own, E),
                    pad_to(a.lm_gids, L), pad_to(l_own, L),
                    pad_to(a.obs_lm, N), pad_to(a.obs_valid, N),
                    pad_to(a.path_edge, N), pad_to(a.path_sign, N))
                obs_z[wi, : a.obs_z.shape[0]] = a.obs_z
                if a.obs_z.shape[0] < N:   # valid-valued padding rows
                    obs_z[wi, a.obs_z.shape[0]:] = a.obs_z[0]
            # Padding windows (mesh divisibility): all-zero ints, so no
            # ownership and no valid observation; window 0's measurements
            # keep their rows non-degenerate.
            obs_z[len(wins):] = obs_z[0]
            with self.profiler.scope("refine_map_phase"):
                dm.pose, dm.lm, dev_info = step(
                    dm.pose, prior_in, dm.lm, ints, obs_z, dm._whitener_dev,
                    dm._spinv_dev, dm._calib_dev, E, L, N)
            dm.dirty = True
            info_out["windows"] += float(len(wins))
        self._seed_cache = None   # the sweep moved poses wholesale
        self._closure_barrier_seq = dm.step_seq
        if dev_info is not None:
            vals = torch.stack([dev_info[k].to(torch.float32)
                                for k in INFO_KEYS]).cpu().tolist()
            info_out.update(zip(INFO_KEYS, vals))
        return info_out

    def _build_window(self, root: int, depth: int, tree_depth: int):
        """The window of ``depth`` around ``root``: ``(WindowArrays,
        WindowPlan)`` or None.  Device-master mode: native where it exists,
        else the Python builder, both padded by the ratchet per depth.
        Host-window mode: the Python builder with the window's floats."""
        cap = self.parameters.extra_obs_per_lm_cap
        if self.device_master is None:
            return build_window(self.state, self.graph, root, depth,
                                tree_depth, extra_obs_per_lm_cap=cap)
        min_shape = self._window_caps.get(depth)
        if self.native is not None:
            built = self.native.build_window(
                self.state, root, depth, tree_depth, obs_per_lm_cap=cap,
                min_shape=min_shape)
        else:
            built = build_window(self.state, self.graph, root, depth,
                                 tree_depth, extra_obs_per_lm_cap=cap,
                                 gather_floats=False, min_shape=min_shape)
        if built is not None:
            self._window_caps[depth] = built[1].shape_key
        return built

    def _sweep_windows(self, roots, depth: int, tree_depth: int):
        """The windows of one sweep phase with their ownership: each
        window's opt masks cleared on unknowns an earlier root of the phase
        claimed (first claim wins).  Returns ``[(arrays, edge_own [E],
        lm_own [L])]`` (f32 masks); windows that own nothing are left
        out."""
        wins = []
        claimed_e: set = set()
        claimed_l: set = set()
        for root in roots:
            built = self._build_window(root, depth, tree_depth)
            if built is None:
                continue
            arrays, _ = built
            e_claimed = np.isin(
                arrays.edge_gids,
                np.fromiter(claimed_e, np.int32, len(claimed_e)))
            l_claimed = np.isin(
                arrays.lm_gids,
                np.fromiter(claimed_l, np.int32, len(claimed_l)))
            e_own = (arrays.edge_opt > 0) & ~e_claimed
            l_own = (arrays.lm_opt > 0) & ~l_claimed
            if not (e_own.any() or l_own.any()):
                continue
            claimed_e.update(arrays.edge_gids[e_own].tolist())
            claimed_l.update(arrays.lm_gids[l_own].tolist())
            wins.append((arrays, e_own.astype(np.float32),
                         l_own.astype(np.float32)))
        return wins

    # ------------------------------------------------------------------
    # Global-map recovery & evaluation
    # ------------------------------------------------------------------

    def create_complete_spanning_tree(self, root: int = 0,
                                      _mirror_max_age: int = 0):
        """Global KF poses by composing relative edge poses outward from
        ``root`` over the full BFS tree (reference
        ``create_complete_spanning_tree``), batch-composed per BFS level on
        the host.  ``_mirror_max_age`` is internal (seed cache): public
        callers always get an exact, current-state tree."""
        with self.profiler.scope("spantree_sync"):
            self.sync(max_age=_mirror_max_age)
        with self.profiler.scope("spantree_bfs"):
            dist, parent = self.graph.complete_spanning_tree(root)
        G = np.zeros((self.state.num_kfs, self.group.dim), np.float32)
        G[root] = self.np_group.identity()
        with self.profiler.scope("spantree_compose"):
            by_level: Dict[int, List[int]] = {}
            for n, d in dist.items():
                if n != root:
                    by_level.setdefault(d, []).append(n)
            for d in sorted(by_level):
                nodes = np.asarray(by_level[d], np.int32)
                ps = np.asarray([parent[int(n)][0] for n in nodes], np.int32)
                eids = np.asarray([parent[int(n)][1] for n in nodes],
                                  np.int32)
                ea = self.state.k2k_from[eids]
                steps = self.state.k2k_pose[eids].copy()
                rev = ea != ps    # edge stored (a,b): reversed when a != p
                if rev.any():
                    steps[rev] = self.np_group.inverse(steps[rev])
                G[nodes] = self.np_group.compose(G[ps],
                                                 steps).astype(np.float32)
        return G, dist

    def bfs_visitor(self, root: int, max_depth: int, kf_visitor=None,
                    k2k_visitor=None, lm_visitor=None, k2f_visitor=None):
        """Generic BFS traversal with callbacks — the four-visitor analog of
        the reference's ``bfs_visitor<KF_VISITOR, FEAT_VISITOR, K2K_VISITOR,
        K2F_VISITOR>``:

        * ``kf_visitor(kf_id, depth)`` per reached keyframe;
        * ``k2k_visitor(edge_id, parent_kf, child_kf)`` per tree edge;
        * ``lm_visitor(lm_id, base_kf, depth)`` per landmark whose base KF
          is reached (once, at the base's depth — the FEAT visitor);
        * ``k2f_visitor(obs_id, kf_id, lm_id)`` per observation made from a
          reached keyframe.
        """
        dist, parent = self.graph.bfs_tree(root, max_depth)
        order = sorted(dist.keys(), key=lambda n: (dist[n], n))
        by_base: Dict[int, List[int]] = {}
        if lm_visitor is not None:
            for lm in range(self.state.num_lms):
                by_base.setdefault(int(self.state.lm_base[lm]),
                                   []).append(lm)
        for n in order:
            if kf_visitor is not None:
                kf_visitor(n, dist[n])
            if n != root and k2k_visitor is not None:
                p, eid = parent[n]
                k2k_visitor(eid, p, n)
            if k2f_visitor is not None:
                for o in self.state.kf_obs[n]:
                    k2f_visitor(o, n, int(self.state.obs_lm[o]))
            if lm_visitor is not None:
                for lm in by_base.get(n, ()):
                    lm_visitor(lm, n, dist[n])
        return dist

    def optimize_global(self, cfg=None, write_back: bool = True, mesh=None,
                        periodic: bool = False, use_edge_info: bool = False,
                        profiler=None):
        """Global pose-graph optimization over ALL kf2kf edges (the JAX
        package's ``optimize_global``): the problem of
        :func:`~srba_tpu_torch.io.export.get_global_graphslam_problem`
        solved by the matrix-free LM-PCG of
        :mod:`srba_tpu_torch.solver.global_graphslam` on the engine's
        device.

        The default configuration is the basin-robust one: chordal
        initialization and a pseudo-Huber edge loss (``robust_delta`` 0.1).
        ``periodic`` marks a mid-run refinement: the LM damping warm-starts
        from the previous periodic solve's final lambda, and the default
        configuration certifies at ``rel_tol`` 1e-3 (diminishing returns).
        A caller's own ``cfg`` keeps its ``rel_tol`` — the JAX package
        overwrites it with 1e-3 in periodic mode.  ``use_edge_info`` feeds
        the closure fits' anisotropic information shapes into the solve.
        ``profiler`` (a :class:`Profiler`, none by default) takes the
        solve's scopes and counters; its scopes wait for the device.
        ``mesh`` (default: the engine's) splits the edges over its ranks
        (:func:`~srba_tpu_torch.solver.global_graphslam.make_pgo_spmd`).

        Returns ``(G_opt [K, pose_dim], info)``.  With ``write_back`` the
        relative edge poses are re-derived from the optimized globals
        (``T_a<-b = inv(G_a) ∘ G_b``) and, in the device-master mode,
        uploaded into the device masters, so incremental operation continues
        from the globally consistent map."""
        from srba_tpu_torch.io.export import get_global_graphslam_problem
        from srba_tpu_torch.solver.global_graphslam import (
            PGOConfig, optimize_global_pose_graph)

        if mesh is None:
            mesh = self.mesh
        self.flush_pending_closures()
        if self.device_master is not None:
            self.device_master.flush_append()
        prob = get_global_graphslam_problem(
            self, with_edge_info=use_edge_info)  # syncs internally
        lam0 = None
        if cfg is None:
            cfg = PGOConfig(group=self.group.name, chordal_init=True,
                            robust_delta=0.1)
            if periodic:
                cfg = dataclasses.replace(cfg, rel_tol=1e-3)
        if periodic:
            lam0 = getattr(self, "_pgo_warm_lam", None)
        G_opt, info = optimize_global_pose_graph(
            prob, cfg, lam0=lam0, mesh=mesh, device=self.device,
            profiler=profiler)
        if periodic:
            self._pgo_warm_lam = float(info.get("lam", cfg.lam0))
        if write_back and self.state.num_edges:
            a = self.state.k2k_from[: self.state.num_edges]
            b = self.state.k2k_to[: self.state.num_edges]
            self.state.k2k_pose[: self.state.num_edges] = \
                self.np_group.compose(self.np_group.inverse(G_opt[a]),
                                      G_opt[b]).astype(np.float32)
            if self.device_master is not None:
                self.device_master.upload_from_host(
                    self.state.k2k_pose, self.state.lm_state,
                    self.state.num_edges, self.state.num_lms,
                    k2k_prior=self.state.k2k_prior,
                    k2k_prior_w=self.state.k2k_prior_w)
            self._G_dr = [np.asarray(G_opt[k], np.float32)
                          for k in range(self.state.num_kfs)]
            self._seed_cache = None   # poses changed wholesale
        return G_opt, info

    def eval_overall_squared_error(self) -> float:
        """Total whitened squared error over ALL observations, using global
        poses composed from the complete spanning tree (reference
        ``eval_overall_squared_error``), evaluated on the engine's device."""
        if self.state.num_obs == 0:
            return 0.0
        G, dist = self.create_complete_spanning_tree(0)
        nobs = self.state.num_obs
        obs_kf = self.state.obs_kf[:nobs]
        obs_lm = self.state.obs_lm[:nobs]
        reachable = np.asarray([int(k) in dist for k in obs_kf])
        # T_obs<-base = inv(G_obs) o G_base  (host compose, vectorized numpy)
        T = self.np_group.compose(
            self.np_group.inverse(G[obs_kf]),
            G[self.state.lm_base[obs_lm]],
        ).astype(np.float32)

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)

        lm = dev(self.state.lm_state[obs_lm])
        if self.model.is_pose_landmark:
            pred = self.group.compose(dev(T), lm)
        else:
            pt = self.group.apply(dev(T), lm)
            if self._use_sensor_pose:
                pt = self.group.apply(dev(self._sensor_pose_inv), pt)
            pred = self.model.h(pt, self._calib_dev)
        r = self.model.residual(pred, dev(self.state.obs_z[:nobs])) \
            @ dev(self._whitener).T
        err = torch.sum(torch.sum(r * r, dim=-1) * dev(reachable))
        return float(err)

    def get_rba_state(self) -> ProblemState:
        """Read-only access to the SoA problem state (reference
        ``get_rba_state``).  Syncs the host mirror first."""
        self.sync()
        return self.state

    @property
    def num_keyframes(self) -> int:
        return self.state.num_kfs

    @property
    def num_landmarks(self) -> int:
        return self.state.num_lms

    @property
    def num_pending_landmarks(self) -> int:
        """Monocular landmarks buffered by the deferred-triangulation
        front-end, not yet materialized (see ``add_observation``)."""
        return 0 if self._tri is None else self._tri.num_pending
