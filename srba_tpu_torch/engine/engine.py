"""SrbaEngine — the public API orchestrator, port of
:mod:`srba_tpu.engine.engine` (the reference's ``RbaEngine``).

Ported so far: the device-master incremental path for landmark models with
an inverse sensor model on SE(2) and SE(3), graph-SLAM mode (relative-pose
observations of earlier keyframes as fixed pose landmarks, with a kf2kf
edge to every observed keyframe beyond the tree depth), chain edge-creation
policies and odometry/dead-reckoned edge seeds — what configs #1 (2D
range-bearing SE(2)), #2 (3D range-bearing SE(3)) and #4 (relative-pose
graph-SLAM) run.  ECP loop-closure edges, calibrated camera models, sensor
mounting poses, monocular deferred triangulation, the host-window and mesh
paths, ``refine_map`` and ``optimize_global`` are not ported yet and raise
by name.

Per keyframe the host does the integer work (allocation, edge-creation
policy, spanning-tree paths, window selection) and the device runs ONE step
over the padded window (:mod:`srba_tpu_torch.solver.master`); nothing is
read back until a caller asks for state.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from srba_tpu_torch.ecps import ClassicLinearRBA
from srba_tpu_torch.engine.device_master import DeviceMaster
from srba_tpu_torch.engine.state import ProblemState
from srba_tpu_torch.graph.spantree import KeyframeGraph
from srba_tpu_torch.models.landmarks import (LANDMARK_TYPES, Euclidean2D,
                                             Euclidean3D)
from srba_tpu_torch.models.noise import NoiseIdentity
from srba_tpu_torch.models.observations import OBSERVATION_MODELS
from srba_tpu_torch.models.sensor_pose import SensorPoseNone
from srba_tpu_torch.ops.np_lie import np_group_for
from srba_tpu_torch.solver.lm import SolverConfig
from srba_tpu_torch.solver.window import build_window
from srba_tpu_torch.utils.profiler import Profiler
from srba_tpu_torch.utils.registry import lookup


@dataclass
class SrbaParams:
    """Runtime parameters — the fields of the JAX package's ``SrbaParams``
    (analog of the reference's ``TSRBAParameters``) that the ported path
    reads, with the same defaults; see there for each knob's rationale.
    The loop-closure and monocular-front-end fields come with those
    features."""

    max_tree_depth: int = 4
    max_optimize_depth: int = 4
    use_robust_kernel: bool = False
    kernel_param: float = 3.0
    verbose: int = 0
    extra_obs_per_lm_cap: Optional[int] = None
    # Edge measurement priors: the edge's creation-time measured value
    # (odometry) kept as a weak factor of weight 1/sigma^2 in every window
    # solve (scaled down by hop count for dead-reckoned seeds).  None
    # disables the priors.
    edge_prior_sigma: Optional[float] = 0.05
    # Staleness budget (optimization steps) of the host mirror behind the
    # edge-seed cache, and the async prefetch cadence (every max_age/2).
    closure_mirror_max_age: int = 16
    max_iters: int = 20
    # Iteration cap of ordinary per-keyframe incremental steps (explicit
    # optimize_local_area calls run ``max_iters``).
    incremental_max_iters: int = 10
    lam0: float = 1e-4
    rel_tol: float = 1e-6
    solver: str = "schur_dense_cholesky"


@dataclass
class Observation:
    """One landmark sighting handed to ``define_new_keyframe``.

    ``fixed_rel_pos``: landmark with exactly known position in its base frame
    (excluded from optimization).  ``init_rel_pos``: explicit initial value
    for a new unknown landmark (default: the inverse sensor model)."""

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
        if not device_master or mesh is not None:
            raise NotImplementedError(
                "host-window and mesh solves are not ported to "
                "srba_tpu_torch yet (only the device-master path is)")
        if calib is not None:
            raise NotImplementedError(
                "calibrated observation models are not ported to "
                "srba_tpu_torch yet")
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
        if not self.sensor_pose.is_identity:
            raise NotImplementedError(
                f"sensor pose {self.sensor_pose.name!r} is not ported to "
                "srba_tpu_torch yet")
        self.calib = None
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
        # above are a lazily refreshed mirror.
        self.device_master = DeviceMaster(self.group.dim, self.lm_type.dim,
                                          device=device)
        self.device = self.device_master.device

        self._whitener = np.asarray(
            self.noise.whitener(self.model.obs_dim), np.float32)
        sp = np.asarray(self.sensor_pose.pose_for(self.group), np.float32)
        self._sensor_pose_inv = np.asarray(self.np_group.inverse(sp),
                                           np.float32)

        # External feature id -> dense internal landmark index.
        self._lm_id_map: Dict[int, int] = {}
        # Dead-reckoned global pose per KF (host, odometry-composed): seeds
        # primary-link edge initials without device syncs.
        self._G_dr: List[np.ndarray] = []
        # Throttled optimized-global-pose cache for edge seeding without
        # odometry: (num_kfs at build, G array, dist map).
        self._seed_cache = None
        self._seed_cache_max_age = 25

        self._solver_cfg = SolverConfig(
            obs_model=self.model.name,
            pose_group=self.group.name,
            lm_type=self.lm_type.name,
            max_depth=self.parameters.max_tree_depth,
            use_sensor_pose=False,
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
                  prior_w: float = 0.0) -> int:
        e = self.state.add_edge(from_kf, to_kf, pose, prior_w=prior_w)
        self.device_master.stage_edge(pose, prior_w)
        return e

    def _add_landmark(self, base_kf: int, st: np.ndarray,
                      fixed: bool = False) -> int:
        l = self.state.add_landmark(base_kf, st, fixed=fixed)
        self.device_master.stage_landmark(st)
        return l

    def sync(self, max_age: int = 0) -> None:
        """Refresh the host mirror of edge poses / landmark states from the
        device masters (one download; no-op when clean).  ``max_age``
        accepts a mirror up to that many optimization steps stale."""
        self.device_master.sync_to_host(
            self.state.k2k_pose, self.state.lm_state, max_age=max_age)

    def fence(self) -> None:
        """Wait for all queued device work WITHOUT downloading state (use
        around timing sections; ``sync`` additionally refreshes the host
        mirror)."""
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
                if closure_targets:
                    raise NotImplementedError(
                        "loop-closure edges are not ported to "
                        "srba_tpu_torch yet")
                self._create_primary_edges(kf_id, primary_targets, edge_init,
                                           info)
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
                    info.optimize_results = self.optimize_local_area(
                        kf_id, self.parameters.max_optimize_depth,
                        _iters_cap=self.parameters.incremental_max_iters)
            else:
                # No solve this frame: still push staged rows to the device
                # masters so they stay authoritative.
                self.device_master.flush_append()

            # Steady async prefetch cadence (internally throttled to every
            # max_age/2 steps): a stale-tolerant consumer (the seed cache)
            # takes an already-landed copy instead of a blocking download.
            self.device_master.maybe_prefetch(
                self.parameters.closure_mirror_max_age)
        if self.parameters.verbose >= 1:
            print(f"[srba] kf={kf_id} edges+={len(info.created_edge_ids)} "
                  f"opt={info.optimize_results}")
        return info

    def _create_primary_edges(self, kf_id: int, targets, edge_init,
                              info: TNewKeyFrameInfo) -> None:
        """Create the new keyframe's primary (local) edges and record its
        dead-reckoned global pose.  Seeds: the given odometry
        (``edge_init``), else the dead-reckoned trajectory, else the
        throttled optimized global estimate."""
        g = self.np_group
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

        p_sigma = self.parameters.edge_prior_sigma
        if self.model.is_pose_landmark:
            # Graph-SLAM mode: every observation IS a direct edge
            # measurement, so windows are never visually degenerate and an
            # odometry prior would double-count/outvote the loop-closure
            # observations (whose whitened weight the prior knows nothing
            # about).
            p_sigma = None
        for t in targets:
            # Prior weight: how much the seed is a MEASUREMENT.
            prior_w = 0.0
            if edge_init is not None and t in edge_init:
                init = np.asarray(edge_init[t], np.float32)
                if p_sigma:
                    prior_w = 1.0 / (p_sigma * p_sigma)
            elif G_dr_new is not None and t < len(self._G_dr):
                # Local link: dead-reckoned seed.
                init = _seed_from(G_dr_new, self._G_dr[t])
                if p_sigma:
                    # Composition of ~|kf-t| odometry steps: variance grows
                    # linearly with hop count.
                    hops = max(abs(kf_id - t), 1)
                    prior_w = 1.0 / (p_sigma * p_sigma * hops)
            else:
                # No odometry anchor: seed from the optimized global
                # estimate.
                g_new = self._global_est_new(G_dr_new)
                g_t = self._global_est(t)
                if g_new is not None and g_t is not None:
                    init = _seed_from(g_new, g_t)
                else:
                    init = g.identity()
            e = self._add_edge(kf_id, t, init, prior_w=prior_w)
            self.graph.add_edge(kf_id, t)
            info.created_edge_ids.append(e)

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
                self.graph.add_edge(kf_id, j)
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
        ``add_observation`` + ``inverse_sensor_model``).  Returns the
        observation id."""
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
            else:
                st = self._init_landmark(z, init_rel_pos)
                internal = self._add_landmark(kf_id, st, fixed=False)
            self._lm_id_map[lm_id] = internal
        return self.state.add_observation(kf_id, internal, z)

    def _batch_landmark_inits(self, observations) -> Dict[int, np.ndarray]:
        """Inverse-sensor-model inits for this frame's brand-new landmarks,
        computed in one batched host call.  Returns {obs_list_index: init}."""
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
        pts = np.asarray(self.model.inverse(zs, None), np.float32)
        return {i: pts[j] for j, i in enumerate(idxs)}

    def _init_landmark(self, z: np.ndarray, init_rel_pos) -> np.ndarray:
        if init_rel_pos is not None:
            return np.asarray(init_rel_pos, np.float32)
        # Inverse model gives the landmark in the sensor (= keyframe) frame.
        return np.asarray(self.model.inverse(z, None), np.float32)

    # ------------------------------------------------------------------
    # Optimization
    # ------------------------------------------------------------------

    def optimize_local_area(self, root_kf: int,
                            win_size: Optional[int] = None,
                            _iters_cap: int = 0) -> Dict[str, float]:
        """BFS window around ``root_kf`` -> padded window -> one device
        step (append + gather + LM+Schur + scatter) (reference
        ``optimize_local_area``).  Returns a :class:`LazyInfo` (nothing is
        downloaded until a value is read).  The JAX package's
        ``restrict_edges``/``restrict_lms`` arguments serve its
        ``optimize_edges``, which is not ported yet."""
        depth = (win_size if win_size is not None
                 else self.parameters.max_optimize_depth)
        master = self.device_master
        with self.profiler.scope("window_build"):
            built = build_window(
                self.state, self.graph, root_kf, depth,
                self.parameters.max_tree_depth,
                extra_obs_per_lm_cap=self.parameters.extra_obs_per_lm_cap,
                gather_floats=False)
        if built is None:
            master.flush_append()
            return {"skipped": 1.0}
        arrays, _ = built

        # Append staged rows + gather + LM+Schur + scatter-back in ONE step;
        # nothing is downloaded (info values are fetched lazily).
        with self.profiler.scope("device_step"):
            return master.step(
                self._solver_cfg, self._whitener, self._sensor_pose_inv,
                self.calib,
                arrays.edge_gids, arrays.edge_opt, arrays.lm_gids,
                arrays.lm_opt, arrays.obs_lm, arrays.obs_valid,
                arrays.path_edge, arrays.path_sign, arrays.obs_z,
                iters_cap=_iters_cap)

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
            pred = self.model.h(self.group.apply(dev(T), lm), self.calib)
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
