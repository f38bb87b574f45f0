"""Driver of map-parallel refinement cells: a stereo drive ingested as a
raw-odometry map and swept once at set-up, then ``SrbaEngine.refine_map``
call after call, each ending in its info read (a synchronize) and a read of
the refined map.

The traffic file gives ``sweeps``, ``stride``, ``depth`` and
``prior_scale`` of each call, and the limits of the numbers that decide
``correct``.  The check compares one call drawn from the seed with the
plain reference (``reference/srba_sweep.py``), which does the same sweep
from the map that call started from, over edges and priors it works out
from the drive's odometry itself (``reference/local_areas.py``): the
window objectives at the program's map against the same at the
reference's, the window count, and, for the raw map the set-up built, the
observation table, the landmarks' base keyframes and the edges with their
priors against the inputs.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from reference import local_areas, srba_sweep
from worlds import street_grid

# An edge's prior differs from the reference's where its translation is
# further than this (m) or its rotation turns by more (rad); the program's
# float32 dead reckoning stays under a tenth of each on the cell's drive.
PRIOR_TOL_M = 1e-3
PRIOR_TOL_RAD = 1e-4
PRIOR_W_RTOL = 1e-4


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) and \
            isinstance(base.get(k), dict) else v
    return out


class Cell:
    def __init__(self, config, traffic, seed, device, sizes=None):
        from srba_tpu_torch.ecps import LocalAreasFixedGrid
        from srba_tpu_torch.engine.engine import (Observation, SrbaEngine,
                                                  SrbaParams)
        from srba_tpu_torch.models.noise import NoiseIdentity
        from srba_tpu_torch.models.observations import StereoCalib
        from srba_tpu_torch.models.sensor_pose import SensorPoseSE3
        from srba_tpu_torch.ops import np_lie

        cfg = _merge(config, sizes or {})
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.metric = traffic["metric"]
        self.trace_calls = int(traffic["trace_calls"])
        self.drive = street_grid.make_drive(cfg, seed)
        cam, eng_cfg = cfg["camera"], cfg["engine"]
        self.calib = StereoCalib.make(fx=cam["fx"], fy=cam["fy"],
                                      cx=cam["cx"], cy=cam["cy"],
                                      baseline=cam["baseline"])
        self.sensor_pose = np.asarray(
            getattr(np_lie, eng_cfg["sensor_pose"]), np.float32)
        ecp = eng_cfg["ecp"]
        self.engine = SrbaEngine(
            eng_cfg["obs_model"], calib=self.calib,
            noise=NoiseIdentity(eng_cfg["noise_std_px"]),
            sensor_pose=SensorPoseSE3(self.sensor_pose),
            ecp=LocalAreasFixedGrid(
                submap_size=ecp["submap_size"],
                min_obs_count_loop_closure=ecp["min_obs_count_loop_closure"]),
            params=SrbaParams(**eng_cfg["params"]),
            device_master=eng_cfg["device_master"], device=device)
        d = self.drive
        with torch.profiler.record_function("perfbench.ingest"):
            for k in range(d.frame_start.shape[0] - 1):
                a, b = d.frame_start[k], d.frame_start[k + 1]
                obs = [Observation(lm_id=int(m), z=z)
                       for m, z in zip(d.obs_lm[a:b], d.obs_z[a:b])]
                self.engine.define_new_keyframe(
                    obs, edge_init={k - 1: d.odometry[k - 1]} if k else None,
                    run_local_optimization=False)
            self.engine.fence()
        self.states = []
        self.infos = []
        self.attempted = 0
        self.failed = 0
        self._spans = {}

    # -- the timed path --------------------------------------------------

    def _refine(self):
        t = self.traffic
        return self.engine.refine_map(
            sweeps=t["sweeps"], stride=t["stride"], depth=t["depth"],
            prior_scale=t["prior_scale"])

    def _read_map(self):
        st = self.engine.get_rba_state()
        return (st.k2k_pose[: st.num_edges].copy(),
                st.lm_state[: st.num_lms].copy())

    def warm(self):
        """The map's first sweep, before the window: it builds the kernels
        and runs every shape the window's calls run.  The window's calls
        are the sweeps after it."""
        self._refine()
        self.states = [self._read_map()]

    def call(self):
        with torch.profiler.record_function("perfbench.refine_map"):
            info = self._refine()
        with torch.profiler.record_function("perfbench.read_map"):
            self.states.append(self._read_map())
        self.infos.append(info)
        self.attempted += 1
        if not np.isfinite(info.get("err_final", np.nan)):
            self.failed += 1

    @contextlib.contextmanager
    def traced(self):
        """The program's ``refine_map_phase`` scope over the traced calls:
        the phases run and their host time."""
        prof = self.engine.profiler
        before = prof.stats.get("refine_map_phase")
        c0, t0 = (before.count, before.total) if before else (0, 0.0)
        try:
            yield
        finally:
            after = prof.stats.get("refine_map_phase")
            self._spans = {
                "phases": (after.count if after else 0) - c0,
                "phase_dispatch_s": (after.total if after else 0.0) - t0}

    def readings(self) -> dict:
        return dict(self._spans)

    def release(self):
        self.topology = self._topology()
        del self.engine
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correctness --------------------------------------------------------

    def _topology(self):
        st = self.engine.get_rba_state()
        E, L, n = st.num_edges, st.num_lms, st.num_obs
        return dict(num_kfs=st.num_kfs, edge_from=st.k2k_from[:E].copy(),
                    edge_to=st.k2k_to[:E].copy(),
                    prior=st.k2k_prior[:E].copy(),
                    prior_w=st.k2k_prior_w[:E].copy(),
                    lm_base=st.lm_base[:L].copy(),
                    obs_kf=st.obs_kf[:n].copy(), obs_lm=st.obs_lm[:n].copy(),
                    obs_z=st.obs_z[:n].copy())

    def problem(self):
        """The reference's problem, worked out from the inputs alone: the
        edges and their priors from the odometry, the landmarks' dense
        ids and bases from the observation table."""
        d, t = self.drive, self.traffic
        cam, eng = self.cfg["camera"], self.cfg["engine"]
        K = d.frame_start.shape[0] - 1
        ef, et, prior, prior_w = local_areas.fixed_grid_edges(
            K, eng["ecp"]["submap_size"], d.odometry,
            eng["params"]["edge_prior_sigma"])
        ids, first = np.unique(d.obs_lm, return_index=True)
        order = np.argsort(first, kind="stable")
        dense = np.empty(ids.max() + 1, np.int64)
        dense[ids[order]] = np.arange(ids.shape[0])
        lm_base = d.obs_kf[np.sort(first)]
        return srba_sweep.SweepProblem(
            num_kfs=K, edge_from=ef, edge_to=et, prior=prior,
            prior_w=prior_w, lm_base=lm_base.astype(np.int64),
            lm_fixed=np.zeros(ids.shape[0], bool),
            obs_kf=d.obs_kf, obs_lm=dense[d.obs_lm],
            obs_z=d.obs_z.astype(np.float32),
            calib=tuple(float(cam[k]) for k in ("fx", "fy", "cx", "cy",
                                                "baseline")),
            sensor_pose=self.sensor_pose, sigma_px=eng["noise_std_px"],
            stride=int(t["stride"]), depth=int(t["depth"]),
            tree_depth=int(eng["params"]["max_tree_depth"]),
            obs_cap=int(eng["params"]["extra_obs_per_lm_cap"]),
            prior_scale=float(t["prior_scale"]))

    def edge_mismatches(self, p) -> int:
        """Edges of the program's map whose ends, prior or prior weight
        differ from the reference's (the count of edges set against each
        other included)."""
        topo = self.topology
        E = min(len(topo["edge_from"]), len(p.edge_from))
        bad = abs(len(topo["edge_from"]) - len(p.edge_from))
        dt, dr = local_areas.pose_gaps(topo["prior"][:E], p.prior[:E])
        w_rel = np.abs(topo["prior_w"][:E] - p.prior_w[:E]) / p.prior_w[:E]
        self.prior_gaps = dict(m=float(dt.max(initial=0.0)),
                               rad=float(dr.max(initial=0.0)),
                               w_rel=float(w_rel.max(initial=0.0)))
        bad += int(np.sum((topo["edge_from"][:E] != p.edge_from[:E])
                          | (topo["edge_to"][:E] != p.edge_to[:E])
                          | (dt > PRIOR_TOL_M) | (dr > PRIOR_TOL_RAD)
                          | (w_rel > PRIOR_W_RTOL)))
        return bad

    def start_mismatches(self, p) -> int:
        """Rows of the program's observation table, and landmarks, that
        differ from what the inputs give."""
        topo = self.topology
        n = min(len(topo["obs_kf"]), len(p.obs_kf))
        bad = abs(len(topo["obs_kf"]) - len(p.obs_kf))
        bad += int(np.sum((topo["obs_kf"][:n] != p.obs_kf[:n])
                          | (topo["obs_lm"][:n] != p.obs_lm[:n])
                          | np.any(topo["obs_z"][:n] != p.obs_z[:n], -1)))
        L = min(len(topo["lm_base"]), len(p.lm_base))
        bad += abs(len(topo["lm_base"]) - len(p.lm_base))
        bad += int(np.sum(topo["lm_base"][:L] != p.lm_base[:L]))
        return bad

    def reference_sweep(self, p, windows, call, tf32=False,
                        phases=(0, 1)):
        """The reference's map after call ``call``, from the map it
        started from, in float32 (``tf32`` and ``phases``: see
        :func:`srba_sweep.sweep`)."""
        pre_e, pre_l = self.states[call]
        st = srba_sweep.MapState.from_arrays(pre_e, pre_l, torch.float32,
                                             self.device)
        return srba_sweep.sweep(p, windows, st, tf32, phases)

    def state_of(self, i):
        """The program's map after its ``i``-th call (0: after the warm
        sweep), in float64 on the check's device."""
        return srba_sweep.MapState.from_arrays(*self.states[i],
                                               torch.float64, self.device)

    @staticmethod
    def gaps(p, windows, ref, candidate):
        """The compared number of a candidate map against the reference's
        map after the same call, every objective evaluated in float64: the
        widest relative excess of a window's objective over the
        reference's, over both phases' windows (``window_gap``), and over
        each phase's alone."""
        f_ref = srba_sweep.window_errors(p, windows, ref.to(torch.float64))
        f_c = srba_sweep.window_errors(p, windows, candidate)
        rel = (f_c - f_ref) / f_ref
        last = np.asarray([w.phase == 1 for w in windows])
        return {"window_gap": float(np.max(rel)),
                "window_gap_first": float(np.max(rel[~last],
                                                 initial=-np.inf)),
                "window_gap_last": float(np.max(rel[last], initial=-np.inf))}

    def check(self, rng, limits):
        p = self.problem()
        out = [("start_mismatches", float(self.start_mismatches(p))),
               ("edge_mismatches", float(self.edge_mismatches(p)))]
        call = int(rng.integers(len(self.states) - 1))
        windows = srba_sweep.plan_windows(p)
        out.append(("windows_mismatch",
                    float(abs(self.infos[call]["windows"] - len(windows)))))
        if out[1][1] == 0:
            gaps = self.gaps(p, windows, self.reference_sweep(p, windows,
                                                              call),
                             self.state_of(call + 1))
        else:    # other edges: the maps cannot be set against each other
            gaps = dict.fromkeys(("window_gap", "window_gap_first",
                                  "window_gap_last"), np.inf)
        out += sorted(gaps.items())
        return [(name, v, float(limits[name])) for name, v in out
                if name in limits]
