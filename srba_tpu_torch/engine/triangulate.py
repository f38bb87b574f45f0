"""Monocular landmark initialization by two-view triangulation — a copy of
:mod:`srba_tpu.engine.triangulate` (host numpy, framework-free).

A monocular camera has no single-view inverse model.  A new monocular
landmark observed without an init is held PENDING (its sightings buffered,
not yet part of the problem) until a second sighting with enough parallax
exists; then it is triangulated by the two-view midpoint method and
materialized with every buffered sighting replayed.

The geometry uses the engine's dead-reckoned trajectory (``engine._G_dr``):
pending windows span a handful of keyframes, over which dead-reckoning
drift is far below the triangulation noise, and it needs no device sync.
So until the first global-PGO write-back (which rewrites ``_G_dr``) the
materialized landmarks do not depend on the device the solver runs on.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from srba_tpu_torch.ops.np_lie import quat_rotate


def _ray_midpoint(o1: np.ndarray, r1: np.ndarray, o2: np.ndarray,
                  r2: np.ndarray) -> Tuple[Optional[np.ndarray], float]:
    """Midpoint of the closest points of two rays ``o + t r`` (t >= 0).
    Returns ``(point, parallax_rad)``; point is None when the rays are
    (near-)parallel or meet behind either origin."""
    r1 = r1 / np.linalg.norm(r1)
    r2 = r2 / np.linalg.norm(r2)
    c = float(r1 @ r2)
    parallax = float(np.arccos(np.clip(abs(c), -1.0, 1.0)))
    if 1.0 - c * c < 1e-12:
        return None, parallax
    # Closest-points system:  [1 -c; c -1] [t1 t2]' = [d.r1, d.r2]'
    d = o2 - o1
    A = np.array([[1.0, -c], [c, -1.0]])
    b = np.array([d @ r1, d @ r2])
    t1, t2 = np.linalg.solve(A, b)
    if t1 <= 1e-6 or t2 <= 1e-6:   # behind either camera
        return None, parallax
    p = 0.5 * ((o1 + t1 * r1) + (o2 + t2 * r2))
    return p, parallax


class MonoTriangulator:
    """Deferred-initialization buffer for monocular landmarks.

    ``hold(lm_id, kf, z)`` buffers a sighting of a not-yet-materialized
    landmark; ``try_init(lm_id)`` triangulates the FIRST buffered sighting
    (the future base KF) against the newest one that gives enough parallax,
    returning ``(base_kf, point_in_base_robot_frame, buffered_obs)``."""

    MAX_BUFFER = 16
    # Pending landmarks whose NEWEST sighting is older than this many
    # keyframes are evicted: the track ended without reaching the parallax
    # threshold, so its buffer could never materialize.
    MAX_IDLE_KFS = 64

    def __init__(self, engine, min_parallax_deg: float = 1.0,
                 max_depth: float = 100.0):
        self.engine = engine
        self.min_parallax = float(np.deg2rad(min_parallax_deg))
        self.max_depth = float(max_depth)
        self._pending: Dict[int, List[Tuple[int, np.ndarray]]] = {}
        self._last_prune_kf = 0

    def hold(self, lm_id: int, kf_id: int, z: np.ndarray) -> None:
        buf = self._pending.setdefault(lm_id, [])
        if len(buf) < self.MAX_BUFFER:
            buf.append((kf_id, np.asarray(z, np.float32)))
        else:
            # Full buffer: REPLACE the newest entry (the first pins the base
            # frame, the newest carries the widest baseline), so a landmark
            # whose first sightings were all sub-parallax can still
            # materialize once the trajectory gives baseline.
            buf[-1] = (kf_id, np.asarray(z, np.float32))
        if kf_id - self._last_prune_kf >= self.MAX_IDLE_KFS:
            self._last_prune_kf = kf_id
            stale = [l for l, b in self._pending.items()
                     if kf_id - b[-1][0] > self.MAX_IDLE_KFS]
            for l in stale:
                del self._pending[l]

    def _bearing_in_robot(self, z: np.ndarray) -> Tuple[np.ndarray,
                                                        np.ndarray]:
        """Pixel -> (ray origin, direction) in the observing KF's ROBOT
        frame, through the sensor mounting pose."""
        eng = self.engine
        calib = eng._calib_np
        d = np.array([(float(z[0]) - float(calib.cx)) / float(calib.fx),
                      (float(z[1]) - float(calib.cy)) / float(calib.fy),
                      1.0], np.float64)
        S = eng._sensor_pose.astype(np.float64)
        return S[:3].copy(), quat_rotate(S[3:], d)

    def try_init(self, lm_id: int):
        """Two-view midpoint triangulation between the first sighting and
        the newest one with enough parallax.  Returns ``(base_kf,
        init_point, buffered)`` or None."""
        buf = self._pending.get(lm_id)
        if buf is None or len(buf) < 2:
            return None
        eng = self.engine
        g = eng.np_group
        base_kf, z0 = buf[0]
        o1, r1 = self._bearing_in_robot(z0)
        best = None
        # Newest sighting first (largest baseline), walking back.
        for kf_b, z_b in reversed(buf[1:]):
            if kf_b >= len(eng._G_dr) or base_kf >= len(eng._G_dr):
                continue
            T_ab = g.compose(g.inverse(eng._G_dr[base_kf]),
                             eng._G_dr[kf_b]).astype(np.float64)
            o2_s, r2_s = self._bearing_in_robot(z_b)
            o2 = g.apply(T_ab, o2_s)
            r2 = quat_rotate(T_ab[3:], r2_s)
            p, parallax = _ray_midpoint(o1, r1, o2, r2)
            if p is None or parallax < self.min_parallax:
                continue
            if np.linalg.norm(p - o1) > self.max_depth:
                continue
            best = p
            break
        if best is None:
            return None
        out = (base_kf, best.astype(np.float32), list(buf))
        del self._pending[lm_id]
        return out

    @property
    def num_pending(self) -> int:
        return len(self._pending)
