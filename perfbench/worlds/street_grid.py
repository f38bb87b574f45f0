"""A stereo drive through a street grid, with fixed work on every seed.

A rewrite of the stereo projection and visibility of the port's
``srba_tpu_torch/utils/datasets.py`` (``_observe_points``, ``observe``)
for a drive at KITTI odometry's camera: the route is a staircase of
straight streets joined by 90-degree turns, sampled at a fixed keyframe
spacing, and the landmarks sit one per facade cell on both sides of the
road.  The route, the cells and which cell each keyframe sees are the same
on every seed; the seed moves each landmark inside its cell and draws the
pixel and odometry noise.  Visibility is decided on the cell centres, so
the observation table (which keyframe sees which landmark) never changes
with the seed, and neither does the work per keyframe or per window.

Frames: the robot is x forward, y left, z up; the camera looks along the
robot's x axis (z forward, x right, y down).  Poses are 7-vectors
``[t, q(w, x, y, z)]``, ``G_k = T_world<-robot_k``.  The odometry of
keyframe k is ``T_k<-(k-1)`` with its noise applied on the right, the edge
convention of the engine.  Everything is numpy on the host, made in bulk.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class StereoDrive:
    gt_poses: np.ndarray      # [K, 7] float64 ground truth
    landmarks: np.ndarray     # [M, 3] float64 world points (one per cell)
    obs_kf: np.ndarray        # [n] int64, sorted by (kf, landmark)
    obs_lm: np.ndarray        # [n] int64 landmark (cell) id
    obs_z: np.ndarray         # [n, 4] float32 (ul, vl, ur, vr), noisy
    odometry: np.ndarray      # [K-1, 7] float32 noisy T_k<-(k-1), k >= 1
    frame_start: np.ndarray   # [K+1] int64: frame k is rows [s[k], s[k+1])


def _yaw_quat(yaw):
    half = 0.5 * np.asarray(yaw, np.float64)
    z = np.zeros_like(half)
    return np.stack([np.cos(half), z, z, np.sin(half)], axis=-1)


def quat_to_matrix(q):
    """Unit quaternions ``[..., 4]`` (w, x, y, z) -> ``[..., 3, 3]``."""
    w, x, y, z = np.moveaxis(np.asarray(q, np.float64), -1, 0)
    r = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        axis=-1)
    return r.reshape(r.shape[:-1] + (3, 3))


def quat_mul(a, b):
    aw, ax, ay, az = np.moveaxis(a, -1, 0)
    bw, bx, by, bz = np.moveaxis(b, -1, 0)
    return np.stack([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw], axis=-1)


def quat_exp(w):
    """Rotation vectors ``[..., 3]`` -> unit quaternions."""
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w, axis=-1, keepdims=True)
    k = np.where(th > 1e-12, np.sin(0.5 * th) / np.maximum(th, 1e-300), 0.5)
    return np.concatenate([np.cos(0.5 * th), k * w], axis=-1)


def compose(a, b):
    """``a o b`` for 7-vector poses (float64)."""
    t = a[..., :3] + np.einsum("...ij,...j->...i", quat_to_matrix(a[..., 3:]),
                               b[..., :3])
    q = quat_mul(a[..., 3:], b[..., 3:])
    return np.concatenate([t, q / np.linalg.norm(q, axis=-1, keepdims=True)],
                          axis=-1)


def inverse(a):
    qi = a[..., 3:] * np.asarray([1.0, -1.0, -1.0, -1.0])
    t = -np.einsum("...ij,...j->...i", quat_to_matrix(qi), a[..., :3])
    return np.concatenate([t, qi], axis=-1)


def route(num_kfs: int, spacing: float, street: float, turn_radius: float):
    """Keyframe poses along a staircase of streets: ``street`` metres
    straight, a quarter turn of ``turn_radius`` to the left, ``street``
    metres, a quarter turn to the right, and so on, so the drive never comes
    back to a place.  Returns ``(xy [K, 2], yaw [K], s [K])``, the arc length
    of keyframe k being ``k * spacing``."""
    s = np.arange(num_kfs, dtype=np.float64) * spacing
    xy, yaw = _along(s, street, turn_radius)
    return xy, yaw, s


def _along(s, street, turn_radius):
    """Position and heading at arc lengths ``s`` of the staircase route."""
    arc = 0.5 * np.pi * turn_radius
    period = street + arc
    x = np.zeros_like(s)
    y = np.zeros_like(s)
    yaw = np.zeros_like(s)
    n_max = int(np.max(s) // period) + 1 if s.size else 0
    px, py, h = 0.0, 0.0, 0.0
    for i in range(n_max + 1):
        s0 = i * period
        turn = 1.0 if i % 2 == 0 else -1.0     # left, then right
        seg = (s >= s0) & (s < s0 + street)
        d = s[seg] - s0
        x[seg] = px + d * np.cos(h)
        y[seg] = py + d * np.sin(h)
        yaw[seg] = h
        ex, ey = px + street * np.cos(h), py + street * np.sin(h)
        cx = ex - turn * turn_radius * np.sin(h)
        cy = ey + turn * turn_radius * np.cos(h)
        sel = (s >= s0 + street) & (s < s0 + period)
        phi = (s[sel] - s0 - street) / turn_radius
        hh = h + turn * phi
        x[sel] = cx + turn * turn_radius * np.sin(hh)
        y[sel] = cy - turn * turn_radius * np.cos(hh)
        yaw[sel] = hh
        h_end = h + turn * 0.5 * np.pi
        px = cx + turn * turn_radius * np.sin(h_end)
        py = cy - turn * turn_radius * np.cos(h_end)
        h = h_end
    return np.stack([x, y], axis=-1), yaw


def facade_cells(length: float, street: float, turn_radius: float,
                 offset: float, cell_along: float, heights):
    """Centres ``[M, 3]`` of the facade cells on both sides of the route up
    to arc length ``length``, and the arc length of each: one cell per
    ``cell_along`` metres per side per height row, ordered by arc length."""
    s = np.arange(0.5 * cell_along, length, cell_along)
    xy, yaw = _along(s, street, turn_radius)
    normal = np.stack([-np.sin(yaw), np.cos(yaw)], axis=-1)
    cells, arcs = [], []
    for i in range(s.shape[0]):
        for side in (1.0, -1.0):
            p = xy[i] + side * offset * normal[i]
            for z in heights:
                cells.append((p[0], p[1], z))
                arcs.append(s[i])
    return np.asarray(cells, np.float64), np.asarray(arcs, np.float64)


def make_drive(cfg: dict, seed: int, num_kfs: int | None = None
               ) -> StereoDrive:
    """The drive of ``cfg`` (the configuration file's ``world`` and
    ``camera`` groups) for ``seed``; ``num_kfs`` overrides the length."""
    w, cam = cfg["world"], cfg["camera"]
    K = int(num_kfs if num_kfs is not None else cfg["num_keyframes"])
    spacing, street, rad = (w["keyframe_spacing_m"], w["street_m"],
                            w["turn_radius_m"])
    xy, yaw, s_kf = route(K, spacing, street, rad)
    cam_h = w["camera_height_m"]
    gt = np.concatenate([xy, np.full((K, 1), cam_h), _yaw_quat(yaw)], axis=-1)

    rng_gate = w["range_gate_m"]
    heights = np.arange(w["facade_bottom_m"], w["facade_top_m"] + 1e-9,
                        w["cell_height_m"])
    cells, s_cell = facade_cells(s_kf[-1] + rng_gate + 5.0, street, rad,
                                 w["facade_offset_m"], w["cell_along_m"],
                                 heights)
    M = cells.shape[0]

    rng = np.random.default_rng(seed)
    jitter = rng.uniform(-0.5, 0.5, (M, 3)) * np.asarray(
        [w["cell_along_m"] * w["jitter_share"], w["relief_m"],
         w["cell_height_m"] * w["jitter_share"]])
    # Jitter along the facade (tangent), out of it (relief) and in height.
    _, yaw_c = _along(s_cell, street, rad)
    tang = np.stack([np.cos(yaw_c), np.sin(yaw_c), 0 * yaw_c], axis=-1)
    norm = np.stack([-np.sin(yaw_c), np.cos(yaw_c), 0 * yaw_c], axis=-1)
    up = np.asarray([0.0, 0.0, 1.0])
    lms = (cells + jitter[:, :1] * tang + jitter[:, 1:2] * norm
           + jitter[:, 2:3] * up)

    fx, fy, cx, cy, b = (cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                         cam["baseline"])
    width, height = cam["width"], cam["height"]

    def to_camera(k, pts):
        R = quat_to_matrix(gt[k, 3:])
        p = (pts - gt[k, :3]) @ R          # robot frame: R^T (p - t)
        return np.stack([-p[:, 1], -p[:, 2], p[:, 0]], axis=-1)

    def stereo(pc):
        iz = 1.0 / pc[:, 2]
        ul = cx + fx * pc[:, 0] * iz
        vl = cy + fy * pc[:, 1] * iz
        ur = cx + fx * (pc[:, 0] - b) * iz
        return np.stack([ul, vl, ur, vl], axis=-1)

    kfs, ids = [], []
    order = np.argsort(s_cell, kind="stable")
    s_sorted = s_cell[order]
    for k in range(K):
        lo = np.searchsorted(s_sorted, s_kf[k] - 2.0 * w["facade_offset_m"])
        hi = np.searchsorted(s_sorted, s_kf[k] + rng_gate + 2.0)
        cand = np.sort(order[lo:hi])
        pc = to_camera(k, cells[cand])
        zc = stereo(np.where(pc[:, 2:3] > 0, pc, 1.0))
        vis = pc[:, 2] > w["min_depth_m"]
        vis &= (zc[:, 0] >= 0) & (zc[:, 0] < width)
        vis &= (zc[:, 1] >= 0) & (zc[:, 1] < height)
        vis &= (zc[:, 2] >= 0) & (zc[:, 2] < width)
        vis &= np.linalg.norm(pc, axis=-1) < rng_gate
        # A stereo front end makes a landmark of a close point only (ORB-
        # SLAM2's ThDepth): the drive sees a cell while it is that close.
        vis &= pc[:, 2] < w["close_depth_baselines"] * b
        sel = cand[vis]
        kfs.append(np.full(sel.shape[0], k, np.int64))
        ids.append(sel.astype(np.int64))
    obs_kf = np.concatenate(kfs)
    obs_lm = np.concatenate(ids)
    frame_start = np.concatenate([[0], np.cumsum([a.shape[0] for a in kfs])])

    z = np.empty((obs_kf.shape[0], 4), np.float64)
    for k in range(K):
        a, e = frame_start[k], frame_start[k + 1]
        z[a:e] = stereo(to_camera(k, lms[obs_lm[a:e]]))
    z += rng.normal(0.0, w["pixel_noise_px"], z.shape)

    rel = compose(inverse(gt[1:]), gt[:-1])          # T_k<-(k-1)
    noise = rng.normal(0.0, w["odometry_noise"], (K - 1, 6))
    odo = compose(rel, np.concatenate([noise[:, :3], quat_exp(noise[:, 3:])],
                                      axis=-1))
    return StereoDrive(gt, lms, obs_kf, obs_lm, z.astype(np.float32),
                       odo.astype(np.float32), frame_start.astype(np.int64))
