"""Synthetic world / dataset generation and trajectory metrics — the port of
:mod:`srba_tpu.utils.datasets` (``make_world_loop_2d``,
``make_world_loop_3d``, ``make_world_loop_3d_large``, ``observe``,
``observe_sparse``, ``make_graph_slam_dataset``, ``umeyama_align``,
``ate_rmse``).

Everything here is numpy on the host.  Observation values come from the
model's ``h`` on numpy input (numpy in, numpy out), the same formulas and
the same numpy calls as the JAX package's host path, so the same seed gives
bit-identical datasets in both packages (``tests/test_torch_e2e_rb2d.py``,
``test_torch_e2e_rb3d.py``, ``test_torch_e2e_graphslam.py``,
``test_torch_e2e_stereo.py`` and ``test_torch_datasets.py`` check it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np

from srba_tpu_torch.models.observations import OBSERVATION_MODELS
from srba_tpu_torch.ops.np_lie import NP_GROUPS
from srba_tpu_torch.utils.registry import lookup


@dataclass
class World:
    """Ground-truth world: global KF poses + global landmark positions."""

    group_name: str                  # "SE2" | "SE3"
    gt_poses: np.ndarray             # [K, pose_dim] global
    landmarks: np.ndarray            # [M, point_dim] global


@dataclass
class SlamDataset:
    world: World
    # frames[k] = list of (landmark_id, z) observed from KF k
    frames: List[List[Tuple[int, np.ndarray]]]
    # odometry[k] = noisy T_{k}<-{k-1} relative pose measurement (k >= 1),
    # i.e. the pose of KF k-1 expressed in KF k's frame — matches the edge
    # convention T_from<-to for an edge (from=k, to=k-1).
    odometry: List[np.ndarray]
    obs_model: str


def make_world_loop_2d(num_kfs: int = 100, radius: float = 10.0,
                       num_landmarks: int = 150, seed: int = 0,
                       revolutions: float = 1.0) -> World:
    """Circular loop trajectory (robot faces along the tangent) with
    landmarks scattered in an annulus around the path.  ``revolutions > 1``
    makes the robot revisit the same places (loop-closure scenarios)."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0.0, 2.0 * np.pi * revolutions, num_kfs,
                      endpoint=False)
    gt = np.stack(
        [radius * np.cos(ang), radius * np.sin(ang),
         np.arctan2(np.cos(ang), -np.sin(ang))],
        axis=-1).astype(np.float32)
    r = rng.uniform(radius * 0.5, radius * 1.5, num_landmarks)
    th = rng.uniform(0, 2 * np.pi, num_landmarks)
    lms = np.stack([r * np.cos(th), r * np.sin(th)], axis=-1).astype(np.float32)
    return World("SE2", gt, lms)


def make_world_loop_3d(num_kfs: int = 100, radius: float = 10.0,
                       num_landmarks: int = 200, height_amp: float = 2.0,
                       seed: int = 0) -> World:
    """3D loop: circular path with sinusoidal height, yaw along tangent."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0.0, 2.0 * np.pi, num_kfs, endpoint=False)
    xyz = np.stack(
        [radius * np.cos(ang), radius * np.sin(ang),
         height_amp * np.sin(2 * ang)], axis=-1)
    yaw = ang + np.pi / 2
    half = yaw * 0.5
    quat = np.stack([np.cos(half), np.zeros_like(half),
                     np.zeros_like(half), np.sin(half)], axis=-1)
    gt = np.concatenate([xyz, quat], axis=-1).astype(np.float32)
    r = rng.uniform(radius * 0.5, radius * 1.5, num_landmarks)
    th = rng.uniform(0, 2 * np.pi, num_landmarks)
    z = rng.uniform(-3.0, 5.0, num_landmarks)
    lms = np.stack([r * np.cos(th), r * np.sin(th), z],
                   axis=-1).astype(np.float32)
    return World("SE3", gt, lms)


def _camera_frame(pts_robot: np.ndarray) -> np.ndarray:
    """Robot frame (x fwd, y left, z up) -> camera frame (z fwd, x right,
    y down), the frame camera observations are generated in."""
    x, y, z = pts_robot[..., 0], pts_robot[..., 1], pts_robot[..., 2]
    return np.stack([-y, -z, x], axis=-1)


CAMERA_MODELS = ("MonocularCamera", "StereoCamera", "RGBDCamera")


def _observe_points(model, pts, calib, sensor_range, image_size, min_depth,
                    camera_frame_convention):
    """Observations ``[..., z_dim]`` (float32) of robot-frame points
    ``[..., pd]`` and their visibility: the range gate for range/Cartesian
    models; for cameras the frustum gate (depth above ``min_depth``, pixels
    inside ``image_size``, the right image too for 4-d stereo
    observations) and the range gate."""
    if model.name not in CAMERA_MODELS:
        zs = np.asarray(model.h(np.asarray(pts, np.float32), calib),
                        np.float32)
        return zs, np.linalg.norm(pts, axis=-1) < sensor_range
    cam_pts = _camera_frame(pts) if camera_frame_convention else pts
    zs = np.asarray(model.h(np.asarray(cam_pts, np.float32), calib),
                    np.float32)
    w, h = image_size
    vis = (cam_pts[..., 2] > min_depth)
    vis &= (zs[..., 0] >= 0) & (zs[..., 0] < w)
    vis &= (zs[..., 1] >= 0) & (zs[..., 1] < h)
    if model.obs_dim == 4:
        vis &= (zs[..., 2] >= 0) & (zs[..., 2] < w)
    vis &= np.linalg.norm(cam_pts, axis=-1) < sensor_range
    return zs, vis


def _odometry(world: World, group, rng, odo_noise_std: float):
    """Noisy ``T_k<-{k-1} = inv(G_k) o G_{k-1}`` for k >= 1 (float32)."""
    odometry: List[np.ndarray] = []
    for k in range(1, world.gt_poses.shape[0]):
        rel = group.compose(group.inverse(world.gt_poses[k]),
                            world.gt_poses[k - 1])
        if odo_noise_std > 0:
            rel = group.retract(rel, rng.normal(0.0, odo_noise_std,
                                                group.dof))
        odometry.append(np.asarray(rel, np.float32))
    return odometry


def observe(world: World, obs_model: str, calib: Any = None,
            noise_std: float = 0.0, sensor_range: float = 6.0,
            image_size: Tuple[int, int] = (320, 240),
            min_depth: float = 0.3, camera_frame_convention: bool = True,
            seed: int = 0, odo_noise_std: float = 0.0) -> SlamDataset:
    """Generate per-keyframe observations + odometry for ``world`` under the
    given observation model (visibility: :func:`_observe_points`).
    ``calib`` is the camera's calibration (float32 numpy scalars)."""
    model = lookup(OBSERVATION_MODELS, obs_model, "observation model")
    group = lookup(NP_GROUPS, world.group_name, "pose group")
    rng = np.random.default_rng(seed + 1)
    K = world.gt_poses.shape[0]

    # Landmarks in every robot frame: [K, M, pd].
    inv_poses = group.inverse(world.gt_poses)            # [K, pose_dim]
    pts = group.apply(inv_poses[:, None, :], world.landmarks[None, :, :])
    zs, vis = _observe_points(model, pts, calib, sensor_range, image_size,
                              min_depth, camera_frame_convention)

    noise = rng.normal(0.0, noise_std, zs.shape).astype(np.float32)
    zs = zs + noise

    frames: List[List[Tuple[int, np.ndarray]]] = []
    for k in range(K):
        frame = [(int(m), zs[k, m].astype(np.float32))
                 for m in np.nonzero(vis[k])[0]]
        frames.append(frame)

    odometry = _odometry(world, group, rng, odo_noise_std)
    return SlamDataset(world, frames, odometry, obs_model)


def observe_sparse(world: World, obs_model: str, calib: Any = None,
                   noise_std: float = 0.0, sensor_range: float = 6.0,
                   image_size: Tuple[int, int] = (320, 240),
                   min_depth: float = 0.3,
                   camera_frame_convention: bool = True,
                   seed: int = 0,
                   odo_noise_std: float = 0.0) -> SlamDataset:
    """Memory-bounded :func:`observe` for large worlds (config #5: 5k
    keyframes): landmarks are hashed into ``sensor_range``-sized grid cells
    on (x, y) and each keyframe tests only its 3x3 cell neighborhood, so
    the cost is O(K x local density) instead of the dense [K, M] product.
    All candidate pairs go through the model's ``h`` in one call."""
    model = lookup(OBSERVATION_MODELS, obs_model, "observation model")
    group = lookup(NP_GROUPS, world.group_name, "pose group")
    rng = np.random.default_rng(seed + 1)
    K = world.gt_poses.shape[0]

    # Spatial hash of landmarks on (x, y).
    cell = float(sensor_range)
    keys = np.floor(world.landmarks[:, :2] / cell).astype(np.int64)
    grid: Dict[Tuple[int, int], List[int]] = {}
    for m, (cx, cy) in enumerate(keys):
        grid.setdefault((int(cx), int(cy)), []).append(m)

    pos = world.gt_poses[:, :2]
    pair_k: List[np.ndarray] = []
    pair_m: List[np.ndarray] = []
    for k in range(K):
        cx, cy = int(np.floor(pos[k, 0] / cell)), \
            int(np.floor(pos[k, 1] / cell))
        cand: List[int] = []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                cand.extend(grid.get((cx + dx, cy + dy), ()))
        if cand:
            cand_a = np.asarray(cand, np.int64)
            pair_k.append(np.full(cand_a.shape, k, np.int64))
            pair_m.append(cand_a)
    pk = np.concatenate(pair_k)
    pm = np.concatenate(pair_m)

    inv_poses = group.inverse(world.gt_poses)
    pts = group.apply(inv_poses[pk], world.landmarks[pm])   # [P, pd]
    zs, vis = _observe_points(model, pts, calib, sensor_range, image_size,
                              min_depth, camera_frame_convention)
    zs = (zs + rng.normal(0.0, noise_std, zs.shape)).astype(np.float32)

    frames: List[List[Tuple[int, np.ndarray]]] = [[] for _ in range(K)]
    for i in np.nonzero(vis)[0]:
        frames[int(pk[i])].append((int(pm[i]), zs[i]))

    odometry = _odometry(world, group, rng, odo_noise_std)
    return SlamDataset(world, frames, odometry, obs_model)


def make_world_loop_3d_large(num_kfs: int, radius: float = 30.0,
                             num_landmarks: int = 8000,
                             revolutions: float = 2.5,
                             height_amp: float = 2.0,
                             seed: int = 0) -> World:
    """Multi-revolution 3D loop for large runs (config #5): the robot
    revisits the same places ``revolutions`` times, so local-areas loop
    closures fire throughout."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0.0, 2.0 * np.pi * revolutions, num_kfs,
                      endpoint=False)
    xyz = np.stack(
        [radius * np.cos(ang), radius * np.sin(ang),
         height_amp * np.sin(2 * ang)], axis=-1)
    yaw = ang + np.pi / 2
    half = yaw * 0.5
    quat = np.stack([np.cos(half), np.zeros_like(half),
                     np.zeros_like(half), np.sin(half)], axis=-1)
    gt = np.concatenate([xyz, quat], axis=-1).astype(np.float32)
    r = rng.uniform(radius * 0.75, radius * 1.25, num_landmarks)
    th = rng.uniform(0, 2 * np.pi, num_landmarks)
    z = rng.uniform(-2.0, 6.0, num_landmarks)
    lms = np.stack([r * np.cos(th), r * np.sin(th), z],
                   axis=-1).astype(np.float32)
    return World("SE3", gt, lms)


def make_graph_slam_dataset(world: World, noise_std: float = 0.0,
                            loop_closure_range: float = 2.0,
                            odo_noise_std: float = 0.0,
                            seed: int = 0) -> SlamDataset:
    """Relative pose-graph dataset (graph-SLAM mode): each KF 'observes' the
    relative pose of earlier nearby KFs.  frame[k] entries are
    (observed_kf_id, T_k<-observed) — observed KF ids double as landmark ids
    in the RelativePoses models."""
    rng = np.random.default_rng(seed + 2)
    group = lookup(NP_GROUPS, world.group_name, "pose group")
    K = world.gt_poses.shape[0]
    frames: List[List[Tuple[int, np.ndarray]]] = [[]]
    odometry: List[np.ndarray] = []
    positions = world.gt_poses[:, :2] if world.group_name == "SE2" \
        else world.gt_poses[:, :3]
    for k in range(1, K):
        gt_rel = group.compose(group.inverse(world.gt_poses[k]),
                               world.gt_poses[k - 1])
        odo = gt_rel
        if odo_noise_std > 0:
            odo = group.retract(gt_rel,
                                rng.normal(0, odo_noise_std, group.dof))
        odometry.append(np.asarray(odo, np.float32))
        frame: List[Tuple[int, np.ndarray]] = []

        def noisy(T):
            if noise_std > 0:
                return np.asarray(
                    group.retract(T, rng.normal(0, noise_std, group.dof)),
                    np.float32)
            return np.asarray(T, np.float32)

        frame.append((k - 1, noisy(gt_rel)))
        # Loop closures to older spatially-near KFs (skip immediate chain).
        d = np.linalg.norm(positions[:k - 1] - positions[k], axis=-1) \
            if k >= 2 else np.zeros((0,))
        for j in np.nonzero(d < loop_closure_range)[0]:
            T = group.compose(group.inverse(world.gt_poses[k]),
                              world.gt_poses[j])
            frame.append((int(j), noisy(T)))
        frames.append(frame)
    return SlamDataset(world, frames, odometry,
                       "RelativePoses2D" if world.group_name == "SE2"
                       else "RelativePoses3D")


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def umeyama_align(est: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Rigid (rotation+translation, no scale) alignment of estimated points
    onto ground truth; returns the aligned estimate."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    U, _, Vt = np.linalg.svd(E.T @ G)
    d = est.shape[1]
    S = np.eye(d)
    if np.linalg.det(U @ Vt) < 0:
        S[-1, -1] = -1.0
    R = (U @ S @ Vt).T
    return (R @ E.T).T + mu_g


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray,
             align: bool = True) -> float:
    """Absolute trajectory error (RMSE over positions) after optional rigid
    alignment."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    if align:
        est = umeyama_align(est, gt)
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=-1))))
