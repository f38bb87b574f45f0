"""Plain-text dataset format for the ``srba_slam`` CLI — the port of
:mod:`srba_tpu.io.dataset_io` (the analog of the reference's dataset text
files consumed by ``apps/srba-slam``: rows of (frame, landmark|frame2,
observation values)).  Pure numpy; the same ``%.9g`` text, so a file this
module writes is byte-identical to the one the JAX package writes.

Format (whitespace-separated, ``#`` comments):
    # srba-dataset v1 obs_model=<name>
    OBS <frame_id> <lm_id> <z...>
    ODO <frame_id> <pose...>      # odometry T_frame<-frame-1
Ground-truth file: rows of ``<frame_id> <pose...>`` (global poses).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from srba_tpu_torch.utils.datasets import SlamDataset, World


def save_dataset(ds: SlamDataset, path: str) -> None:
    with open(path, "w") as f:
        f.write(f"# srba-dataset v1 obs_model={ds.obs_model}\n")
        for k, frame in enumerate(ds.frames):
            if k > 0 and k - 1 < len(ds.odometry):
                vals = " ".join(f"{v:.9g}" for v in ds.odometry[k - 1])
                f.write(f"ODO {k} {vals}\n")
            for lm, z in frame:
                vals = " ".join(f"{v:.9g}" for v in z)
                f.write(f"OBS {k} {lm} {vals}\n")


def load_dataset(path: str) -> Tuple[str, List[list], List[Optional[np.ndarray]]]:
    """Returns ``(obs_model_name, frames, odometry)`` where ``frames[k]`` is
    a list of ``(lm_id, z)`` and ``odometry[k-1]`` is the relative pose for
    frame ``k`` (or None if absent)."""
    obs_model = ""
    frames: List[list] = []
    odo: dict = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                for tok in line.split():
                    if tok.startswith("obs_model="):
                        obs_model = tok.split("=", 1)[1]
                continue
            parts = line.split()
            kind, frame_id = parts[0], int(parts[1])
            while len(frames) <= frame_id:
                frames.append([])
            if kind == "OBS":
                lm_id = int(parts[2])
                z = np.asarray([float(v) for v in parts[3:]], np.float32)
                frames[frame_id].append((lm_id, z))
            elif kind == "ODO":
                odo[frame_id] = np.asarray([float(v) for v in parts[2:]],
                                           np.float32)
            else:
                raise ValueError(f"unknown row kind {kind!r} in {path}")
    odometry = [odo.get(k) for k in range(1, len(frames))]
    return obs_model, frames, odometry


def save_ground_truth(world: World, path: str) -> None:
    with open(path, "w") as f:
        f.write(f"# srba-gt v1 group={world.group_name}\n")
        for k, p in enumerate(world.gt_poses):
            f.write(f"{k} " + " ".join(f"{v:.9g}" for v in p) + "\n")


def load_ground_truth(path: str) -> np.ndarray:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            rows.append((int(parts[0]),
                         np.asarray([float(v) for v in parts[1:]],
                                    np.float32)))
    rows.sort(key=lambda r: r[0])
    return np.stack([p for _, p in rows])
