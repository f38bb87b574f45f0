"""Tutorial: relative-pose graph-SLAM (no landmarks) — the analog of the
reference's relative graph-SLAM tutorial (BASELINE config #4).

Pose 'landmarks' are fixed identities at their own keyframes; relative-pose
observations constrain the kf2kf edge chain, and observing a keyframe that is
unreachable within the spanning-tree depth creates a loop-closure edge.

Run:  python -m srba_tpu_torch.examples.tutorial_graph_slam_se2
      (add --device cpu to run on the host)
"""

import argparse

import numpy as np

from srba_tpu_torch import Observation, SrbaEngine, SrbaParams
from srba_tpu_torch.ops.np_lie import NpSE2
from srba_tpu_torch.utils.datasets import (ate_rmse, make_graph_slam_dataset,
                                     make_world_loop_2d)


def main(device="cuda"):
    world = make_world_loop_2d(num_kfs=50, radius=8.0, num_landmarks=1,
                               seed=2)
    ds = make_graph_slam_dataset(world, noise_std=0.005, odo_noise_std=0.05,
                                 loop_closure_range=3.5, seed=2)

    eng = SrbaEngine(
        "RelativePoses2D",
        params=SrbaParams(max_tree_depth=4, max_optimize_depth=4),
        device=device)

    for k, frame in enumerate(ds.frames):
        obs = [Observation(lm_id=j, z=z) for j, z in frame]
        edge_init = {k - 1: ds.odometry[k - 1]} if k > 0 else None
        eng.define_new_keyframe(obs, edge_init=edge_init)

    G, _ = eng.create_complete_spanning_tree(0)
    ate = ate_rmse(G[:, :2], world.gt_poses[:, :2])

    # Compare against dead reckoning on the noisy odometry.
    D = np.zeros((len(ds.frames), 3), np.float32)
    for k in range(1, len(ds.frames)):
        D[k] = NpSE2.compose(D[k - 1], NpSE2.inverse(ds.odometry[k - 1]))
    ate_dr = ate_rmse(D[:, :2], world.gt_poses[:, :2])

    closures = eng.state.num_edges - (eng.num_keyframes - 1)
    print(f"keyframes: {eng.num_keyframes}  loop-closure edges: {closures}")
    print(f"ATE: {ate:.4f} m   (dead reckoning: {ate_dr:.4f} m)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the host)")
    main(ap.parse_args().device)
