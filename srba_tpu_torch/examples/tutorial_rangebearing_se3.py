"""Tutorial: 3D range-bearing SLAM with SE(3) keyframes — the analog of the
reference's range-bearing SE(3) tutorial (BASELINE config #2).

Run:  python -m srba_tpu_torch.examples.tutorial_rangebearing_se3
      (add --device cpu to run on the host)
"""

import argparse

from srba_tpu_torch import Observation, SrbaEngine, SrbaParams
from srba_tpu_torch.utils.datasets import ate_rmse, make_world_loop_3d, observe


def main(device="cuda"):
    world = make_world_loop_3d(num_kfs=60, radius=8.0, num_landmarks=250,
                               seed=4)
    ds = observe(world, "RangeBearing3D", noise_std=0.005, sensor_range=6.0,
                 odo_noise_std=0.01, seed=4)
    eng = SrbaEngine(
        "RangeBearing3D",
        params=SrbaParams(max_tree_depth=4, max_optimize_depth=4),
        device=device)
    for k, frame in enumerate(ds.frames):
        eng.define_new_keyframe(
            [Observation(lm_id=m, z=z) for m, z in frame],
            edge_init={k - 1: ds.odometry[k - 1]} if k > 0 else None)
    print(f"keyframes: {eng.num_keyframes}  landmarks: {eng.num_landmarks}")
    G, _ = eng.create_complete_spanning_tree(0)
    print(f"ATE: {ate_rmse(G[:, :3], world.gt_poses[:, :3]):.4f} m")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the host)")
    main(ap.parse_args().device)
