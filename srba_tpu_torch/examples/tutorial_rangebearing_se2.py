"""Tutorial: 2D range-bearing SLAM with SE(2) keyframes — the analog of the
reference's ``tutorial-srba-range-bearing-se2`` example (BASELINE config #1).

Run:  python -m srba_tpu_torch.examples.tutorial_rangebearing_se2
      (add --device cpu to run on the host)
"""

import argparse

from srba_tpu_torch import Observation, SrbaEngine, SrbaParams
from srba_tpu_torch.utils.datasets import ate_rmse, make_world_loop_2d, observe


def main(device="cuda"):
    # Synthetic world: a 100-keyframe loop with scattered landmarks (the
    # reference embeds similar datasets generated with its RWT toolkit).
    world = make_world_loop_2d(num_kfs=100, radius=10.0, num_landmarks=180,
                               seed=0)
    ds = observe(world, "RangeBearing2D", noise_std=0.005, sensor_range=6.0,
                 odo_noise_std=0.01, seed=0)

    eng = SrbaEngine(
        "RangeBearing2D",
        params=SrbaParams(max_tree_depth=4, max_optimize_depth=4),
        device=device)

    for k, frame in enumerate(ds.frames):
        obs = [Observation(lm_id=m, z=z) for m, z in frame]
        edge_init = {k - 1: ds.odometry[k - 1]} if k > 0 else None
        info = eng.define_new_keyframe(obs, edge_init=edge_init)
        if k % 20 == 0:
            print(f"kf {k}: {info.optimize_results}")

    print(f"\nkeyframes: {eng.num_keyframes}  landmarks: {eng.num_landmarks}")
    print(f"overall squared error: {eng.eval_overall_squared_error():.4f}")
    G, _ = eng.create_complete_spanning_tree(0)
    print(f"ATE vs ground truth: "
          f"{ate_rmse(G[:, :2], world.gt_poses[:, :2]):.4f} m")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the host)")
    main(ap.parse_args().device)
