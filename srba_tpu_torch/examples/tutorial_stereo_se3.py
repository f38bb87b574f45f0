"""Tutorial: stereo-camera SRBA with SE(3) keyframes and an SE(3) sensor
mounting pose — the analog of the reference's stereo tutorial (BASELINE
config #3: Schur complement over landmarks).

Run:  python -m srba_tpu_torch.examples.tutorial_stereo_se3
      (add --device cpu to run on the host)
"""

import argparse

from srba_tpu_torch import Observation, SrbaEngine, SrbaParams
from srba_tpu_torch.models.observations import StereoCalib
from srba_tpu_torch.models.sensor_pose import SensorPoseSE3
from srba_tpu_torch.ops.np_lie import CAMERA_SENSOR_POSE_SE3
from srba_tpu_torch.utils.datasets import ate_rmse, make_world_loop_3d, observe


def main(device="cuda"):
    world = make_world_loop_3d(num_kfs=60, radius=8.0, num_landmarks=400,
                               height_amp=0.5, seed=1)
    calib = StereoCalib.make(fx=200.0, fy=200.0, cx=160.0, cy=120.0,
                             baseline=0.12)
    ds = observe(world, "StereoCamera", calib=calib, noise_std=0.3,
                 sensor_range=9.0, odo_noise_std=0.01, seed=1)

    eng = SrbaEngine(
        "StereoCamera", calib=calib,
        # Camera looks along +z of the sensor frame; this mounting pose maps
        # the robot's x-forward frame onto the camera axes.
        sensor_pose=SensorPoseSE3(CAMERA_SENSOR_POSE_SE3),
        params=SrbaParams(max_tree_depth=4, max_optimize_depth=4),
        device=device)

    for k, frame in enumerate(ds.frames):
        obs = [Observation(lm_id=m, z=z) for m, z in frame]
        edge_init = {k - 1: ds.odometry[k - 1]} if k > 0 else None
        eng.define_new_keyframe(obs, edge_init=edge_init)

    print(f"keyframes: {eng.num_keyframes}  landmarks: {eng.num_landmarks}")
    G, _ = eng.create_complete_spanning_tree(0)
    print(f"ATE vs ground truth: "
          f"{ate_rmse(G[:, :3], world.gt_poses[:, :3]):.4f} m")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the host)")
    main(ap.parse_args().device)
