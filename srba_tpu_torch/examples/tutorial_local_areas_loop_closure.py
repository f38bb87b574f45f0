"""Tutorial: local-areas edge-creation policy with loop closures — the
analog of the reference's ``local_areas_fixed_grid`` demos.  The robot goes
around the loop twice; on the second pass it re-observes landmarks based in
the first pass's submaps, which votes loop-closure edges to those area
centers.

Run:  python -m srba_tpu_torch.examples.tutorial_local_areas_loop_closure
      (add --device cpu to run on the host)
"""

import argparse

from srba_tpu_torch import Observation, SrbaEngine, SrbaParams
from srba_tpu_torch.ecps import LocalAreasFixedGrid
from srba_tpu_torch.utils.datasets import ate_rmse, make_world_loop_2d, observe


def main(device="cuda"):
    world = make_world_loop_2d(num_kfs=80, radius=8.0, num_landmarks=150,
                               seed=5, revolutions=2.0)
    ds = observe(world, "RangeBearing2D", noise_std=0.005, sensor_range=6.0,
                 odo_noise_std=0.02, seed=5)
    eng = SrbaEngine(
        "RangeBearing2D",
        ecp=LocalAreasFixedGrid(submap_size=8,
                                min_obs_count_loop_closure=3),
        params=SrbaParams(max_tree_depth=4, max_optimize_depth=4),
        device=device)
    for k, frame in enumerate(ds.frames):
        info = eng.define_new_keyframe(
            [Observation(lm_id=m, z=z) for m, z in frame],
            edge_init={k - 1: ds.odometry[k - 1]} if k > 0 else None)
        closures = [e for e in info.created_edge_ids
                    if abs(int(eng.state.k2k_from[e])
                           - int(eng.state.k2k_to[e])) > eng.ecp.submap_size]
        if closures:
            pairs = [(int(eng.state.k2k_from[e]), int(eng.state.k2k_to[e]))
                     for e in closures]
            print(f"kf {k}: loop closure edges {pairs}")
    G, _ = eng.create_complete_spanning_tree(0)
    print(f"ATE over two revolutions: "
          f"{ate_rmse(G[:, :2], world.gt_poses[:, :2]):.4f} m")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the host)")
    main(ap.parse_args().device)
