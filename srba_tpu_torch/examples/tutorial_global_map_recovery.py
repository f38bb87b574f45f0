"""Tutorial: global map recovery and exports — the analog of the reference's
global-map demo (SURVEY.md §1.3): global poses are DERIVED from the relative
map by spanning-tree composition, never stored as state; the map can also be
exported as a standard g2o pose graph, Graphviz DOT, or a PLY point cloud.

Run:  python -m srba_tpu_torch.examples.tutorial_global_map_recovery
      (add --device cpu to run on the host)
"""

import argparse

import tempfile

from srba_tpu_torch import Observation, SrbaEngine, SrbaParams
from srba_tpu_torch.io import (build_opengl_representation, save_graph_as_dot,
                         save_graphslam_g2o, save_scene_ply)
from srba_tpu_torch.utils.datasets import make_world_loop_2d, observe


def main(device="cuda"):
    world = make_world_loop_2d(num_kfs=30, radius=8.0, num_landmarks=80,
                               seed=3)
    ds = observe(world, "RangeBearing2D", noise_std=0.005, sensor_range=6.0,
                 odo_noise_std=0.01, seed=3)
    eng = SrbaEngine("RangeBearing2D",
                     params=SrbaParams(max_tree_depth=4,
                                       max_optimize_depth=4),
                     device=device)
    for k, frame in enumerate(ds.frames):
        eng.define_new_keyframe(
            [Observation(lm_id=m, z=z) for m, z in frame],
            edge_init={k - 1: ds.odometry[k - 1]} if k > 0 else None)

    # Global poses from any root, via the complete spanning tree.
    G, dist = eng.create_complete_spanning_tree(root=0)
    print(f"recovered {len(dist)} global poses; kf10 at "
          f"({G[10, 0]:.2f}, {G[10, 1]:.2f})")

    # BFS visitor: walk the graph outward with callbacks.
    visited = []
    eng.bfs_visitor(0, max_depth=3, kf_visitor=lambda kf, d: visited.append((kf, d)))
    print(f"bfs from 0 (depth<=3) visited {len(visited)} keyframes")

    with tempfile.TemporaryDirectory() as td:
        save_graph_as_dot(eng, f"{td}/graph.dot", show_spanning_tree_root=0)
        save_graphslam_g2o(eng, f"{td}/map.g2o")
        scene = build_opengl_representation(eng, span_tree_root=0)
        save_scene_ply(scene, f"{td}/map.ply")
        print(f"exports written under {td} (dot, g2o, ply)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the host)")
    main(ap.parse_args().device)
