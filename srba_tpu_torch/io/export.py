"""Exporters — the port of :mod:`srba_tpu.io.export` (the reference's I/O
and visualization layer): ``save_graph_as_dot``,
``get_global_graphslam_problem`` (the input of the global PGO,
:mod:`srba_tpu_torch.solver.global_graphslam`), ``save_graphslam_g2o`` and
``build_opengl_representation`` with its JSON/PLY writers.

All of them are host-side, read-only paths: plain Python and numpy over the
engine's SoA state (the engine syncs its host mirror first).  The graph-SLAM
export writes the portable g2o text format (``VERTEX_SE2``/``EDGE_SE2`` and
``VERTEX_SE3:QUAT``/``EDGE_SE3:QUAT``); the "OpenGL" representation is a
backend-neutral scene dict (points/lines/frames).  Same output as the JAX
package's exporters on the same state.
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Dict, Optional

import numpy as np


def save_graph_as_dot(engine, path: str,
                      show_spanning_tree_root: Optional[int] = None) -> None:
    """Graphviz dump of the KF graph; optionally highlights the spanning
    tree of one root (reference ``save_graph_as_dot``)."""
    g = engine.graph
    st_edges = set()
    if show_spanning_tree_root is not None:
        _, parent = g.bfs_tree(show_spanning_tree_root)
        st_edges = {eid for (_, eid) in parent.values()}
    lines = ["graph srba {", "  node [shape=circle fontsize=10];"]
    for kf in range(g.num_kfs):
        lines.append(f"  kf{kf} [label=\"{kf}\"];")
    for eid, (a, b) in enumerate(g.edges):
        style = " [color=red penwidth=2]" if eid in st_edges else ""
        lines.append(f"  kf{a} -- kf{b}{style};")
    lines.append("}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def edge_observation_support(engine) -> np.ndarray:
    """Per-edge observation support [num_edges]: how many observations'
    bounded spanning-tree paths (observer KF -> landmark base KF) traverse
    each kf2kf edge, floored at 1 (a scalar information proxy; see the JAX
    package for why it no longer feeds the PGO weights)."""
    st = engine.state
    g = engine.graph
    depth = engine.parameters.max_tree_depth
    support = np.zeros(st.num_edges, np.float64)
    for kf in range(st.num_kfs):
        obs = st.kf_obs[kf]
        if not obs:
            continue
        dist, parent = g.bfs_tree(kf, depth)
        base_counts = Counter(int(st.lm_base[int(st.obs_lm[o])])
                              for o in obs)
        for base, c in base_counts.items():
            n = base
            if n not in dist:
                continue
            while n != kf:
                p, eid = parent[n]
                support[eid] += c
                n = p
    return np.maximum(support, 1.0).astype(np.float32)


def get_global_graphslam_problem(engine, with_weights: bool = True,
                                 with_edge_info: bool = False) -> Dict:
    """Convert the relative problem into an absolute-coordinate pose graph
    (reference ``get_global_graphslam_problem``): nodes = KFs with global
    poses composed from the complete spanning tree, edges = all k2k edges as
    relative-pose constraints, ``edge_weights`` = per-edge information.

    Per-edge information is sigma-based: an edge whose closure-bootstrap fit
    recorded a covariance (``state.k2k_sigma``) gets
    ``clip((closure_prior_sigma / sigma)^2, 0.05, 1)``, every other edge 1.
    With ``with_edge_info`` and some measured fit (``state.k2k_info``), the
    eig-normalized anisotropic information shapes go out as
    ``edge_info_sqrt`` [E, dof, dof]."""
    G, dist = engine.create_complete_spanning_tree(0)
    st = engine.state
    edges = []
    for e in range(st.num_edges):
        a, b = int(st.k2k_from[e]), int(st.k2k_to[e])
        # Constraint: pose of b in a's frame = stored edge pose T_a<-b.
        edges.append({"from": a, "to": b,
                      "rel_pose": np.asarray(st.k2k_pose[e])})
    out = {
        "group": engine.group.name,
        "nodes": np.asarray(G),
        "reachable": sorted(dist.keys()),
        "edges": edges,
    }
    if with_weights:
        sig = np.asarray(st.k2k_sigma[: st.num_edges], np.float64)
        s0 = float(engine.parameters.closure_prior_sigma)
        out["edge_weights"] = np.where(
            sig > 0,
            np.clip((s0 / np.maximum(sig, 1e-6)) ** 2, 0.05, 1.0),
            1.0).astype(np.float32)
        # Shapes eig-normalized to max eigenvalue 1 (the scalar weights keep
        # the overall strength), floored at 0.05; emitted only when some
        # edge has a measured fit.
        info = np.asarray(st.k2k_info[: st.num_edges], np.float64)
        measured = np.abs(info).sum(axis=(1, 2)) > 0
        if with_edge_info and measured.any():
            dof = st.pose_dof
            shapes = np.tile(np.eye(dof), (st.num_edges, 1, 1))
            lam, U = np.linalg.eigh(info[measured])
            lam_n = np.clip(lam / np.maximum(lam[:, -1:], 1e-12), 0.05, 1.0)
            shapes[measured] = np.einsum(
                "eij,ej,ekj->eik", U, np.sqrt(lam_n), U)
            out["edge_info_sqrt"] = shapes.astype(np.float32)
    return out


def save_graphslam_g2o(engine, path: str) -> None:
    """Write the global pose-graph in g2o text format.  Edge information
    matrices are the full anisotropic matrices where closure-fit
    covariances were measured (``edge_info_sqrt``, scaled by the scalar
    edge weight), else scaled identities."""
    prob = get_global_graphslam_problem(engine, with_edge_info=True)
    w = prob["edge_weights"]
    shapes = prob.get("edge_info_sqrt")
    dof = 3 if prob["group"] == "SE2" else 6

    def info_mat(ei):
        m = np.eye(dof) * float(w[ei])
        if shapes is not None:
            s = np.asarray(shapes[ei], np.float64)
            m = float(w[ei]) * (s @ s)          # Wsqrt is symmetric
        return " ".join(f"{v:.4f}" for v in m[np.triu_indices(dof)])

    lines = []
    if prob["group"] == "SE2":
        for i, p in enumerate(prob["nodes"]):
            lines.append(f"VERTEX_SE2 {i} {p[0]:.9f} {p[1]:.9f} {p[2]:.9f}")
        for ei, e in enumerate(prob["edges"]):
            r = e["rel_pose"]
            lines.append(
                f"EDGE_SE2 {e['from']} {e['to']} "
                f"{r[0]:.9f} {r[1]:.9f} {r[2]:.9f} {info_mat(ei)}")
    else:
        for i, p in enumerate(prob["nodes"]):
            # g2o order: x y z qx qy qz qw  (ours is w-first)
            lines.append(
                f"VERTEX_SE3:QUAT {i} {p[0]:.9f} {p[1]:.9f} {p[2]:.9f} "
                f"{p[4]:.9f} {p[5]:.9f} {p[6]:.9f} {p[3]:.9f}")
        for ei, e in enumerate(prob["edges"]):
            r = e["rel_pose"]
            lines.append(
                f"EDGE_SE3:QUAT {e['from']} {e['to']} "
                f"{r[0]:.9f} {r[1]:.9f} {r[2]:.9f} "
                f"{r[4]:.9f} {r[5]:.9f} {r[6]:.9f} {r[3]:.9f} "
                f"{info_mat(ei)}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def build_opengl_representation(engine, span_tree_root: Optional[int] = None,
                                frame_axis_len: float = 0.3) -> Dict:
    """Backend-neutral 3D scene of the map (reference
    ``build_opengl_representation``): KF coordinate frames, landmark points
    in global coordinates, k2k edge segments, optional spanning-tree
    highlight."""
    G, dist = engine.create_complete_spanning_tree(0)
    st = engine.state
    group = engine.np_group
    is2d = engine.group.name == "SE2"

    def lift(p):  # global position as 3-vector
        return np.asarray([p[0], p[1], 0.0]) if is2d else np.asarray(p[:3])

    kf_positions = np.stack([lift(G[k]) for k in range(st.num_kfs)]) \
        if st.num_kfs else np.zeros((0, 3))

    # Landmarks: base-relative -> global (point landmarks only).
    lm_points = []
    if not getattr(engine.model, "is_pose_landmark", False):
        for l in range(st.num_lms):
            base = int(st.lm_base[l])
            if base not in dist:
                continue
            pt = group.apply(G[base], st.lm_state[l])
            lm_points.append(lift(np.concatenate([pt, np.zeros(3)])[:3])
                             if is2d else np.asarray(pt))
    lm_points = (np.stack(lm_points) if lm_points else np.zeros((0, 3)))

    edges = [(int(st.k2k_from[e]), int(st.k2k_to[e]))
             for e in range(st.num_edges)]
    st_edges = []
    if span_tree_root is not None:
        _, parent = engine.graph.bfs_tree(span_tree_root)
        st_edges = [(p, n) for n, (p, _) in parent.items()]

    return {
        "kf_positions": kf_positions,
        "kf_poses": np.asarray(G),
        "landmarks": lm_points,
        "k2k_edges": edges,
        "spanning_tree_edges": st_edges,
        "frame_axis_len": frame_axis_len,
    }


def save_scene_json(scene: Dict, path: str) -> None:
    out = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
           for k, v in scene.items()}
    with open(path, "w") as f:
        json.dump(out, f)


def save_scene_ply(scene: Dict, path: str) -> None:
    """Landmarks + KF positions as a colored PLY point cloud (landmarks
    white, keyframes red)."""
    kf = scene["kf_positions"]
    lm = scene["landmarks"]
    n = len(kf) + len(lm)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {n}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                "end_header\n")
        for p in kf:
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} 255 64 64\n")
        for p in lm:
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} 230 230 230\n")
