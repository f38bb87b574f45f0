"""g2o text-format pose-graph importer — the port of :mod:`srba_tpu.io.g2o`.

The reference ecosystem exchanges global pose graphs through standard text
formats (srba-slam consumes RWT-generated datasets, MRPT's graph-slam tools
read and write the g2o/TORO families).  The exporter half lives in
:mod:`srba_tpu_torch.io.export` (``save_graphslam_g2o``); this module parses
``VERTEX_SE2``/``EDGE_SE2`` and ``VERTEX_SE3:QUAT``/``EDGE_SE3:QUAT``
records into the problem dict that
:func:`srba_tpu_torch.io.export.get_global_graphslam_problem` produces, so a
public pose-graph benchmark (sphere2500, manhattan3500, intel, ...) feeds
:func:`srba_tpu_torch.solver.global_graphslam.optimize_global_pose_graph`
directly (the CLI's ``--pgo-g2o``).

Information matrices: by default each edge's information matrix is reduced
to the geometric mean of its diagonal (exact for the isotropic matrices of
the published benchmarks).  ``load_g2o(..., with_edge_info=True)`` also
emits the eig-normalized anisotropic shapes (``edge_info_sqrt``) that
``optimize_global_pose_graph`` whitens each edge with.  Pure numpy: the
arrays are bitwise those of the JAX package's importer.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _quat_wxyz_from_xyzw(qx, qy, qz, qw):
    q = np.asarray([qw, qx, qy, qz], np.float64)
    n = np.linalg.norm(q)
    return (q / n if n > 0 else np.asarray([1.0, 0, 0, 0])).astype(
        np.float32)


def _info_scalar(vals: np.ndarray, dim: int) -> float:
    """Scalar information from the row-major upper-triangular info matrix
    (geometric mean of the diagonal, floored at tiny positive)."""
    iu = np.triu_indices(dim)
    M = np.zeros((dim, dim), np.float64)
    M[iu] = vals
    d = np.maximum(np.diag(M), 1e-12)
    return float(np.exp(np.mean(np.log(d))))


def _info_shape_sqrt(vals: np.ndarray, dim: int) -> np.ndarray:
    """Eig-normalized information SHAPE square root from the row-major
    upper-triangular info values (same normalization as io/export.py:
    spectrum scaled to max eigenvalue 1, floored at 0.05)."""
    iu = np.triu_indices(dim)
    M = np.zeros((dim, dim), np.float64)
    M[iu] = vals
    M = M + np.triu(M, 1).T
    lam, U = np.linalg.eigh(M)
    lam_n = np.clip(lam / max(float(lam[-1]), 1e-12), 0.05, 1.0)
    return (U * np.sqrt(lam_n)[None, :]) @ U.T


def load_g2o(path: str, with_edge_info: bool = False) -> Dict:
    """Parse a g2o text file into a global pose-graph problem dict:
    ``{"group", "nodes" [K, pose_dim], "edges" [...], "edge_weights" [E]}``
    — the exact shape ``optimize_global_pose_graph`` consumes (plus
    ``edge_info_sqrt`` [E, dof, dof] with ``with_edge_info``; module
    docstring).

    SE2 nodes are ``(x, y, theta)``; SE3 nodes are ``(x, y, z, qw, qx, qy,
    qz)`` (w-first, converted from g2o's x-y-z-w order).  Node ids must be
    dense from 0 (standard in the published benchmarks); edges referencing
    unknown ids raise.
    """
    nodes: Dict[int, np.ndarray] = {}
    edges = []
    weights = []
    shapes = []
    group = None

    def _set_group(g):
        nonlocal group
        if group is None:
            group = g
        elif group != g:
            raise ValueError(f"mixed SE2/SE3 records in {path}")

    with open(path) as f:
        for ln, line in enumerate(f, 1):
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            tag = tok[0].upper()
            if tag == "VERTEX_SE2":
                _set_group("SE2")
                i = int(tok[1])
                nodes[i] = np.asarray(
                    [float(tok[2]), float(tok[3]), float(tok[4])],
                    np.float32)
            elif tag in ("VERTEX_SE3:QUAT", "VERTEX_SE3"):
                _set_group("SE3")
                i = int(tok[1])
                x, y, z, qx, qy, qz, qw = (float(v) for v in tok[2:9])
                nodes[i] = np.concatenate(
                    [np.asarray([x, y, z], np.float32),
                     _quat_wxyz_from_xyzw(qx, qy, qz, qw)])
            elif tag == "EDGE_SE2":
                _set_group("SE2")
                a, b = int(tok[1]), int(tok[2])
                rel = np.asarray([float(tok[3]), float(tok[4]),
                                  float(tok[5])], np.float32)
                info = np.asarray([float(v) for v in tok[6:12]], np.float64)
                edges.append({"from": a, "to": b, "rel_pose": rel})
                weights.append(_info_scalar(info, 3))
                if with_edge_info:
                    shapes.append(_info_shape_sqrt(info, 3))
            elif tag in ("EDGE_SE3:QUAT", "EDGE_SE3"):
                _set_group("SE3")
                a, b = int(tok[1]), int(tok[2])
                x, y, z, qx, qy, qz, qw = (float(v) for v in tok[3:10])
                rel = np.concatenate(
                    [np.asarray([x, y, z], np.float32),
                     _quat_wxyz_from_xyzw(qx, qy, qz, qw)])
                info = np.asarray([float(v) for v in tok[10:31]], np.float64)
                edges.append({"from": a, "to": b, "rel_pose": rel})
                weights.append(_info_scalar(info, 6))
                if with_edge_info:
                    shapes.append(_info_shape_sqrt(info, 6))
            # Unknown tags (landmark vertices etc.) are skipped: this
            # importer targets pure pose graphs.
    if group is None:
        raise ValueError(f"no g2o pose-graph records found in {path}")
    K = max(nodes) + 1
    pose_dim = 3 if group == "SE2" else 7
    G = np.zeros((K, pose_dim), np.float32)
    if group == "SE3":
        G[:, 3] = 1.0   # identity quaternion for any gap ids
    for i, p in nodes.items():
        G[i] = p
    for e in edges:
        if e["from"] not in nodes or e["to"] not in nodes:
            raise ValueError(
                f"edge ({e['from']},{e['to']}) references missing vertex")
    # Normalize weights so the robust-kernel scale (tuned around weight~1
    # per edge) transfers across datasets with arbitrary info magnitudes.
    w = np.asarray(weights, np.float32)
    w = w / max(float(np.median(w)), 1e-12)
    out = {"group": group, "nodes": G, "edges": edges,
           "edge_weights": w, "reachable": sorted(nodes)}
    if with_edge_info:
        out["edge_info_sqrt"] = np.stack(shapes).astype(np.float32)
    return out
