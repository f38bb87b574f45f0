"""Scene rendering — the port of :mod:`srba_tpu.io.render` (the viewer end
of the reference's OpenGL visualization, ``build_opengl_representation``
consumed by ``mrpt-gui`` 3D windows).

Host-side and offline: the renderer draws the backend-neutral scene dict of
:func:`srba_tpu_torch.io.export.build_opengl_representation` to PNG with
matplotlib — a top-down (XY) view for SE(2) maps, a 3D axes view for SE(3) —
showing keyframes, kf2kf edges, landmarks, the spanning tree of a chosen
root, and optionally the ground-truth trajectory.  Wired to the CLI as
``--render out.png``.  matplotlib is imported at the call, not with the
module; where it is missing the call raises an ``ImportError`` that names
it (the rest of the port does not need it).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def render_scene_png(scene: Dict, path: str, is3d: Optional[bool] = None,
                     gt_positions: Optional[np.ndarray] = None,
                     title: Optional[str] = None, dpi: int = 130) -> None:
    """Draw a scene dict to ``path`` (PNG).  ``is3d`` defaults to whether
    the keyframe z coordinates vary; ``gt_positions`` ([K, 2|3]) overlays
    the ground-truth trajectory."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError(
            "render_scene_png (the CLI's --render) needs matplotlib, which "
            "is not installed") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    kf = np.asarray(scene["kf_positions"], np.float64)
    lm = np.asarray(scene["landmarks"], np.float64)
    edges = scene.get("k2k_edges", [])
    st_edges = scene.get("spanning_tree_edges", [])
    if is3d is None:
        is3d = kf.shape[0] > 1 and float(np.ptp(kf[:, 2])) > 1e-6

    fig = plt.figure(figsize=(8, 8))
    if is3d:
        ax = fig.add_subplot(111, projection="3d")
    else:
        ax = fig.add_subplot(111)
        ax.set_aspect("equal")

    def _pts(a):
        return (a[:, 0], a[:, 1], a[:, 2]) if is3d else (a[:, 0], a[:, 1])

    if lm.shape[0]:
        ax.scatter(*_pts(lm), s=3, c="#b9b9b9", marker=".",
                   label=f"landmarks ({lm.shape[0]})", zorder=1)

    # kf2kf edges (thin), spanning tree (highlight).
    def _draw_edges(pairs, color, lw, z, label=None):
        first = True
        for a, b in pairs:
            if a >= kf.shape[0] or b >= kf.shape[0]:
                continue
            seg = kf[[a, b]]
            ax.plot(*_pts(seg), color=color, linewidth=lw, zorder=z,
                    label=(label if first else None))
            first = False

    _draw_edges(edges, "#7aa6d9", 0.7, 2,
                label=f"k2k edges ({len(edges)})")
    if st_edges:
        _draw_edges(st_edges, "#d98f3c", 1.4, 3, label="spanning tree")

    if kf.shape[0]:
        ax.plot(*_pts(kf), color="#c23b3b", linewidth=1.0, zorder=4)
        ax.scatter(*_pts(kf), s=6, c="#c23b3b", marker="o",
                   label=f"keyframes ({kf.shape[0]})", zorder=5)
    if gt_positions is not None:
        gt = np.asarray(gt_positions, np.float64)
        if gt.shape[1] == 2 and is3d:
            gt = np.concatenate([gt, np.zeros((len(gt), 1))], axis=1)
        ax.plot(*_pts(gt[:, :3] if is3d else gt[:, :2]), color="#3bb273",
                linewidth=1.0, linestyle="--", zorder=4,
                label="ground truth")

    ax.legend(loc="upper right", fontsize=8)
    if title:
        ax.set_title(title, fontsize=10)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    if is3d:
        ax.set_zlabel("z [m]")
    fig.tight_layout()
    fig.savefig(path, dpi=dpi)
    plt.close(fig)


def render_engine_png(engine, path: str, span_tree_root: Optional[int] = None,
                      gt_positions: Optional[np.ndarray] = None,
                      title: Optional[str] = None) -> None:
    """Convenience: build the scene from a live engine and render it."""
    from srba_tpu_torch.io.export import build_opengl_representation
    scene = build_opengl_representation(engine,
                                        span_tree_root=span_tree_root)
    render_scene_png(scene, path, is3d=engine.group.name == "SE3",
                     gt_positions=gt_positions, title=title)
