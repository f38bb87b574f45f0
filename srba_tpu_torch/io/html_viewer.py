"""Self-contained interactive 3D map viewer — the port of
:mod:`srba_tpu.io.html_viewer` (the headless analog of the reference's live
OpenGL window, ``srba-slam --gui`` + ``mrpt-gui``).

The engine's scene dict
(:func:`srba_tpu_torch.io.export.build_opengl_representation`) is baked into
ONE standalone HTML file: embedded JSON and a dependency-free canvas
renderer (vanilla JS, no CDN) with orbit / zoom / pan mouse controls,
keyframe trajectory, landmark cloud, kf2kf edges and an optional
spanning-tree highlight.  Open the file in any browser.  The template is
the JAX package's, so the same scene and title give a byte-identical file.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>%%TITLE%%</title>
<style>
 html,body{margin:0;height:100%;background:#10141a;color:#cfd8e3;
           font:12px system-ui,sans-serif;overflow:hidden}
 #hud{position:fixed;top:8px;left:10px;opacity:.85;pointer-events:none}
 canvas{display:block}
</style></head><body>
<div id="hud">%%TITLE%% &mdash; drag: orbit &middot; wheel: zoom &middot;
shift-drag: pan &middot; <span id="stats"></span></div>
<canvas id="c"></canvas>
<script>
const SCENE = %%SCENE%%;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let yaw = -0.7, pitch = 0.45, dist = 1, panX = 0, panY = 0;
const kf = SCENE.kf_positions, lm = SCENE.landmarks,
      edges = SCENE.k2k_edges, st = SCENE.spanning_tree_edges || [],
      gt = SCENE.gt_positions || null;
// Fit: center + scale from the keyframe cloud (fall back to landmarks).
const pts = kf.length ? kf : lm;
let c0 = [0, 0, 0], r0 = 1;
if (pts.length) {
  for (const p of pts) { c0[0]+=p[0]; c0[1]+=p[1]; c0[2]+=p[2]; }
  c0 = c0.map(v => v / pts.length);
  for (const p of pts)
    r0 = Math.max(r0, Math.hypot(p[0]-c0[0], p[1]-c0[1], p[2]-c0[2]));
}
function project(p) {
  const x = p[0]-c0[0], y = p[1]-c0[1], z = p[2]-c0[2];
  const cy = Math.cos(yaw), sy = Math.sin(yaw),
        cp = Math.cos(pitch), sp = Math.sin(pitch);
  const x1 = cy*x + sy*y, y1 = -sy*x + cy*y;        // yaw about +z
  const y2 = cp*y1 - sp*z, z2 = sp*y1 + cp*z;       // pitch
  const s = Math.min(cv.width, cv.height) * 0.42 / (r0 * dist);
  return [cv.width/2 + panX + x1*s, cv.height/2 + panY - z2*s, y2];
}
function line(a, b, color, w) {
  const pa = project(a), pb = project(b);
  ctx.strokeStyle = color; ctx.lineWidth = w;
  ctx.beginPath(); ctx.moveTo(pa[0], pa[1]); ctx.lineTo(pb[0], pb[1]);
  ctx.stroke();
}
function draw() {
  cv.width = innerWidth; cv.height = innerHeight;
  ctx.fillStyle = '#10141a'; ctx.fillRect(0, 0, cv.width, cv.height);
  ctx.fillStyle = '#d7dde6';
  for (const p of lm) {
    const q = project(p); ctx.fillRect(q[0]-1, q[1]-1, 2, 2);
  }
  for (const e of edges) {
    if (e[0] < kf.length && e[1] < kf.length)
      line(kf[e[0]], kf[e[1]], 'rgba(90,140,255,0.45)', 1);
  }
  for (const e of st) {
    if (e[0] < kf.length && e[1] < kf.length)
      line(kf[e[0]], kf[e[1]], 'rgba(80,230,140,0.9)', 1.6);
  }
  for (let i = 1; i < kf.length; i++)
    line(kf[i-1], kf[i], '#ff6a5e', 1.8);
  if (gt) {
    for (let i = 1; i < gt.length; i++)
      line(gt[i-1], gt[i], 'rgba(255,214,80,0.7)', 1.2);
  }
  document.getElementById('stats').textContent =
    kf.length + ' keyframes, ' + lm.length + ' landmarks, ' +
    edges.length + ' edges' + (st.length ? ', spanning tree shown' : '');
}
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY, e.shiftKey];
window.onmouseup = () => drag = null;
window.onmousemove = e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) { panX += dx; panY += dy; }
  else { yaw += dx * 0.008;
         pitch = Math.max(-1.55, Math.min(1.55, pitch + dy * 0.008)); }
  drag = [e.clientX, e.clientY, drag[2]]; draw();
};
cv.onwheel = e => { dist *= Math.exp(e.deltaY * 0.001); draw();
                    e.preventDefault(); };
window.onresize = draw;
draw();
</script></body></html>
"""


def save_scene_html(scene: Dict, path: str, title: str = "srba_tpu map",
                    gt_poses: Optional[np.ndarray] = None) -> None:
    """Write the scene dict as one standalone interactive HTML file.

    ``gt_poses`` [K, >=2]: optional ground-truth trajectory overlay
    (2D rows are lifted to z=0)."""
    def lift(arr):
        a = np.asarray(arr, np.float64)
        if a.size == 0:
            return np.zeros((0, 3))
        if a.shape[1] == 2:
            a = np.concatenate([a, np.zeros((len(a), 1))], axis=1)
        return a[:, :3]

    payload = {
        "kf_positions": np.asarray(scene["kf_positions"],
                                   np.float64).round(5).tolist(),
        "landmarks": np.asarray(scene["landmarks"],
                                np.float64).round(5).tolist(),
        "k2k_edges": [[int(a), int(b)] for a, b in scene["k2k_edges"]],
        "spanning_tree_edges": [[int(a), int(b)]
                                for a, b in scene["spanning_tree_edges"]],
    }
    if gt_poses is not None:
        payload["gt_positions"] = lift(gt_poses).round(5).tolist()
    html = (_TEMPLATE
            .replace("%%TITLE%%", title)
            .replace("%%SCENE%%", json.dumps(payload)))
    with open(path, "w") as f:
        f.write(html)
