"""Plain reference of the edges a fixed-grid local-areas map is built with
from a drive's odometry: which keyframe each new keyframe links to, the
measurement prior each edge carries (its creation value) and the prior's
weight.

Keyframes are grouped into areas of ``submap_size``; an area's first
keyframe is its centre.  Keyframe k > 0 links to its own area's centre, a
new centre to the previous area's centre; the edge's pose is ``T_k<-t``.
Its creation value is the odometry ``T_k<-(k-1)`` where t is k - 1, with
weight ``1 / sigma^2``; else the pose that the dead-reckoned trajectory
(the odometry composed from keyframe 0) gives, with weight
``1 / (sigma^2 * |k - t|)``.  A drive with no revisits makes no loop
closures, so these are all its edges.  Poses are ``[t, q(w, x, y, z)]``;
the arithmetic is numpy in float64 and imports nothing else.
"""

from __future__ import annotations

import numpy as np


def _qmul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw])


def _rotate(q, v):
    qv = np.concatenate([[0.0], v])
    conj = q * np.array([1.0, -1.0, -1.0, -1.0])
    return _qmul(_qmul(q, qv), conj)[1:]


def compose(a, b):
    q = _qmul(a[3:], b[3:])
    return np.concatenate([a[:3] + _rotate(a[3:], b[:3]),
                           q / np.linalg.norm(q)])


def inverse(a):
    qi = a[3:] * np.array([1.0, -1.0, -1.0, -1.0])
    return np.concatenate([-_rotate(qi, a[:3]), qi])


def fixed_grid_edges(num_kfs: int, submap_size: int, odometry: np.ndarray,
                     prior_sigma: float):
    """``(edge_from [E], edge_to [E], prior [E, 7], prior_w [E])`` in the
    order the keyframes arrive: edge k - 1 is keyframe k's."""
    odo = np.asarray(odometry, np.float64)
    G = [np.array([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0])]
    ef, et, prior, w = [], [], [], []
    for k in range(1, num_kfs):
        G.append(compose(G[k - 1], inverse(odo[k - 1])))
        centre = (k // submap_size) * submap_size
        t = ((k - 1) // submap_size) * submap_size if k == centre else centre
        if t == k - 1:
            pose, weight = odo[k - 1], 1.0 / prior_sigma ** 2
        else:
            pose = compose(inverse(G[k]), G[t])
            weight = 1.0 / (prior_sigma ** 2 * abs(k - t))
        ef.append(k)
        et.append(t)
        prior.append(pose)
        w.append(weight)
    return (np.asarray(ef, np.int64), np.asarray(et, np.int64),
            np.asarray(prior, np.float64).reshape(-1, 7),
            np.asarray(w, np.float64))


def pose_gaps(a: np.ndarray, b: np.ndarray):
    """Per row of two ``[E, 7]`` pose tables: the translation gap (m) and
    the rotation angle between them (rad, sign of the quaternion free)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    dt = np.linalg.norm(a[:, :3] - b[:, :3], axis=-1)
    qa = a[:, 3:] / np.linalg.norm(a[:, 3:], axis=-1, keepdims=True)
    qb = b[:, 3:] / np.linalg.norm(b[:, 3:], axis=-1, keepdims=True)
    dot = np.clip(np.abs(np.sum(qa * qb, axis=-1)), 0.0, 1.0)
    return dt, 2.0 * np.arccos(dot)
