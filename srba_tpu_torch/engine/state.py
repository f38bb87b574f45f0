"""Problem state (host numpy; a copy of :mod:`srba_tpu.engine.state`, kept
framework-free so the port never imports JAX): the redesign of the reference's
``TRBA_Problem_state`` (public MRPT/srba layout: ``include/srba/srba_types.h``;
SURVEY.md Appendix A).

Where the reference keeps pointer-linked STL structures (deques of edge
records, per-KF maps of spanning-tree entries), this keeps **struct-of-arrays
numpy tables with capacity doubling** on the host.  Everything is indexed by
dense int32 ids; growth is append-only (SRBA never deletes), so views handed
to the solver stay valid.  On the device-master path the numeric columns
(edge poses, landmark states) are a lazily refreshed mirror of the device
masters (:mod:`srba_tpu_torch.engine.device_master`); windows are bounded
(the whole point of SRBA), so the per-keyframe upload does not grow with
the map.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


def _grow(arr: np.ndarray, n_needed: int) -> np.ndarray:
    cap = arr.shape[0]
    if n_needed <= cap:
        return arr
    new_cap = max(8, cap)
    while new_cap < n_needed:
        new_cap *= 2
    out = np.zeros((new_cap,) + arr.shape[1:], dtype=arr.dtype)
    out[:cap] = arr
    return out


@dataclass
class ProblemState:
    """SoA tables for keyframes, kf2kf edges, landmarks and observations.

    ``k2k_pose[e]`` stores ``T_from<-to`` for edge ``e = (from, to)`` — the
    pose unknowns (reference: ``k2k_edge_t::inv_pose``).  ``lm_state[l]`` is
    the landmark state in its base KF's frame (reference:
    ``TRelativeLandmarkPos``).
    """

    pose_dim: int
    lm_dim: int
    z_dim: int

    num_kfs: int = 0
    num_edges: int = 0
    num_lms: int = 0
    num_obs: int = 0

    # kf2kf edges
    k2k_from: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    k2k_to: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    k2k_pose: Optional[np.ndarray] = None
    # Creation-time edge measurement (odometry / closure bootstrap) kept as
    # a permanent weak prior factor in every window solve (weight 0 = none).
    # Rationale: local windows can be visually DEGENERATE (at map revisits
    # most visible landmarks are based beyond the tree depth, leaving a few
    # long-range ones), and a reprojection-only LM slides meters along the
    # null space while residuals stay sub-pixel.  The odometry measurement
    # is exactly the information that fills that null space.
    k2k_prior: Optional[np.ndarray] = None
    k2k_prior_w: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.float32))
    # Measured creation-time pose sigma of the edge (closure-bootstrap fit
    # covariance); 0 = unmeasured (odometry / dead-reckoned seeds).  Host
    # only — consumed by the global graph-SLAM export's per-edge
    # information weights (io/export.py), never shipped to device.
    k2k_sigma: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.float32))
    # Full creation-time fit information (the closure bootstrap's JtJ,
    # [dof, dof] per edge; all-zero = unmeasured).  Host only — the global
    # graph-SLAM export eig-normalizes it into per-edge anisotropic
    # information shapes (io/export.py).  No ported path measures a closure
    # fit yet, so both stay 0 until the closure bootstrap is ported.
    k2k_info: Optional[np.ndarray] = None

    # landmarks
    lm_base: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    lm_state: Optional[np.ndarray] = None
    lm_fixed: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))

    # observations (k2f edges)
    obs_kf: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    obs_lm: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    obs_z: Optional[np.ndarray] = None

    # reverse indices (python lists of lists; appended in step with tables)
    lm_obs: List[List[int]] = field(default_factory=list)
    kf_obs: List[List[int]] = field(default_factory=list)

    @property
    def pose_dof(self) -> int:
        """Tangent dof of the pose group (SE2: dim 3/dof 3; SE3 quaternion:
        dim 7/dof 6)."""
        return 3 if self.pose_dim == 3 else 6

    def __post_init__(self):
        if self.k2k_pose is None:
            self.k2k_pose = np.zeros((0, self.pose_dim), np.float32)
        if self.k2k_prior is None:
            self.k2k_prior = np.zeros((0, self.pose_dim), np.float32)
        if self.k2k_info is None:
            self.k2k_info = np.zeros((0, self.pose_dof, self.pose_dof),
                                     np.float32)
        if self.lm_state is None:
            self.lm_state = np.zeros((0, self.lm_dim), np.float32)
        if self.obs_z is None:
            self.obs_z = np.zeros((0, self.z_dim), np.float32)

    # -- mutation ----------------------------------------------------------

    def add_keyframe(self) -> int:
        kf = self.num_kfs
        self.num_kfs += 1
        self.kf_obs.append([])
        return kf

    def add_edge(self, from_kf: int, to_kf: int, pose: np.ndarray,
                 prior_w: float = 0.0, sigma: float = 0.0,
                 info: Optional[np.ndarray] = None) -> int:
        e = self.num_edges
        self.k2k_from = _grow(self.k2k_from, e + 1)
        self.k2k_to = _grow(self.k2k_to, e + 1)
        self.k2k_pose = _grow(self.k2k_pose, e + 1)
        self.k2k_prior = _grow(self.k2k_prior, e + 1)
        self.k2k_prior_w = _grow(self.k2k_prior_w, e + 1)
        self.k2k_sigma = _grow(self.k2k_sigma, e + 1)
        self.k2k_info = _grow(self.k2k_info, e + 1)
        self.k2k_from[e] = from_kf
        self.k2k_to[e] = to_kf
        self.k2k_pose[e] = pose
        self.k2k_prior[e] = pose      # creation value IS the measurement
        self.k2k_prior_w[e] = prior_w
        self.k2k_sigma[e] = sigma
        self.k2k_info[e] = 0.0 if info is None else info
        self.num_edges += 1
        return e

    def add_landmark(self, base_kf: int, state: np.ndarray,
                     fixed: bool = False) -> int:
        l = self.num_lms
        self.lm_base = _grow(self.lm_base, l + 1)
        self.lm_state = _grow(self.lm_state, l + 1)
        self.lm_fixed = _grow(self.lm_fixed, l + 1)
        self.lm_base[l] = base_kf
        self.lm_state[l] = state
        self.lm_fixed[l] = fixed
        self.lm_obs.append([])
        self.num_lms += 1
        return l

    def add_observation(self, kf: int, lm: int, z: np.ndarray) -> int:
        o = self.num_obs
        self.obs_kf = _grow(self.obs_kf, o + 1)
        self.obs_lm = _grow(self.obs_lm, o + 1)
        self.obs_z = _grow(self.obs_z, o + 1)
        self.obs_kf[o] = kf
        self.obs_lm[o] = lm
        self.obs_z[o] = z
        self.lm_obs[lm].append(o)
        self.kf_obs[kf].append(o)
        self.num_obs += 1
        return o

    # -- views (trimmed to live rows) --------------------------------------

    @property
    def edge_poses(self) -> np.ndarray:
        return self.k2k_pose[: self.num_edges]

    @property
    def landmark_states(self) -> np.ndarray:
        return self.lm_state[: self.num_lms]

    def edges_view(self):
        return (self.k2k_from[: self.num_edges],
                self.k2k_to[: self.num_edges])
