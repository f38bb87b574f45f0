"""Local-area window selection and padded device-batch construction
(host numpy; a copy of :mod:`srba_tpu.solver.window`, kept framework-free so
the port never imports JAX).

Reference analog (public MRPT/srba layout; SURVEY.md §4.2):
``impl/optimize_local_area.h`` (BFS window selection) and the symbolic
optimization structure built at the top of ``impl/optimize_edges.h`` (which
spanning-tree path edges, with signs, affect each observation — the Jacobian
sparsity pattern).

Shape discipline: windows are padded to bucketed sizes in (#edges,
#landmarks, #observations) so a whole run touches only O(log N) distinct
shapes; the spanning-tree paths become fixed-width ``[N, D]`` gather-index
tensors so the device solver never talks back to the host graph.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Set

import numpy as np

from srba_tpu_torch.engine.state import ProblemState
from srba_tpu_torch.graph.spantree import KeyframeGraph


# Bucket floors, unchanged from the JAX package (whose jit compiles one
# program per distinct (E, L, N)): the port keeps the same ladder so both
# packages solve identically padded windows and the parity tests compare
# like with like.  Whether the ladder is right for the GPU is an open
# question (PERF.md).
E_MIN, L_MIN, N_MIN = 8, 64, 64


def _bucket(n: int, minimum: int) -> int:
    """Padded capacity ladder: powers of two below 64, then x4 steps
    (64, 256, 1024, ...).  See the floor rationale above."""
    cap = minimum
    while cap < n:
        cap *= 2 if cap < 64 else 4
    return cap


def bucket_shape(counts, min_shape: Optional[tuple] = None) -> tuple:
    """Padded (E, L, N) for real (#edges, #landmarks, #observations): the
    ladder's buckets, raised per dimension to ``min_shape`` where given
    (the engine's per-depth ratchet)."""
    shape = (_bucket(int(counts[0]), E_MIN), _bucket(int(counts[1]), L_MIN),
             _bucket(int(counts[2]), N_MIN))
    if min_shape is None:
        return shape
    return tuple(max(s, int(m)) for s, m in zip(shape, min_shape))


@dataclass
class WindowPlan:
    """Host bookkeeping for one window: which global ids occupy which local
    slots, for writing optimized values back into the master SoA state."""

    edge_ids: np.ndarray        # [E_real] global edge id per local slot
    edge_opt: np.ndarray        # [E_real] bool — unknown in this window
    lm_ids: np.ndarray          # [L_real]
    lm_opt: np.ndarray          # [L_real] bool
    num_obs: int
    shape_key: tuple            # (E_pad, L_pad, N_pad) bucket signature


@dataclass
class WindowArrays:
    """Raw padded numpy arrays for a window (converted to a device
    ``WindowBatch`` by the engine, which attaches whitener/calib).

    ``edge_gids``/``lm_gids`` are the padded GLOBAL id arrays used by the
    device-master path (gather/scatter indices into the master arrays);
    padding slots carry id 0 with ``*_opt == 0`` so masked scatter-adds
    contribute exact zeros.  ``edge_pose``/``lm_state`` are host-gathered
    values — only filled for the host-window path (``gather_floats=True``);
    the device-master path gathers from the device masters instead (the
    host mirror may be stale there)."""

    edge_pose: np.ndarray
    edge_opt: np.ndarray
    lm_state: np.ndarray
    lm_opt: np.ndarray
    obs_z: np.ndarray
    obs_lm: np.ndarray
    path_edge: np.ndarray
    path_sign: np.ndarray
    obs_valid: np.ndarray
    edge_gids: np.ndarray = None
    lm_gids: np.ndarray = None
    # Per-edge measurement priors (only filled when gather_floats=True; the
    # device-master path gathers them from its device prior table instead).
    edge_prior: np.ndarray = None
    edge_prior_w: np.ndarray = None


def build_window(
    state: ProblemState,
    graph: KeyframeGraph,
    root_kf: int,
    max_optimize_depth: int,
    max_tree_depth: int,
    extra_obs_per_lm_cap: Optional[int] = None,
    gather_floats: bool = True,
    min_shape: Optional[tuple] = None,
) -> Optional[tuple]:
    """Select the local optimization window around ``root_kf`` and build the
    padded arrays, padded to :func:`bucket_shape` (at least ``min_shape``).
    Returns ``(WindowArrays, WindowPlan)`` or ``None`` when there is nothing
    to optimize (no in-window edges or no usable observations)."""
    win_kfs: Set[int] = set(graph.window(root_kf, max_optimize_depth))

    # Edges to optimize: both endpoints inside the window.
    k2k_from, k2k_to = state.edges_view()
    opt_edge_ids = [
        e for e in range(state.num_edges)
        if int(k2k_from[e]) in win_kfs and int(k2k_to[e]) in win_kfs
    ]
    if not opt_edge_ids:
        return None

    # Landmarks observed from the window; observations restricted to
    # in-window observers (the reference's window semantics).
    lm_ids_set: Set[int] = set()
    for kf in win_kfs:
        for o in state.kf_obs[kf]:
            lm_ids_set.add(int(state.obs_lm[o]))
    cand_obs: List[int] = []
    for l in sorted(lm_ids_set):
        obs_of_l = [o for o in state.lm_obs[l]
                    if int(state.obs_kf[o]) in win_kfs]
        if extra_obs_per_lm_cap is not None:
            obs_of_l = obs_of_l[-extra_obs_per_lm_cap:]
        cand_obs.extend(obs_of_l)

    # Resolve spanning-tree paths; collect involved (possibly fixed) edges.
    edge_local = {e: i for i, e in enumerate(opt_edge_ids)}
    involved: List[int] = list(opt_edge_ids)
    rows = []  # (obs_id, [(local_edge, sign), ...])
    for o in cand_obs:
        src = int(state.obs_kf[o])
        dst = int(state.lm_base[state.obs_lm[o]])
        path = graph.path(src, dst, max_tree_depth)
        if path is None or len(path) > max_tree_depth:
            continue  # base unreachable within tree depth: obs unusable here
        steps = []
        for eid, sign in path:
            if eid not in edge_local:
                edge_local[eid] = len(involved)
                involved.append(eid)
            steps.append((edge_local[eid], sign))
        rows.append((o, steps))
    if not rows:
        return None

    lm_ids_sorted = sorted({int(state.obs_lm[o]) for o, _ in rows})
    lm_local = {l: i for i, l in enumerate(lm_ids_sorted)}

    E_real, L_real, N_real = len(involved), len(lm_ids_sorted), len(rows)
    E, L, N = bucket_shape((E_real, L_real, N_real), min_shape)
    D = max_tree_depth
    pose_dim, lm_dim, z_dim = state.pose_dim, state.lm_dim, state.z_dim

    edge_pose = np.zeros((E, pose_dim), np.float32)
    edge_opt = np.zeros(E, np.float32)
    lm_state = np.zeros((L, lm_dim), np.float32)
    lm_opt = np.zeros(L, np.float32)
    obs_z = np.zeros((N, z_dim), np.float32)
    obs_lm = np.zeros(N, np.int32)
    path_edge = np.zeros((N, D), np.int32)
    path_sign = np.zeros((N, D), np.float32)
    obs_valid = np.zeros(N, np.float32)

    inv_ids = np.asarray(involved, np.int32)
    opt_set = set(opt_edge_ids)
    edge_opt[:E_real] = [1.0 if e in opt_set else 0.0 for e in involved]
    lm_arr_ids = np.asarray(lm_ids_sorted, np.int32)
    lm_opt[:L_real] = (~state.lm_fixed[lm_arr_ids]).astype(np.float32)

    # Padded GLOBAL ids for the device-master gather/scatter path (pad = 0,
    # a valid allocated row, masked by *_opt == 0).
    edge_gids = np.zeros(E, np.int32)
    edge_gids[:E_real] = inv_ids
    lm_gids = np.zeros(L, np.int32)
    lm_gids[:L_real] = lm_arr_ids

    edge_prior = None
    edge_prior_w = None
    if gather_floats:
        edge_pose[:E_real] = state.k2k_pose[inv_ids]
        # Pad slots hold identity-ish poses; for quaternion groups a zero
        # pose is degenerate, so copy slot 0's pose into padding (masked
        # anyway, but keeps compose/inverse well-conditioned).
        if E_real < E:
            edge_pose[E_real:] = edge_pose[0]
        lm_state[:L_real] = state.lm_state[lm_arr_ids]
        if L_real < L:
            # Valid-valued padding: all-zero rows are degenerate for pose
            # landmarks (zero quaternion -> NaN through normalize/compose).
            lm_state[L_real:] = lm_state[0]
        edge_prior = np.zeros((E, pose_dim), np.float32)
        edge_prior_w = np.zeros(E, np.float32)
        edge_prior[:E_real] = state.k2k_prior[inv_ids]
        if E_real < E:
            edge_prior[E_real:] = edge_prior[0]
        edge_prior_w[:E_real] = state.k2k_prior_w[inv_ids]

    for i, (o, steps) in enumerate(rows):
        obs_z[i] = state.obs_z[o]
        obs_lm[i] = lm_local[int(state.obs_lm[o])]
        for k, (le, sign) in enumerate(steps):
            path_edge[i, k] = le
            path_sign[i, k] = sign
        obs_valid[i] = 1.0
    if N_real < N:
        obs_z[N_real:] = obs_z[0]  # same degeneracy guard as above

    arrays = WindowArrays(edge_pose, edge_opt, lm_state, lm_opt, obs_z,
                          obs_lm, path_edge, path_sign, obs_valid,
                          edge_gids=edge_gids, lm_gids=lm_gids,
                          edge_prior=edge_prior, edge_prior_w=edge_prior_w)
    plan = WindowPlan(
        edge_ids=inv_ids,
        edge_opt=edge_opt[:E_real].astype(bool),
        lm_ids=lm_arr_ids,
        lm_opt=lm_opt[:L_real].astype(bool),
        num_obs=N_real,
        shape_key=(E, L, N),
    )
    return arrays, plan


def write_back(state: ProblemState, plan: WindowPlan,
               edge_pose: np.ndarray, lm_state: np.ndarray) -> None:
    """Write optimized window values back into the master SoA state (only
    slots that were actually unknowns)."""
    for i, e in enumerate(plan.edge_ids):
        if plan.edge_opt[i]:
            state.k2k_pose[e] = edge_pose[i]
    for i, l in enumerate(plan.lm_ids):
        if plan.lm_opt[i]:
            state.lm_state[l] = lm_state[i]
