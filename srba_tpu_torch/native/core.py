"""NativeCore — Python face of the C++ host graph service; the port of
:mod:`srba_tpu.native.core`.

Mirrors every symbolic mutation (keyframes, edges, landmarks, observations)
into the C++ core and serves the per-keyframe window build from it.  The
engine drives this alongside its Python ``KeyframeGraph`` (which keeps
serving the public traversal APIs: ``bfs_visitor``, exporters, ECPs); the
native core builds the device-master windows.  Interface contract: the
window, padding included, is bit-identical to
``srba_tpu_torch.solver.window.build_window`` given the same ``min_shape``,
and to the JAX package's ``NativeCore`` given its ratchet's caps
(tests/test_torch_native_core.py).  The ratchet itself (padded shapes per
optimize depth that never shrink) is the engine's.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from srba_tpu_torch.native import NO_NATIVE_ENV, get_lib
from srba_tpu_torch.solver.window import (WindowArrays, WindowPlan,
                                          bucket_shape)

# The C++ core sizes its path-step buffers for at most this tree depth.
MAX_TREE_DEPTH = 64


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeCore:
    """One instance per engine.  All methods are O(bounded neighborhood)."""

    def __init__(self, max_tree_depth: int):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable (no g++, or "
                               f"{NO_NATIVE_ENV} set)")
        if max_tree_depth > MAX_TREE_DEPTH:
            raise ValueError(
                f"native window builder supports max_tree_depth <= "
                f"{MAX_TREE_DEPTH} (fixed path-step buffers), got "
                f"{max_tree_depth}")
        self._lib = lib
        self._h = lib.srba_core_new(int(max_tree_depth))
        self._depth = int(max_tree_depth)
        self._num_kfs = 0

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.srba_core_free(self._h)
                self._h = None
        except Exception:
            pass

    # -- mirrored mutations --------------------------------------------------

    def add_keyframe(self) -> int:
        self._num_kfs += 1
        return self._lib.srba_core_add_kf(self._h)

    def add_edge(self, a: int, b: int) -> int:
        e = self._lib.srba_core_add_edge(self._h, a, b)
        if e < 0:
            raise RuntimeError(f"native core: bad edge ({a},{b})")
        return e

    def add_landmark(self, base_kf: int, fixed: bool) -> int:
        return self._lib.srba_core_add_lm(self._h, base_kf, int(fixed))

    def add_observation(self, kf: int, lm: int) -> int:
        o = self._lib.srba_core_add_obs(self._h, kf, lm)
        if o < 0:
            raise RuntimeError(f"native core: bad observation ({kf},{lm})")
        return o

    # -- queries --------------------------------------------------------------

    def bfs_tree(self, root: int, max_depth: Optional[int] = None):
        """Bounded BFS tree from ``root``: ``(dist, parent)`` as
        ``KeyframeGraph.bfs_tree`` returns them (``parent[n] = (parent_kf,
        edge_id)`` for every reached ``n != root``), in the same visit
        order."""
        depth = self._depth if max_depth is None else int(max_depth)
        cap = max(1, self._num_kfs)
        node, dist, par, peid = (np.empty(cap, np.int32) for _ in range(4))
        n = self._lib.srba_core_bfs_tree(self._h, root, depth, cap,
                                         _ptr(node), _ptr(dist), _ptr(par),
                                         _ptr(peid))
        if n < 0:
            raise RuntimeError(
                f"native core: bfs_tree reached {-n} nodes, capacity {cap}")
        dist_out = {int(node[i]): int(dist[i]) for i in range(n)}
        parent = {int(node[i]): (int(par[i]), int(peid[i]))
                  for i in range(n) if int(node[i]) != root}
        return dist_out, parent

    def path(self, src: int, dst: int,
             max_depth: Optional[int] = None):
        depth = self._depth if max_depth is None else int(max_depth)
        eid = np.empty(depth, np.int32)
        sign = np.empty(depth, np.int32)
        n = self._lib.srba_core_path(self._h, src, dst, depth, depth,
                                     _ptr(eid), _ptr(sign))
        if n < 0:
            return None
        return [(int(eid[i]), int(sign[i])) for i in range(n)]

    def build_window(self, state, root: int, opt_depth: int,
                     tree_depth: int,
                     obs_per_lm_cap: Optional[int] = None,
                     min_shape: Optional[tuple] = None
                     ) -> Optional[Tuple]:
        """Native replacement for ``solver.window.build_window(...,
        gather_floats=False, min_shape=min_shape)``: returns
        ``(WindowArrays, WindowPlan)`` with obs_z gathered from the host
        state table by the emitted obs ids, padded to ``bucket_shape`` (at
        least ``min_shape``).  ``obs_per_lm_cap`` bounds in-window
        observations per landmark (newest kept) — the window-size guard for
        dense re-visit regimes."""
        cap_per_lm = 0 if obs_per_lm_cap is None else int(obs_per_lm_cap)
        lib, h = self._lib, self._h
        counts = np.zeros(3, np.int32)
        # The engine passes the last shape at this depth: windows grow
        # slowly, so the first attempt almost always fits (one native call
        # per KF).
        shape = bucket_shape((0, 0, 0), min_shape)
        for _ in range(16):  # grows geometrically until it fits
            E, L, N = shape
            edge_gids = np.zeros(E, np.int32)
            edge_opt = np.zeros(E, np.int32)
            lm_gids = np.zeros(L, np.int32)
            lm_opt = np.zeros(L, np.int32)
            obs_ids = np.zeros(N, np.int32)
            obs_lm_local = np.zeros(N, np.int32)
            obs_valid = np.zeros(N, np.int32)
            path_edge = np.zeros((N, tree_depth), np.int32)
            path_sign = np.zeros((N, tree_depth), np.int32)
            rc = lib.srba_core_build_window(
                h, root, opt_depth, tree_depth, E, L, N, cap_per_lm,
                _ptr(counts),
                _ptr(edge_gids), _ptr(edge_opt), _ptr(lm_gids), _ptr(lm_opt),
                _ptr(obs_ids), _ptr(obs_lm_local), _ptr(obs_valid),
                _ptr(path_edge), _ptr(path_sign))
            if rc == -1:
                return None
            if rc == 0:
                break
            # Too small: re-bucket to the required counts and retry, never
            # below the shape tried.
            shape = bucket_shape(counts, shape)
        else:
            raise RuntimeError("native window build failed to converge")

        E_real, L_real, N_real = (int(counts[0]), int(counts[1]),
                                  int(counts[2]))
        obs_ids = obs_ids[:N]
        obs_z = state.obs_z[obs_ids]  # numpy fancy gather (pads = first row)
        arrays = WindowArrays(
            edge_pose=None, edge_opt=edge_opt.astype(np.float32),
            lm_state=None, lm_opt=lm_opt.astype(np.float32),
            obs_z=obs_z, obs_lm=obs_lm_local, path_edge=path_edge,
            path_sign=path_sign.astype(np.float32),
            obs_valid=obs_valid.astype(np.float32),
            edge_gids=edge_gids, lm_gids=lm_gids)
        plan = WindowPlan(
            edge_ids=edge_gids[:E_real].copy(),
            edge_opt=edge_opt[:E_real].astype(bool),
            lm_ids=lm_gids[:L_real].copy(),
            lm_opt=lm_opt[:L_real].astype(bool),
            num_obs=N_real,
            shape_key=(E, L, N),
        )
        return arrays, plan
