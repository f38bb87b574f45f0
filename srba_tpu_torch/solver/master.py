"""Device-resident master-state solver step — port of
:mod:`srba_tpu.solver.master`.

The kf2kf edge poses, their priors and the landmark states live in padded
**device master tensors** (the authoritative copy; the host keeps a lazily
refreshed mirror).  Per keyframe the host uploads ONE packed f32 buffer (new
rows, window observations, then the window's int32 structure bit-cast into
f32 slots — the JAX package's wire format, unchanged), and one step appends
the new rows, gathers the window from the masters, runs the LM+Schur loop
(:func:`srba_tpu_torch.solver.lm.make_solver_impl`) and scatters the
optimized values back as masked deltas.  Nothing is read back from the
device.

Where the JAX program donates the masters and returns updated copies, the
port updates them IN PLACE: the append is a slice copy and the scatter an
``index_add_``.  Padded window slots carry ``opt = 0``, so their duplicate
index-0 rows add exact zeros and the result does not depend on the order
in which ``index_add_``'s atomics land.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from srba_tpu_torch.solver.lm import (SolverConfig, WindowBatch,
                                      make_solver_impl)

INFO_KEYS = ("err_init", "err_final", "iters", "lam", "num_obs")


def pack_window_ints(edge_ids, edge_opt, lm_ids, lm_opt, obs_lm, obs_valid,
                     path_edge, path_sign) -> np.ndarray:
    """Flatten the window's integer structure into ONE int32 buffer (layout
    mirrored by the unpack inside :func:`make_master_step`)."""
    return np.concatenate([
        np.asarray(edge_ids, np.int32),
        np.asarray(edge_opt, np.int32),
        np.asarray(lm_ids, np.int32),
        np.asarray(lm_opt, np.int32),
        np.asarray(obs_lm, np.int32),
        np.asarray(obs_valid, np.int32),
        np.asarray(path_edge, np.int32).reshape(-1),
        np.asarray(path_sign, np.int32).reshape(-1),
    ])


def _update_rows(master: torch.Tensor, rows: torch.Tensor, start: int):
    """In-place ``master[start:start+n] = rows`` with the start clamped so
    the rows fit, as ``lax.dynamic_update_slice`` does."""
    start = min(max(start, 0), master.shape[0] - rows.shape[0])
    master[start: start + rows.shape[0]].copy_(rows)


def _append(pose_master, prior_master, lm_master, new_rows, off_e, off_l,
            pad_e, pad_l):
    pose_dim, lm_dim = pose_master.shape[1], lm_master.shape[1]
    pd1 = pose_dim + 1
    if pad_e:
        _update_rows(pose_master,
                     new_rows[: pad_e * pose_dim].view(pad_e, pose_dim),
                     off_e)
        _update_rows(prior_master,
                     new_rows[pad_e * pose_dim: pad_e * (pose_dim + pd1)]
                     .view(pad_e, pd1), off_e)
    if pad_l:
        _update_rows(lm_master,
                     new_rows[pad_e * (pose_dim + pd1):].view(pad_l, lm_dim),
                     off_l)


def _to_device(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """One host->device upload: from pinned memory, asynchronously, when
    the target is a CUDA device."""
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


@functools.lru_cache(maxsize=None)
def make_master_step(cfg: SolverConfig):
    """Build the per-keyframe step for one solver configuration.

    Returns ``step(pose_master, prior_master, lm_master, wire, whitener,
    sensor_pose_inv, calib, E, L, N, pad_e, pad_l, z_dim) -> (pose_master,
    prior_master, lm_master, info)``; the masters are updated in place and
    returned for symmetry with the JAX package.  ``wire`` is the HOST f32
    buffer (numpy or CPU tensor): ``pad_e`` new edge poses, ``pad_e`` new
    prior rows ([prior pose || weight]), ``pad_l`` new landmark states, the
    flattened ``[N, z_dim]`` window observations, then the BITCAST int32
    structure: append offsets, the LM iteration cap, and the
    :func:`pack_window_ints` buffer.  The step reads the offsets and the cap
    from the host copy (the loop's trip count must be known on the host) and
    uploads the whole buffer once.  ``info`` holds 0-dim device tensors.
    """
    solve_impl, _ = make_solver_impl(cfg)
    D = cfg.max_depth

    def step(pose_master, prior_master, lm_master, wire,
             whitener, sensor_pose_inv, calib,
             E, L, N, pad_e, pad_l, z_dim):
        dev = pose_master.device
        pose_dim, lm_dim = pose_master.shape[1], lm_master.shape[1]
        rows_len = pad_e * (pose_dim + pose_dim + 1) + pad_l * lm_dim
        ints_at = rows_len + N * z_dim
        wire = torch.as_tensor(wire, dtype=torch.float32)
        off_e, off_l, iters_cap = (
            int(v) for v in wire[ints_at: ints_at + 3].view(torch.int32))
        wire_d = _to_device(wire, dev)
        obs_z = wire_d[rows_len: ints_at].view(N, z_dim)
        ints = wire_d[ints_at + 3:].view(torch.int32)

        # -- append this keyframe's new rows into the masters (in place) ----
        _append(pose_master, prior_master, lm_master, wire_d[:rows_len],
                off_e, off_l, pad_e, pad_l)

        # -- unpack the window structure -----------------------------------
        o = 0

        def take(n):
            nonlocal o
            s = ints[o: o + n]
            o += n
            return s

        edge_ids = take(E)
        edge_opt = take(E).to(torch.float32)
        lm_ids = take(L)
        lm_opt = take(L).to(torch.float32)
        obs_lm = take(N)
        obs_valid = take(N).to(torch.float32)
        path_edge = take(N * D).view(N, D)
        path_sign = take(N * D).view(N, D).to(torch.float32)

        # -- gather window state from the masters ---------------------------
        edge_pose = pose_master[edge_ids]
        prior_rows = prior_master[edge_ids]
        lm_state = lm_master[lm_ids]

        batch = WindowBatch(
            edge_pose=edge_pose, edge_opt=edge_opt,
            lm_state=lm_state, lm_opt=lm_opt,
            obs_z=obs_z, obs_lm=obs_lm,
            path_edge=path_edge, path_sign=path_sign, obs_valid=obs_valid,
            whitener=whitener, sensor_pose_inv=sensor_pose_inv, calib=calib,
            edge_prior=prior_rows[:, :pose_dim],
            edge_prior_w=prior_rows[:, pose_dim],
            iters_cap=iters_cap)
        new_edge, new_lm, info = solve_impl(batch)

        # -- scatter optimized values back (masked deltas: fixed and pad
        # slots add exactly 0 — where, not multiply, so that nothing a fixed
        # slot's solve produced, not even a NaN, reaches the masters) -------
        dp = torch.where(edge_opt[:, None] > 0, new_edge - edge_pose, 0.0)
        dl = torch.where(lm_opt[:, None] > 0, new_lm - lm_state, 0.0)
        pose_master.index_add_(0, edge_ids, dp)
        lm_master.index_add_(0, lm_ids, dl)
        return pose_master, prior_master, lm_master, info

    return step


@functools.lru_cache(maxsize=None)
def make_append_only(pose_dim: int, lm_dim: int):
    """Append-only step for keyframes that skip local optimization
    (``run_local_optimization=False`` / the very first keyframe).  Updates
    the masters in place; ``new_rows`` and ``offsets`` are host arrays."""

    def append(pose_master, prior_master, lm_master, new_rows, offsets,
               pad_e, pad_l):
        rows = _to_device(torch.as_tensor(new_rows, dtype=torch.float32),
                          pose_master.device)
        _append(pose_master, prior_master, lm_master, rows,
                int(offsets[0]), int(offsets[1]), pad_e, pad_l)
        return pose_master, prior_master, lm_master

    return append


def grow_master(master: torch.Tensor, new_cap: int) -> torch.Tensor:
    """Capacity growth on device (no host round-trip): zero-padded copy."""
    out = torch.zeros((new_cap, master.shape[1]), dtype=master.dtype,
                      device=master.device)
    out[: master.shape[0]].copy_(master)
    return out
