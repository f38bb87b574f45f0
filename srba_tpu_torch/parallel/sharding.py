"""SPMD execution of the LM+Schur solver over a device mesh — the port of
:mod:`srba_tpu.parallel.sharding` on ``torch.distributed``.

The design is the JAX package's (see its module docstring):
**observation-sharded data parallelism with a distributed Schur
reduction**.  The observations of a window are split over the mesh's
``obs`` axis; every rank evaluates residuals and Jacobians for its shard,
the partial normal equations ``(Hp, gp, Hf, gf, Hpf)`` are summed over the
ranks in one packed all-reduce per LM iteration (inside
:func:`srba_tpu_torch.solver.lm.make_solver_impl` when ``cfg.axis_name`` is
set), and the reduced camera system is solved whole on every rank.

What a mesh is here: a 1-D ``torch.distributed`` ``DeviceMesh`` named
``"obs"`` over the ranks of the process group, one device per rank (JAX's
mesh of several devices in one process has no torch counterpart: a world of
W ranks plays a mesh of W devices).  Every rank passes the same full host
arrays, as the JAX engine does; :func:`shard_batch` keeps the rank's rows
of the observation tables on the rank's device and everything else whole.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from srba_tpu_torch.parallel import multihost
from srba_tpu_torch.solver.lm import (SolverConfig, WindowBatch,
                                      make_solver_impl)

OBS_AXIS = multihost.OBS_AXIS

# The WindowBatch fields split over the mesh (rows of the observation
# tables); the others are replicated.
SHARDED_FIELDS = ("obs_z", "obs_lm", "path_edge", "path_sign", "obs_valid")


def make_mesh(n_devices: int | None = None, devices=None):
    """1-D mesh over the observation-parallel axis: every rank of the
    process group, one device each.  Joins a single-rank world first when
    there is no process group (:func:`multihost.initialize`, on
    ``devices``, default ``"cuda"``).  ``n_devices``, when given, must be
    the world size; ``devices`` (a device or its type), when given, must be
    the type of the rank's device."""
    return multihost.global_mesh(OBS_AXIS, n_devices=n_devices,
                                 device=devices)


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on in ``mesh``."""
    return multihost.rank_device(mesh.device_type)


def shard_rows(n: int, mesh) -> slice:
    """This rank's rows of a table of ``n`` rows split over ``mesh``:
    ``[r*n/W, (r+1)*n/W)``.  ``n`` must divide by the mesh size W (window
    buckets are powers of two)."""
    W = mesh.size()
    if n % W:
        raise ValueError(f"{n} rows do not split over a mesh of {W} ranks "
                         "(pad to a multiple of the mesh size)")
    r = mesh.get_local_rank()
    return slice(r * n // W, (r + 1) * n // W)


def shard_batch(batch: WindowBatch, mesh) -> WindowBatch:
    """This rank's view of a full host-built :class:`WindowBatch` (numpy
    arrays or tensors, the same on every rank): the observation tables cut
    to the rank's rows, everything on the rank's device; the dtypes of the
    inputs are kept."""
    dev = mesh_device(mesh)
    rows = shard_rows(int(np.shape(batch.obs_valid)[0]), mesh)

    def place(name, x):
        if name in SHARDED_FIELDS:
            x = x[rows]
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x, device=dev)

    return dataclasses.replace(batch, **{
        f.name: place(f.name, getattr(batch, f.name))
        for f in dataclasses.fields(batch)
        if getattr(batch, f.name) is not None
        and f.name not in ("calib", "iters_cap")})


@functools.lru_cache(maxsize=None)
def make_spmd_solver(cfg: SolverConfig, mesh):
    """The sharded solver over ``mesh``: ``(solve, eval_error)`` with
    ``solve(batch) -> (edge_pose, lm_state, info)`` and ``eval_error(batch)
    -> err``, where ``batch`` is the FULL window (every rank passes the
    same host arrays; each call shards it with :func:`shard_batch`) and
    every output is the same on every rank.  The padded observation count
    must divide by the mesh size.  Cached per ``(cfg, mesh)``, as the JAX
    package caches its compiled program."""
    if cfg.axis_name != OBS_AXIS:
        cfg = dataclasses.replace(cfg, axis_name=OBS_AXIS)
    solve_impl, eval_impl = make_solver_impl(cfg, mesh)
    return (lambda b: solve_impl(shard_batch(b, mesh)),
            lambda b: eval_impl(shard_batch(b, mesh)))
