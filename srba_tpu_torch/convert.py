"""Carry state from the JAX package into the port, so both compute on the
same inputs (the parity tests use this).

Everything goes through numpy: ``np.asarray`` on a JAX array copies it to
the host, so this module needs no JAX import.  An SRBA engine has no
weights; its state is the edge poses, landmark states and window structure.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from srba_tpu_torch.ecps import ECPS
from srba_tpu_torch.engine.device_master import DeviceMaster
from srba_tpu_torch.engine.state import ProblemState
from srba_tpu_torch.models.noise import NoiseConstantMatrix, NoiseIdentity
from srba_tpu_torch.models.observations import (CameraCalib, StereoCalib,
                                                calib_constants)
from srba_tpu_torch.utils.registry import lookup
from srba_tpu_torch.solver.lm import SolverConfig, WindowBatch


def solver_config_from_jax(cfg) -> SolverConfig:
    """The port's ``SolverConfig`` with the same fields as a JAX one."""
    return SolverConfig(**dataclasses.asdict(cfg))


def calib_from_jax(jc):
    """JAX ``CameraCalib`` or ``StereoCalib`` (host numpy scalar leaves) ->
    the port's, told apart by their fields (a stereo rig has a
    ``baseline``)."""
    kw = {f: np.asarray(getattr(jc, f)) for f in ("fx", "fy", "cx", "cy")}
    if hasattr(jc, "baseline"):
        return StereoCalib.make(baseline=np.asarray(jc.baseline), **kw)
    return CameraCalib.make(**kw)


stereo_calib_from_jax = calib_from_jax


def window_batch_from_jax(jb, device="cuda") -> WindowBatch:
    """JAX ``WindowBatch`` -> port ``WindowBatch`` on ``device``.  A
    calibration becomes the port's in its device form (Python floats); a
    scalar ``iters_cap`` becomes a host int."""
    fields = {}
    for f in dataclasses.fields(WindowBatch):
        v = getattr(jb, f.name)
        if v is None:
            fields[f.name] = None
        elif f.name == "calib":
            fields[f.name] = calib_constants(calib_from_jax(v))
        elif f.name == "iters_cap":
            fields[f.name] = int(np.asarray(v))
        else:
            fields[f.name] = torch.as_tensor(np.array(v), device=device)
    return WindowBatch(**fields)


def problem_state_from_jax(st) -> ProblemState:
    """Deep copy of a JAX ``ProblemState`` (already numpy) into the port's."""
    out = ProblemState(pose_dim=st.pose_dim, lm_dim=st.lm_dim,
                       z_dim=st.z_dim)
    for f in dataclasses.fields(ProblemState):
        v = getattr(st, f.name)
        setattr(out, f.name, np.array(v) if isinstance(v, np.ndarray)
                else copy.deepcopy(v))
    return out


def device_master_from_jax(jdm, device="cuda") -> DeviceMaster:
    """JAX ``DeviceMaster`` (masters, row counts, staging, sequence
    counters) -> port ``DeviceMaster`` on ``device``.  A pending prefetch is
    dropped (the port's mirror then syncs by a blocking download)."""
    dm = DeviceMaster(jdm.pose_dim, jdm.lm_dim, device=device)
    dm.pose = torch.as_tensor(np.array(jdm.pose), device=dm.device)
    dm.prior = torch.as_tensor(np.array(jdm.prior), device=dm.device)
    dm.lm = torch.as_tensor(np.array(jdm.lm), device=dm.device)
    dm.num_edges, dm.num_lms = jdm.num_edges, jdm.num_lms
    dm._pend_edges = [np.array(r) for r in jdm._pend_edges]
    dm._pend_priors = [np.array(r) for r in jdm._pend_priors]
    dm._pend_lms = [np.array(r) for r in jdm._pend_lms]
    dm.step_seq, dm.mirror_seq = jdm.step_seq, jdm.mirror_seq
    return dm


def ecp_from_jax(jecp):
    """JAX edge-creation policy -> the port's policy of the same name with
    the same fields; a stateful one (``LocalAreasVar1``) carries its area
    state across through ``get_state``/``set_state``."""
    cls = lookup(ECPS, jecp.name, "edge-creation policy")
    out = cls(**{f.name: getattr(jecp, f.name)
                 for f in dataclasses.fields(jecp)})
    if hasattr(jecp, "get_state"):
        out.set_state(copy.deepcopy(jecp.get_state()))
    return out


def noise_from_jax(jn):
    """JAX ``NoiseIdentity`` / ``NoiseConstantMatrix`` -> the port's (same
    parameters, so the same whitener bit for bit)."""
    if jn.name == "constant_matrix":
        return NoiseConstantMatrix(np.array(jn.cov))
    if jn.name == "identity":
        return NoiseIdentity(jn.std)
    raise NotImplementedError(
        f"noise model {jn.name!r} is not ported to srba_tpu_torch yet")
