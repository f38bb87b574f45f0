"""Checkpoint / resume — the port of :mod:`srba_tpu.io.checkpoint` (a
capability the reference lacks: ``TRBA_Problem_state`` has no
serialization, recovery means re-running the dataset).

The full engine state (SoA tables, graph topology, landmark id map,
parameters, and the model configuration — calibration, noise model, sensor
mounting pose, edge-creation policy) round-trips through one ``.npz`` file
in the JAX package's format (version 5; versions 2-5 load), so a checkpoint
saved by either package loads in the other: that is how a whole engine's
state crosses between them.  Pending closures and pending monocular
landmarks are not part of the format.

One deliberate deviation from the JAX package: a pre-v5 checkpoint of the
stateful ``local_areas_var1`` policy carries no policy state, so
:func:`load_checkpoint` raises a ``ValueError`` that asks for ``ecp=``
(the JAX package fails there with a ``TypeError`` on the legacy
``submap_size`` key); policy keywords are filtered to the policy's fields.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import asdict

import numpy as np

CHECKPOINT_VERSION = 5   # v5 adds per-edge fit information (k2k_info)
# and stateful-ECP state; v4 added per-edge measured sigma (k2k_sigma);
# v3 added edge measurement priors (k2k_prior/_w)

TABLES = ("k2k_from", "k2k_to", "k2k_pose", "k2k_prior", "k2k_prior_w",
          "k2k_sigma", "k2k_info", "lm_base", "lm_state", "lm_fixed",
          "obs_kf", "obs_lm", "obs_z")


def _host(v) -> np.ndarray:
    """A calibration leaf or a pose as host numpy (torch tensors are copied
    off their device)."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _encode_calib(calib):
    if calib is None:
        return None
    kind = type(calib).__name__
    vals = {f.name: _host(getattr(calib, f.name)).tolist()
            for f in dataclasses.fields(calib)}
    return {"kind": kind, "values": vals}


def _decode_calib(enc):
    if enc is None:
        return None
    from srba_tpu_torch.models.observations import CameraCalib, StereoCalib
    kinds = {"CameraCalib": CameraCalib, "StereoCalib": StereoCalib}
    cls = kinds.get(enc["kind"])
    if cls is None:
        raise ValueError(
            f"checkpoint has unknown calibration kind {enc['kind']!r}; "
            "pass calib= explicitly to load_checkpoint")
    # float32 numpy scalars, the form of CameraCalib.make / StereoCalib.make.
    return cls(**{k: np.float32(v) for k, v in enc["values"].items()})


def _encode_noise(noise):
    if noise.name == "identity":
        return {"name": "identity", "std": float(noise.std)}
    if noise.name == "constant_matrix":
        return {"name": "constant_matrix", "cov": noise.cov.tolist()}
    raise ValueError(
        f"cannot serialize custom noise model {type(noise).__name__}; "
        "pass noise= explicitly on resume")


def _decode_noise(enc):
    from srba_tpu_torch.models.noise import NoiseConstantMatrix, NoiseIdentity
    if enc["name"] == "identity":
        return NoiseIdentity(enc["std"])
    return NoiseConstantMatrix(np.asarray(enc["cov"], np.float64))


def _encode_sensor_pose(sp, group):
    if sp.is_identity:
        return {"name": "none"}
    return {"name": "se3", "pose": _host(sp.pose_for(group)).tolist()}


def _decode_sensor_pose(enc):
    from srba_tpu_torch.models.sensor_pose import (SensorPoseNone,
                                                   SensorPoseSE3)
    if enc["name"] == "none":
        return SensorPoseNone()
    return SensorPoseSE3(np.asarray(enc["pose"], np.float32))


def _encode_ecp(ecp):
    from srba_tpu_torch.ecps import ECPS
    name = getattr(ecp, "name", None)
    if name not in ECPS:
        raise ValueError(
            f"cannot serialize custom edge-creation policy "
            f"{type(ecp).__name__}; pass ecp= explicitly on resume")
    out = {"name": name}
    for k in ("submap_size", "min_obs_count_loop_closure", "min_obs_to_join"):
        if hasattr(ecp, k):
            out[k] = int(getattr(ecp, k))
    if hasattr(ecp, "get_state"):   # stateful policy (LocalAreasVar1)
        out["state"] = ecp.get_state()
    return out


def _decode_ecp(enc, version: int = CHECKPOINT_VERSION):
    """The policy of ``enc``, built from the keywords its class has (a
    legacy key such as a v4 ``local_areas_var1``'s ``submap_size`` is
    dropped).  A stateful policy saved without its state (before v5)
    cannot resume: that raises a ``ValueError`` asking for ``ecp=``."""
    from srba_tpu_torch.ecps import ECPS
    cls = ECPS[enc["name"]]
    if hasattr(cls, "set_state") and "state" not in enc:
        raise ValueError(
            f"checkpoint version {version} holds no state for the stateful "
            f"edge-creation policy {enc['name']!r} (saved before version 5)"
            "; pass ecp= explicitly to load_checkpoint")
    names = {f.name for f in dataclasses.fields(cls)} - {"name"}
    ecp = cls(**{k: v for k, v in enc.items() if k in names})
    if "state" in enc and hasattr(ecp, "set_state"):
        ecp.set_state(enc["state"])
    return ecp


def save_checkpoint(engine, path: str) -> None:
    engine.sync()  # the device masters are authoritative between keyframes
    st = engine.state
    meta = {
        "version": CHECKPOINT_VERSION,
        "obs_model": engine.model.name,
        "lm_type": engine.lm_type.name,
        "params": asdict(engine.parameters),
        "calib": _encode_calib(engine.calib),
        "noise": _encode_noise(engine.noise),
        "sensor_pose": _encode_sensor_pose(engine.sensor_pose, engine.group),
        "ecp": _encode_ecp(engine.ecp),
        "lm_id_map": {str(k): v for k, v in engine._lm_id_map.items()},
        "counts": {
            "num_kfs": st.num_kfs, "num_edges": st.num_edges,
            "num_lms": st.num_lms, "num_obs": st.num_obs,
        },
    }
    rows = {"k": st.num_edges, "l": st.num_lms, "o": st.num_obs}
    np.savez_compressed(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        **{t: getattr(st, t)[: rows[t[0]]] for t in TABLES})


def load_checkpoint(path: str, calib=None, noise=None, sensor_pose=None,
                    ecp=None, device="cuda"):
    """Rebuild a working engine on ``device`` from a checkpoint.  All model
    configuration (calibration, noise model, sensor pose, ECP) is restored
    from the checkpoint itself; the keyword arguments override it (needed
    only for custom classes the checkpoint cannot encode, and for a pre-v5
    ``local_areas_var1`` checkpoint).  The tables are replayed into the host
    state, the graph and the native core, the device masters are replaced
    by one upload, and the dead-reckoned trajectory is rebuilt from the
    loaded poses."""
    from srba_tpu_torch.engine.engine import SrbaEngine, SrbaParams

    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(bytes(data["meta"]).decode())
        tab = {t: data[t] for t in TABLES if t in data.files}
    version = meta["version"]
    if version not in (2, 3, 4, CHECKPOINT_VERSION):
        raise ValueError(f"unsupported checkpoint version {version}")
    has_priors = version >= 3

    if calib is None:
        calib = _decode_calib(meta["calib"])
    if noise is None:
        noise = _decode_noise(meta["noise"])
    if sensor_pose is None:
        sensor_pose = _decode_sensor_pose(meta["sensor_pose"])
    if ecp is None:
        ecp = _decode_ecp(meta["ecp"], version)

    eng = SrbaEngine(
        meta["obs_model"], lm_type=meta["lm_type"], calib=calib, noise=noise,
        sensor_pose=sensor_pose, ecp=ecp,
        params=SrbaParams(**meta["params"]), device=device)

    c = meta["counts"]
    st = eng.state
    for _ in range(c["num_kfs"]):
        st.add_keyframe()
        eng.graph.add_keyframe()
    for e in range(c["num_edges"]):
        a, b = int(tab["k2k_from"][e]), int(tab["k2k_to"][e])
        st.add_edge(a, b, tab["k2k_pose"][e],
                    prior_w=(float(tab["k2k_prior_w"][e])
                             if has_priors else 0.0),
                    sigma=(float(tab["k2k_sigma"][e])
                           if version >= 4 else 0.0),
                    info=tab["k2k_info"][e] if version >= 5 else None)
        if has_priors:
            st.k2k_prior[e] = tab["k2k_prior"][e]
        eng.graph.add_edge(a, b)
    for l in range(c["num_lms"]):
        st.add_landmark(int(tab["lm_base"][l]), tab["lm_state"][l],
                        fixed=bool(tab["lm_fixed"][l]))
    for o in range(c["num_obs"]):
        st.add_observation(int(tab["obs_kf"][o]), int(tab["obs_lm"][o]),
                           tab["obs_z"][o])
    eng._lm_id_map = {int(k): v for k, v in meta["lm_id_map"].items()}
    if eng.native is not None:
        # Replay the symbolic structure into the C++ host graph service.
        for _ in range(c["num_kfs"]):
            eng.native.add_keyframe()
        for e in range(c["num_edges"]):
            eng.native.add_edge(int(tab["k2k_from"][e]),
                                int(tab["k2k_to"][e]))
        for l in range(c["num_lms"]):
            eng.native.add_landmark(int(tab["lm_base"][l]),
                                    bool(tab["lm_fixed"][l]))
        for o in range(c["num_obs"]):
            eng.native.add_observation(int(tab["obs_kf"][o]),
                                       int(tab["obs_lm"][o]))
    if eng.device_master is not None:
        # The loops above wrote the host tables directly; replace the device
        # masters wholesale (one upload).
        eng.device_master.upload_from_host(
            st.k2k_pose, st.lm_state, st.num_edges, st.num_lms,
            k2k_prior=st.k2k_prior, k2k_prior_w=st.k2k_prior_w)
    # Rebuild the dead-reckoned trajectory from the (optimized) loaded poses.
    if c["num_kfs"]:
        G, dist = eng.create_complete_spanning_tree(0)
        ident = np.asarray(eng.np_group.identity(), np.float32)
        eng._G_dr = [np.asarray(G[k], np.float32) if k in dist else ident
                     for k in range(c["num_kfs"])]
    return eng
