"""INI sensor-configuration parsing — the port of
:mod:`srba_tpu.io.config_ini` (the analog of the reference's MRPT
``CConfigFile`` sensor-calibration input used by ``srba-slam``, its
``--sensor-params-cfg-file`` flow).  Returns the port's ``CameraCalib`` /
``StereoCalib`` / ``SensorPoseSE3`` / ``NoiseIdentity`` /
``NoiseConstantMatrix``; the mount pose comes from the port's
``SE3.from_xyz_ypr`` on the CPU.

Supported sections (MRPT-style key names where they exist):

```
[CAMERA]            ; monocular pinhole
fx = 200.0
fy = 200.0
cx = 160.0
cy = 120.0

[CAMERA_STEREO]     ; adds the baseline
fx = ...
baseline = 0.12

[SENSOR_POSE]       ; SE(3) sensor mounting on the robot
x = 0.0
y = 0.0
z = 0.0
yaw = 0.0           ; radians
pitch = 0.0
roll = 0.0

[OBS_NOISE]         ; observation noise model
type = constant_matrix   ; or "identity"
std = 1.0                ; identity: isotropic sigma
cov = 0.01 0 0 0.04      ; constant_matrix: row-major obs_dim x obs_dim
```
"""

from __future__ import annotations

import configparser
from typing import Any, Optional, Tuple


def load_sensor_ini(path: str, obs_model: str
                    ) -> Tuple[Optional[Any], Optional[Any]]:
    """Returns ``(calib, sensor_pose)`` for the given observation model
    (either may be None when its section is absent)."""
    import numpy as np

    from srba_tpu_torch.models.observations import CameraCalib, StereoCalib
    from srba_tpu_torch.models.sensor_pose import SensorPoseSE3
    from srba_tpu_torch.ops.lie import SE3

    cp = configparser.ConfigParser(inline_comment_prefixes=(";", "#"))
    with open(path) as f:
        cp.read_file(f)

    calib = None
    if obs_model == "MonocularCamera" and cp.has_section("CAMERA"):
        s = cp["CAMERA"]
        calib = CameraCalib.make(
            fx=s.getfloat("fx"), fy=s.getfloat("fy"),
            cx=s.getfloat("cx"), cy=s.getfloat("cy"))
    elif obs_model == "StereoCamera" and cp.has_section("CAMERA_STEREO"):
        s = cp["CAMERA_STEREO"]
        calib = StereoCalib.make(
            fx=s.getfloat("fx"), fy=s.getfloat("fy"),
            cx=s.getfloat("cx"), cy=s.getfloat("cy"),
            baseline=s.getfloat("baseline"))

    sensor_pose = None
    if cp.has_section("SENSOR_POSE"):
        s = cp["SENSOR_POSE"]
        pose = SE3.from_xyz_ypr(
            s.getfloat("x", 0.0), s.getfloat("y", 0.0), s.getfloat("z", 0.0),
            s.getfloat("yaw", 0.0), s.getfloat("pitch", 0.0),
            s.getfloat("roll", 0.0), device="cpu").numpy().astype(np.float32)
        sensor_pose = SensorPoseSE3(pose)
    return calib, sensor_pose


def load_noise_ini(path: str, obs_dim: int) -> Optional[Any]:
    """Parse the ``[OBS_NOISE]`` section into a noise model (None when the
    section is absent) — the INI path to the reference's
    ``observation_noise_constant_matrix`` option."""
    import numpy as np

    from srba_tpu_torch.models.noise import NoiseConstantMatrix, NoiseIdentity

    cp = configparser.ConfigParser(inline_comment_prefixes=(";", "#"))
    with open(path) as f:
        cp.read_file(f)
    if not cp.has_section("OBS_NOISE"):
        return None
    s = cp["OBS_NOISE"]
    kind = s.get("type", "identity").strip().lower()
    if kind == "identity":
        return NoiseIdentity(s.getfloat("std", 1.0))
    if kind == "constant_matrix":
        vals = np.asarray([float(v) for v in s.get("cov").split()],
                          np.float64)
        if vals.size != obs_dim * obs_dim:
            raise ValueError(
                f"[OBS_NOISE] cov needs {obs_dim * obs_dim} row-major values "
                f"for a {obs_dim}-d observation, got {vals.size}")
        return NoiseConstantMatrix(vals.reshape(obs_dim, obs_dim))
    raise ValueError(f"unknown [OBS_NOISE] type {kind!r}")
