"""Sensor-mounting options — port of :mod:`srba_tpu.models.sensor_pose`
(the analog of the reference's ``options::sensor_pose_on_robot_none`` /
``sensor_pose_on_robot_se3``).  The solver applies the inverse mount after
the path composition only when the option is not the identity
(``SolverConfig.use_sensor_pose``)."""

from __future__ import annotations

import numpy as np


class SensorPoseNone:
    """Sensor frame coincides with the robot/keyframe frame."""

    name = "none"
    is_identity = True

    def pose_for(self, group):
        return group.identity()


class SensorPoseSE3:
    """Fixed SE(3) sensor offset on the robot (``sensor_pose_on_robot_se3``).
    For SE(2) problems the offset is interpreted as (x, y, yaw)."""

    name = "se3"
    is_identity = False

    def __init__(self, pose):
        """``pose``: length-3 (x, y, yaw) for SE2 problems or length-7
        (tx, ty, tz, qw, qx, qy, qz) for SE3 problems."""
        self._pose = np.asarray(pose, dtype=np.float32)

    def pose_for(self, group):
        if group.name == "SE2":
            if self._pose.shape != (3,):
                raise ValueError("SE2 sensor pose must be (x,y,yaw)")
        elif group.name != "SE3" or self._pose.shape != (7,):
            raise ValueError("SE3 sensor pose must be a 7-vector (t, quat)")
        return self._pose
