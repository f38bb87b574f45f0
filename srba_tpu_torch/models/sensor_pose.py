"""Sensor-mounting options — port of :mod:`srba_tpu.models.sensor_pose`
(so far only ``SensorPoseNone``: the sensor frame is the keyframe frame and
the solver's residual has no mounting transform)."""

from __future__ import annotations


class SensorPoseNone:
    """Sensor frame coincides with the robot/keyframe frame."""

    name = "none"
    is_identity = True

    def pose_for(self, group):
        return group.identity()
