from srba_tpu_torch.models.kf2kf_poses import KF2KF_POSE_TYPES  # noqa: F401
from srba_tpu_torch.models.landmarks import LANDMARK_TYPES  # noqa: F401
from srba_tpu_torch.models.noise import (  # noqa: F401
    NoiseConstantMatrix,
    NoiseIdentity,
)
from srba_tpu_torch.models.observations import (  # noqa: F401
    OBSERVATION_MODELS,
    CameraCalib,
    Cartesian2D,
    Cartesian3D,
    MonocularCamera,
    RangeBearing2D,
    RangeBearing3D,
    RelativePoses2D,
    RelativePoses3D,
    RGBDCamera,
    StereoCalib,
    StereoCamera,
)
from srba_tpu_torch.models.sensor_pose import (  # noqa: F401
    SensorPoseNone,
    SensorPoseSE3,
)
