from srba_tpu_torch.models.landmarks import LANDMARK_TYPES  # noqa: F401
from srba_tpu_torch.models.noise import NoiseIdentity  # noqa: F401
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
