from srba_tpu_torch.models.landmarks import LANDMARK_TYPES  # noqa: F401
from srba_tpu_torch.models.noise import NoiseIdentity  # noqa: F401
from srba_tpu_torch.models.observations import (  # noqa: F401
    OBSERVATION_MODELS,
    Cartesian2D,
    Cartesian3D,
    RangeBearing2D,
    RangeBearing3D,
    RelativePoses2D,
    RelativePoses3D,
    StereoCalib,
    StereoCamera,
)
from srba_tpu_torch.models.sensor_pose import (  # noqa: F401
    SensorPoseNone,
    SensorPoseSE3,
)
