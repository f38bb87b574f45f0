from srba_tpu_torch.models.landmarks import LANDMARK_TYPES  # noqa: F401
from srba_tpu_torch.models.noise import NoiseIdentity  # noqa: F401
from srba_tpu_torch.models.observations import (  # noqa: F401
    OBSERVATION_MODELS,
    RangeBearing2D,
)
from srba_tpu_torch.models.sensor_pose import SensorPoseNone  # noqa: F401
