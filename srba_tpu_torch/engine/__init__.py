from srba_tpu_torch.engine.engine import (  # noqa: F401
    Observation,
    SrbaEngine,
    SrbaParams,
    TNewKeyFrameInfo,
)
from srba_tpu_torch.engine.state import ProblemState  # noqa: F401
