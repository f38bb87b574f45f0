"""srba_tpu_torch — the PyTorch/CUDA port of ``srba_tpu`` (Sparser Relative
Bundle Adjustment), for one NVIDIA H100.

It mirrors ``srba_tpu``'s module paths and public names; the JAX package is
the reference every module is tested against.  It imports torch and numpy,
never JAX.  The batched SPD block inverse of the Schur solve is a CUDA
kernel written for Hopper (``csrc/spd_inverse.cu``), built with nvcc at
first use.  See ROADMAP.md for what is ported so far.
"""

__version__ = "0.1.0"

from srba_tpu_torch.engine.engine import (  # noqa: F401
    Observation,
    SrbaEngine,
    SrbaParams,
    TNewKeyFrameInfo,
)
from srba_tpu_torch.ops.lie import SE2, SE3  # noqa: F401
