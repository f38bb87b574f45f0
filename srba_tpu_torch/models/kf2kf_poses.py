"""KF-to-KF relative-pose unknown types (port of
:mod:`srba_tpu.models.kf2kf_poses`) — analog of the reference's
``kf2kf_poses::SE2`` / ``kf2kf_poses::SE3`` (public MRPT/srba layout:
``include/srba/models/kf2kf_poses.h``; SURVEY.md §3).

In the reference these are compile-time template tags selecting the manifold
dimension (3/6) and the pseudo-exponential increment rule.  Here the group
descriptors of :mod:`srba_tpu_torch.ops.lie` play that role: they carry
``dim`` (storage width), ``dof`` (tangent width) and the batched
compose/inverse/retract operations the solver specializes over.
"""

from srba_tpu_torch.ops.lie import SE2, SE3

KF2KF_POSE_TYPES = {"SE2": SE2, "SE3": SE3}

__all__ = ["SE2", "SE3", "KF2KF_POSE_TYPES"]
