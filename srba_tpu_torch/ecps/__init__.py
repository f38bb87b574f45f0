"""Edge-creation policies (ECPs) — port of :mod:`srba_tpu.ecps` (so far only
``ClassicLinearRBA``; the local-areas policies raise by name through the
``ECPS`` lookup).

Policy contract (as in the JAX package): ``edges_for_new_kf(state, graph,
new_kf, obs_lm_ids)`` returns ``(primary_targets, closure_targets)`` —
existing-KF ids the new keyframe links to; edges are created as
``(new_kf, target)`` with pose unknown ``T_new<-target``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from srba_tpu_torch.engine.state import ProblemState
from srba_tpu_torch.graph.spantree import KeyframeGraph


@dataclass
class ClassicLinearRBA:
    """Chain topology: every new KF links to the previous KF (odometry-like).
    Reference: ``ecps::classic_linear_rba``."""

    name: str = "classic_linear_rba"

    def edges_for_new_kf(self, state: ProblemState, graph: KeyframeGraph,
                         new_kf: int, obs_lm_ids: List[int]):
        return ([new_kf - 1] if new_kf > 0 else []), []


ECPS = {"classic_linear_rba": ClassicLinearRBA}
