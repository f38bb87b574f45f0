"""Edge-creation policies (ECPs) — port of :mod:`srba_tpu.ecps` (so far
``ClassicLinearRBA`` and ``LocalAreasFixedGrid``; ``LocalAreasVar1`` raises
by name through the ``ECPS`` lookup).

Policy contract (as in the JAX package): ``edges_for_new_kf(state, graph,
new_kf, obs_lm_ids)`` returns ``(primary_targets, closure_targets)`` —
existing-KF ids the new keyframe links to; edges are created as
``(new_kf, target)`` with pose unknown ``T_new<-target``.  ``primary`` links
are topologically local (seeded from the dead-reckoned trajectory);
``closure`` links are re-visits of distant map areas (bootstrapped from the
re-observed landmarks, :mod:`srba_tpu_torch.engine.closure`).
``obs_lm_ids`` are the landmark ids observed by the new KF that already
exist in the map (the loop-closure evidence).
"""

from __future__ import annotations

from collections import Counter
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


@dataclass
class LocalAreasFixedGrid:
    """Submap topology: KFs are grouped into fixed-size areas; each area's
    first KF is its *center*.  A new KF links to its own area center, a new
    center links to the previous center, and **loop closures** add edges to
    other areas' centers when the new KF re-observes enough landmarks based
    in those areas.  Reference: ``ecps::local_areas_fixed_grid`` with
    ``submap_size`` / ``min_obs_count_to_consider_loop_closure``.
    """

    submap_size: int = 10
    min_obs_count_loop_closure: int = 4
    name: str = "local_areas_fixed_grid"

    def center_of(self, kf: int) -> int:
        return (kf // self.submap_size) * self.submap_size

    def edges_for_new_kf(self, state: ProblemState, graph: KeyframeGraph,
                         new_kf: int, obs_lm_ids: List[int]):
        if new_kf == 0:
            return [], []
        my_center = self.center_of(new_kf)
        primary: List[int] = []
        if new_kf == my_center:
            # New area center: chain to the previous area's center.
            primary.append(self.center_of(new_kf - 1))
        else:
            primary.append(my_center)

        # Loop closures: count re-observed landmarks per foreign area center.
        votes: Counter = Counter()
        for lm in obs_lm_ids:
            c = self.center_of(int(state.lm_base[lm]))
            if c != my_center:
                votes[c] += 1
        closures: List[int] = []
        for center, count in sorted(votes.items()):
            if count >= self.min_obs_count_loop_closure \
                    and center not in primary and center != new_kf \
                    and _needs_closure(graph, primary[0], center):
                closures.append(center)
        return primary, closures


def _needs_closure(graph: KeyframeGraph, anchor: int, center: int) -> bool:
    """A loop-closure edge is only structurally useful when the re-visited
    area is NOT already reachable within the spanning-tree depth (through
    the primary link's neighborhood).  Without this check every keyframe in
    a re-visited region re-votes an edge to the same center, the graph
    densifies into a small world and depth-bounded windows balloon to the
    whole map; one closure edge per re-entered area keeps windows bounded
    (the SRBA O(1) property)."""
    return graph.distance(anchor, center,
                          max(1, graph.max_tree_depth - 1)) is None


ECPS = {"classic_linear_rba": ClassicLinearRBA,
        "local_areas_fixed_grid": LocalAreasFixedGrid}
