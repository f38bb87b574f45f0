"""Edge-creation policies (ECPs) — port of :mod:`srba_tpu.ecps`:
``ClassicLinearRBA``, ``LocalAreasFixedGrid`` and ``LocalAreasVar1``.

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


@dataclass
class LocalAreasVar1:
    """Adaptive local-areas policy (reference ``ecps::local_areas_var1``,
    public MRPT/srba layout ``include/srba/ecps/local_areas_var1.h``):
    areas are defined by OBSERVATION OVERLAP, not by a fixed keyframe-id
    grid.

    * **Assignment**: each existing area collects one vote per observed
      landmark its CENTER knows — landmarks first observed at the center
      (base == center) plus the known landmarks the center re-observed at
      its creation.  Voting against the center's own observation set (not
      transitively against all area members) bounds an area to the region
      visible from its center.  The new keyframe JOINS the supporting area
      (votes >= ``min_obs_to_join``) whose center is *nearest by
      spanning-tree distance* from the previous keyframe (ties break toward
      more votes, then lower id) and links to that center — the primary
      edge, keeping windows a star around the center.
    * **Opening**: when no area has enough observation support the
      keyframe becomes a NEW area center and chains to the previous
      keyframe.
    * **Re-entry**: a supporting home center NOT reachable within the tree
      depth is a re-visit after a long excursion — the keyframe keeps its
      local chain link and the home center is emitted as a loop CLOSURE
      (the engine then bootstraps it from the re-observed landmarks).
    * Other strongly-voted areas become loop closures exactly as in
      :class:`LocalAreasFixedGrid`.

    The policy is stateful (area membership per keyframe); ``get_state`` /
    ``set_state`` carry that state (the JAX package's checkpoint format).
    """

    min_obs_to_join: int = 3
    min_obs_count_loop_closure: int = 4
    name: str = "local_areas_var1"

    def __post_init__(self):
        self._centers: List[int] = []
        self._kf_area: List[int] = []
        # center -> known-landmark snapshot at its creation; landmarks FIRST
        # observed at the center are covered by base == center at vote time.
        self._center_lms: dict = {}
        self._lm_centers: dict = {}   # inverted index (rebuilt on resume)

    # -- introspection / checkpoint support ---------------------------------

    @property
    def centers(self) -> List[int]:
        return list(self._centers)

    def area_of_kf(self, kf: int) -> int:
        return self._kf_area[kf]

    def get_state(self):
        return {"centers": list(self._centers),
                "kf_area": list(self._kf_area),
                "center_lms": {str(c): sorted(s)
                               for c, s in self._center_lms.items()}}

    def set_state(self, s) -> None:
        self._centers = [int(x) for x in s["centers"]]
        self._kf_area = [int(x) for x in s["kf_area"]]
        self._center_lms = {int(c): set(int(x) for x in lms)
                            for c, lms in s.get("center_lms", {}).items()}
        self._lm_centers = {}
        for c, lms in self._center_lms.items():
            for lm in lms:
                self._lm_centers.setdefault(lm, []).append(c)

    def _open_area(self, kf: int, obs_lm_ids) -> None:
        self._centers.append(kf)
        self._kf_area.append(kf)
        snap = set(int(x) for x in obs_lm_ids)
        self._center_lms[kf] = snap
        for lm in snap:
            self._lm_centers.setdefault(lm, []).append(kf)

    # -- the policy ----------------------------------------------------------

    def edges_for_new_kf(self, state: ProblemState, graph: KeyframeGraph,
                         new_kf: int, obs_lm_ids: List[int]):
        if new_kf == 0:
            self._open_area(0, obs_lm_ids)
            return [], []
        if len(self._kf_area) != new_kf:
            raise ValueError(
                "LocalAreasVar1 must see every keyframe exactly once in order "
                f"(saw {len(self._kf_area)} areas at kf {new_kf}); on "
                "resume, restore its state via set_state")
        votes: Counter = Counter()
        for lm in obs_lm_ids:
            cs = set(self._lm_centers.get(int(lm), ()))
            base = int(state.lm_base[lm])
            if base in self._center_lms:
                cs.add(base)            # first observed AT the center
            for c in cs:
                votes[c] += 1
        anchor = new_kf - 1
        depth = graph.max_tree_depth
        home, home_key = None, None
        for c, n in votes.items():
            if n < self.min_obs_to_join:
                continue
            d = graph.distance(anchor, c, depth)
            key = (d if d is not None else depth + 1, -n, c)
            if home_key is None or key < home_key:
                home, home_key = c, key
        if home is None:
            # New territory: open an area here, chain to the previous KF.
            self._open_area(new_kf, obs_lm_ids)
            return [anchor], []
        self._kf_area.append(home)
        if home_key[0] > depth:
            # Re-entry into a distant area: local chain + closure to its
            # center (measurement-bootstrapped by the engine).
            primary, closures = [anchor], [home]
        else:
            primary, closures = [home], []
        for c, n in sorted(votes.items()):
            if c == home or c == new_kf or c in primary:
                continue
            if n >= self.min_obs_count_loop_closure \
                    and _needs_closure(graph, primary[0], c):
                closures.append(c)
        return primary, closures


ECPS = {"classic_linear_rba": ClassicLinearRBA,
        "local_areas_fixed_grid": LocalAreasFixedGrid,
        "local_areas_var1": LocalAreasVar1}
