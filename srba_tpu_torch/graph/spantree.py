"""Host-side keyframe-graph service (a copy of
:mod:`srba_tpu.graph.spantree`, framework-free): adjacency + bounded-depth
shortest-path (spanning-tree) queries.

Reference analog (public MRPT/srba layout; SURVEY.md §3, §4.4):
``TSpanningTree`` symbolic structures in ``include/srba/srba_types.h`` and the
incremental updates in ``include/srba/impl/spantree_misc.h`` /
``spantree_update_numeric.h``.

Split: this module owns only the **symbolic** side (pure int
bookkeeping — which edges lie on the bounded shortest path between two nearby
KFs, which fixes Jacobian sparsity).  The **numeric** side (composing relative
poses along those paths) lives on device: the solver gathers edge poses by the
index lists produced here and composes them inside the device solve, so the
reference's hottest maintenance loop (``update_numeric``) disappears as a
separate phase entirely — paths are recomposed from current edge values on
every residual evaluation at negligible cost.

Invariant exploited throughout (SURVEY.md §4.4): the KF graph is append-only
(edges are never removed), so per-KF BFS caches can only be *invalidated into
shorter paths* by new edges; we version the graph and lazily recompute a
root's BFS tree when the graph has grown near it since the cache was filled.

This is deliberately plain Python over dict/list int structures first
(SURVEY.md §8 M1); the C++ host extension (M3) replaces the internals behind
the same interface.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple


class KeyframeGraph:
    """Append-only undirected multigraph of keyframes connected by kf2kf
    edges, with bounded-depth deterministic BFS spanning trees per root.

    Edge ``e`` is stored as ``(a, b)``; its pose unknown (held elsewhere, in
    the device SoA) is ``T_a<-b`` — walking the edge from ``a`` to ``b``
    composes the pose directly (sign +1), from ``b`` to ``a`` composes the
    inverse (sign -1).
    """

    def __init__(self, max_tree_depth: int = 4):
        self.max_tree_depth = int(max_tree_depth)
        self.num_kfs = 0
        self.edges: List[Tuple[int, int]] = []
        # adjacency[kf] = list of (neighbor, edge_id) in insertion order —
        # insertion order + kf id gives deterministic BFS tie-breaking.
        self.adjacency: List[List[Tuple[int, int]]] = []
        self._version = 0
        # root -> (version, dist map, parent map {node: (parent, edge_id)})
        self._bfs_cache: Dict[int, Tuple[int, Dict[int, int],
                                         Dict[int, Tuple[int, int]]]] = {}

    # -- construction -------------------------------------------------------

    def add_keyframe(self) -> int:
        kf_id = self.num_kfs
        self.num_kfs += 1
        self.adjacency.append([])
        return kf_id

    def add_edge(self, a: int, b: int) -> int:
        assert a != b, "self-edges are not allowed"
        assert 0 <= a < self.num_kfs and 0 <= b < self.num_kfs
        edge_id = len(self.edges)
        self.edges.append((a, b))
        self.adjacency[a].append((b, edge_id))
        self.adjacency[b].append((a, edge_id))
        self._version += 1
        self._bfs_cache.clear()  # lazy: recomputed per root on demand
        return edge_id

    # -- spanning-tree queries ---------------------------------------------

    def bfs_tree(self, root: int, max_depth: Optional[int] = None):
        """Deterministic BFS tree from ``root`` limited to ``max_depth``.

        Returns ``(dist, parent)`` where ``parent[n] = (parent_kf, edge_id)``
        for every reached ``n != root``.  Results for ``max_depth ==
        self.max_tree_depth`` are cached until the graph grows.
        """
        depth = self.max_tree_depth if max_depth is None else int(max_depth)
        cacheable = depth == self.max_tree_depth
        if cacheable:
            hit = self._bfs_cache.get(root)
            if hit is not None and hit[0] == self._version:
                return hit[1], hit[2]

        dist = {root: 0}
        parent: Dict[int, Tuple[int, int]] = {}
        q = deque([root])
        while q:
            n = q.popleft()
            d = dist[n]
            if d >= depth:
                continue
            for nb, eid in self.adjacency[n]:
                if nb not in dist:
                    dist[nb] = d + 1
                    parent[nb] = (n, eid)
                    q.append(nb)
        if cacheable:
            self._bfs_cache[root] = (self._version, dist, parent)
        return dist, parent

    def path(self, src: int, dst: int,
             max_depth: Optional[int] = None
             ) -> Optional[List[Tuple[int, int]]]:
        """Spanning-tree (shortest) path ``src -> dst`` as a list of
        ``(edge_id, sign)`` steps, or ``None`` if ``dst`` is beyond
        ``max_depth`` of ``src``.  ``sign=+1`` means the edge is traversed
        from its ``a`` endpoint to its ``b`` endpoint (pose used directly);
        ``-1`` means reversed (inverse pose).
        """
        if src == dst:
            return []
        dist, parent = self.bfs_tree(src, max_depth)
        if dst not in dist:
            return None
        steps: List[Tuple[int, int]] = []
        n = dst
        while n != src:
            p, eid = parent[n]
            a, _b = self.edges[eid]
            # Walking p -> n: direct if the stored edge runs (p, n).
            steps.append((eid, 1 if a == p else -1))
            n = p
        steps.reverse()
        return steps

    def distance(self, src: int, dst: int,
                 max_depth: Optional[int] = None) -> Optional[int]:
        """Hop count ``src -> dst`` over the bounded BFS tree, or ``None``
        if ``dst`` lies beyond ``max_depth``."""
        dist, _ = self.bfs_tree(src, max_depth)
        return dist.get(dst)

    def window(self, root: int, depth: int) -> List[int]:
        """All KFs within ``depth`` hops of ``root`` (the local-optimization
        window of ``optimize_local_area``), in deterministic BFS order."""
        dist, _ = self.bfs_tree(root, depth)
        return sorted(dist.keys(), key=lambda n: (dist[n], n))

    def complete_spanning_tree(self, root: int):
        """Unbounded BFS tree over the whole connected component — the analog
        of ``create_complete_spanning_tree`` (global map recovery)."""
        return self.bfs_tree(root, max_depth=self.num_kfs)

    # -- stats --------------------------------------------------------------

    @property
    def num_edges(self) -> int:
        return len(self.edges)
