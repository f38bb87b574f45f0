"""Edge-creation policies and the bounded graph distance of the port against
the JAX package: ``KeyframeGraph.distance`` and
``LocalAreasFixedGrid.edges_for_new_kf`` (with its ``_needs_closure`` gate)
on the same seeded graphs and landmark tables, compared exactly — pure
integer host logic, so the outputs must be identical."""

import numpy as np
import pytest

from srba_tpu import ecps as jecps
from srba_tpu.engine.state import ProblemState as JState
from srba_tpu.graph.spantree import KeyframeGraph as JGraph
from srba_tpu_torch import ecps as tecps
from srba_tpu_torch.engine.state import ProblemState as TState
from srba_tpu_torch.graph.spantree import KeyframeGraph as TGraph


def _graphs(K=60, extra=12, depth=4, seed=0):
    """The same graph in both packages: a chain of K keyframes plus
    ``extra`` random long-range edges."""
    rng = np.random.default_rng(seed)
    gj, gt = JGraph(depth), TGraph(depth)
    for k in range(K):
        gj.add_keyframe()
        gt.add_keyframe()
        if k:
            gj.add_edge(k, k - 1)
            gt.add_edge(k, k - 1)
    for _ in range(extra):
        a, b = rng.choice(K, 2, replace=False)
        gj.add_edge(int(a), int(b))
        gt.add_edge(int(a), int(b))
    return gj, gt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_distance_matches_jax(seed):
    gj, gt = _graphs(seed=seed)
    rng = np.random.default_rng(100 + seed)
    for _ in range(200):
        a, b = (int(x) for x in rng.integers(0, gj.num_kfs, 2))
        for depth in (None, 1, 2, 3, 6, gj.num_kfs):
            assert gt.distance(a, b, depth) == gj.distance(a, b, depth), \
                (a, b, depth)
    assert gt.distance(5, 5) == 0
    assert gt.distance(0, 40, 3) is None


def _policy_run(submap, min_obs, K=80, M=150, seed=0):
    """Feed both policies the same growing map: each new keyframe links
    where the JAX policy says and sees a random set of existing landmarks
    (bases spread over all earlier keyframes), so foreign areas get
    votes."""
    rng = np.random.default_rng(seed)
    pj = jecps.LocalAreasFixedGrid(submap, min_obs)
    pt = tecps.LocalAreasFixedGrid(submap, min_obs)
    assert (pt.name, pt.submap_size, pt.min_obs_count_loop_closure) == \
        (pj.name, pj.submap_size, pj.min_obs_count_loop_closure)
    sj = JState(pose_dim=3, lm_dim=2, z_dim=2)
    st = TState(pose_dim=3, lm_dim=2, z_dim=2)
    gj, gt = JGraph(4), TGraph(4)
    outs = []
    for k in range(K):
        for s in (sj, st):
            s.add_keyframe()
        gj.add_keyframe()
        gt.add_keyframe()
        n_lms = sj.num_lms
        obs = (sorted(rng.choice(n_lms, min(n_lms, 25), replace=False)
                      .tolist()) if n_lms else [])
        oj = pj.edges_for_new_kf(sj, gj, k, obs)
        ot = pt.edges_for_new_kf(st, gt, k, obs)
        assert ot == oj, k
        outs.append(ot)
        for tgt in oj[0] + oj[1]:
            gj.add_edge(k, tgt)
            gt.add_edge(k, tgt)
        for _ in range(2):
            base = int(rng.integers(0, k + 1))
            for s in (sj, st):
                s.add_landmark(base, np.zeros(2, np.float32))
    return outs


@pytest.mark.parametrize("submap,min_obs", [(8, 4), (10, 5), (5, 2)])
def test_local_areas_fixed_grid_matches_jax(submap, min_obs):
    outs = _policy_run(submap, min_obs, seed=submap)
    assert outs[0] == ([], [])
    # Every keyframe gets exactly one primary link: its area center, or the
    # previous center for a new center.
    for k, (primary, _) in enumerate(outs[1:], start=1):
        c = (k // submap) * submap
        assert primary == ([c - submap] if k == c else [c])
    # Closures were voted (the gate let some through).
    assert sum(len(c) for _, c in outs) > 0


def test_needs_closure_matches_jax():
    gj, gt = _graphs(K=50, extra=6, seed=3)
    for a in range(0, 50, 3):
        for c in range(0, 50, 5):
            assert tecps._needs_closure(gt, a, c) == \
                jecps._needs_closure(gj, a, c)


def test_ecp_registry():
    assert set(tecps.ECPS) == {"classic_linear_rba",
                               "local_areas_fixed_grid"}
    assert set(tecps.ECPS) < set(jecps.ECPS)
