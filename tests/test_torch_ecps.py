"""Edge-creation policies and the bounded graph distance of the port against
the JAX package: ``KeyframeGraph.distance``,
``LocalAreasFixedGrid.edges_for_new_kf`` (with its ``_needs_closure`` gate)
and the adaptive ``LocalAreasVar1`` on the same seeded graphs and landmark
tables, compared exactly — pure integer host logic, so the outputs must be
identical.  Then the twins of tests/test_ecps.py's three engine tests of
``LocalAreasVar1`` (its checkpoint round trip waits for the port's
checkpoint module), its areas and edges against the JAX engine's on the
same two-revolution run (identical: the policy reads only integers, and
the closure fits on this scenario are decisive), and its
``get_state``/``set_state`` round trip."""

import numpy as np
import pytest
import torch

import srba_tpu as J
from srba_tpu import ecps as jecps
from srba_tpu.engine.state import ProblemState as JState
from srba_tpu.graph.spantree import KeyframeGraph as JGraph
from srba_tpu.utils import datasets as jds
import srba_tpu_torch as T
from srba_tpu_torch import convert
from srba_tpu_torch import ecps as tecps
from srba_tpu_torch.engine.state import ProblemState as TState
from srba_tpu_torch.graph.spantree import KeyframeGraph as TGraph
from srba_tpu_torch.utils import datasets as tds

torch.set_num_threads(1)


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


def _policy_run(submap, min_obs, K=80, M=150, seed=0, pj=None, pt=None):
    """Feed both policies (default: the fixed grid) the same growing map:
    each new keyframe links where the JAX policy says and sees a random
    set of existing landmarks (bases spread over all earlier keyframes),
    so foreign areas get votes."""
    rng = np.random.default_rng(seed)
    if pj is None:
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
                               "local_areas_fixed_grid", "local_areas_var1"}
    assert set(tecps.ECPS) == set(jecps.ECPS)


# -- LocalAreasVar1 ----------------------------------------------------------

@pytest.mark.parametrize("join,min_obs,seed", [(3, 4, 0), (2, 3, 1),
                                               (5, 6, 2)])
def test_local_areas_var1_policy_matches_jax(join, min_obs, seed):
    """The adaptive policy on the random growing map of ``_policy_run``:
    identical targets, centers, areas and state at every keyframe."""
    pj = jecps.LocalAreasVar1(join, min_obs)
    pt = tecps.LocalAreasVar1(join, min_obs)
    outs = _policy_run(None, None, seed=seed, pj=pj, pt=pt)
    assert pt.get_state() == pj.get_state()
    assert pt.centers == pj.centers and len(pt.centers) >= 1
    assert all(len(p) == 1 for p, _ in outs[1:])
    with pytest.raises(ValueError, match="every keyframe"):
        pt.edges_for_new_kf(None, None, 3, [])


def _var1_run(pkg, dsm, ecp, K=80, revolutions=2.0, **kw):
    """tests/test_ecps.py's ``_run``: 2D range-bearing loop, 120
    landmarks, odometry noise 0.02."""
    world = dsm.make_world_loop_2d(num_kfs=K, radius=6.0, num_landmarks=120,
                                   seed=9, revolutions=revolutions)
    ds = dsm.observe(world, "RangeBearing2D", noise_std=0.003,
                     sensor_range=4.5, odo_noise_std=0.02, seed=9)
    eng = pkg.SrbaEngine(
        "RangeBearing2D", ecp=ecp,
        params=pkg.SrbaParams(max_tree_depth=4, max_optimize_depth=3), **kw)
    for k, frame in enumerate(ds.frames):
        eng.define_new_keyframe(
            [pkg.Observation(lm_id=m, z=z) for m, z in frame],
            edge_init={k - 1: ds.odometry[k - 1]} if k else None)
    G, _ = eng.create_complete_spanning_tree(0)
    n = min(len(G), len(world.gt_poses))
    return float(dsm.ate_rmse(G[:n, :2], world.gt_poses[:n, :2])), eng


@pytest.fixture(scope="module")
def var1_runs():
    """The two-revolution run under LocalAreasVar1(3, 4) in the port and in
    the JAX package."""
    return (_var1_run(T, tds, tecps.LocalAreasVar1(3, 4), device="cpu"),
            _var1_run(J, jds, jecps.LocalAreasVar1(3, 4)))


def test_var1_adaptive_areas_differ_from_fixed_grid(var1_runs):
    """Revolution 2 re-enters known territory, so the adaptive policy JOINS
    existing areas (no new centers), unlike the fixed grid."""
    K = 80
    ate, eng = var1_runs[0]
    centers = eng.ecp.centers
    assert centers != list(range(0, K, 10))
    late_centers = [c for c in centers if c >= K // 2]
    assert len(late_centers) <= 1, (
        f"revisit opened {late_centers} — assignment is not adaptive")
    assert len(eng.ecp._kf_area) == K
    n_closures = eng.state.num_edges - (K - 1)
    assert n_closures >= 1
    assert ate < 0.5, ate


def test_var1_run_matches_jax(var1_runs):
    """Identical centers, keyframe areas, area snapshots and edge lists;
    the ATEs agree at 1e-3 m (the e2e parity tolerance)."""
    (ate_t, et), (ate_j, ej) = var1_runs
    assert et.ecp.centers == ej.ecp.centers
    assert et.ecp._kf_area == ej.ecp._kf_area
    assert et.ecp.get_state() == ej.ecp.get_state()
    st, sj = et.get_rba_state(), ej.get_rba_state()
    n = st.num_edges
    assert n == sj.num_edges
    np.testing.assert_array_equal(st.k2k_from[:n], sj.k2k_from[:n])
    np.testing.assert_array_equal(st.k2k_to[:n], sj.k2k_to[:n])
    assert abs(ate_t - ate_j) < 1e-3


def test_fixed_grid_keeps_minting_centers():
    """Contrast case: the grid policy's area centers are exactly the
    submap_size multiples even on pure re-visit."""
    K = 80
    ate, eng = _var1_run(T, tds, tecps.LocalAreasFixedGrid(
        submap_size=10, min_obs_count_loop_closure=4), K=K, device="cpu")
    for kf in range(K):
        assert eng.ecp.center_of(kf) == (kf // 10) * 10
    assert ate < 0.35, ate


def test_var1_new_territory_opens_area():
    """A single revolution: multiple areas open, and every keyframe's area
    center is a keyframe at or before it."""
    ate, eng = _var1_run(T, tds, tecps.LocalAreasVar1(), K=40,
                         revolutions=1.0, device="cpu")
    assert len(eng.ecp.centers) >= 2
    for kf in range(40):
        assert 0 <= eng.ecp.area_of_kf(kf) <= kf
    assert ate < 0.5, ate


def test_var1_state_round_trip(var1_runs):
    """``get_state``/``set_state`` (the checkpoint format) carry the policy
    across, within the port and from the JAX package: the restored policy
    answers the next keyframe as the original does."""
    (_, et), (_, ej) = var1_runs
    restored = tecps.LocalAreasVar1(3, 4)
    restored.set_state(et.ecp.get_state())
    assert restored.get_state() == et.ecp.get_state()
    carried = convert.ecp_from_jax(ej.ecp)
    assert type(carried) is tecps.LocalAreasVar1
    assert carried.get_state() == ej.ecp.get_state()
    assert carried.min_obs_to_join == 3
    lms = list(range(0, et.num_landmarks, 3))
    K = et.num_keyframes
    want = ej.ecp.edges_for_new_kf(ej.state, ej.graph, K, lms)
    for pol in (restored, carried):
        assert pol.edges_for_new_kf(et.state, et.graph, K, lms) == want
    assert restored.get_state() == carried.get_state()
