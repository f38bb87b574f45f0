"""Host window build of the port against the JAX package: on the same
problem state, ``build_window`` gives bit-identical padded arrays and plans,
and ``write_back`` writes the same values (both are numpy, no tolerance)."""

import dataclasses

import numpy as np
import pytest
import torch

from srba_tpu import Observation as JObservation
from srba_tpu import SrbaEngine as JEngine
from srba_tpu import SrbaParams as JParams
from srba_tpu.solver import window as jwin
from srba_tpu.utils.datasets import make_world_loop_2d, observe
from srba_tpu_torch import convert
from srba_tpu_torch.graph.spantree import KeyframeGraph
from srba_tpu_torch.solver import window as twin

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_engine():
    """A 16-KF range-bearing map built by the JAX engine (no solves needed:
    only the topology and the host tables matter here)."""
    world = make_world_loop_2d(num_kfs=16, radius=6.0, num_landmarks=60,
                               seed=7)
    ds = observe(world, "RangeBearing2D", noise_std=0.005, sensor_range=5.0,
                 odo_noise_std=0.03, seed=7)
    eng = JEngine("RangeBearing2D",
                  params=JParams(max_tree_depth=3, max_optimize_depth=3),
                  device_master=False)
    for k, frame in enumerate(ds.frames):
        eng.define_new_keyframe(
            [JObservation(lm_id=m, z=z) for m, z in frame],
            run_local_optimization=False,
            edge_init={k - 1: ds.odometry[k - 1]} if k else None)
    return eng


def _port_graph(jgraph):
    g = KeyframeGraph(jgraph.max_tree_depth)
    for _ in range(jgraph.num_kfs):
        g.add_keyframe()
    for a, b in jgraph.edges:
        g.add_edge(a, b)
    return g


def _assert_same(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("root,depth,gather,cap", [
    (15, 3, True, None), (15, 2, False, None), (8, 3, True, 2),
    (3, 1, False, None), (0, 3, True, None)])
def test_build_window_bit_identical(jax_engine, root, depth, gather, cap):
    st = convert.problem_state_from_jax(jax_engine.state)
    g = _port_graph(jax_engine.graph)
    ref = jwin.build_window(jax_engine.state, jax_engine.graph, root, depth,
                            3, extra_obs_per_lm_cap=cap,
                            gather_floats=gather)
    out = twin.build_window(st, g, root, depth, 3, extra_obs_per_lm_cap=cap,
                            gather_floats=gather)
    assert (ref is None) == (out is None)
    if ref is None:
        return
    for r, o in zip(ref, out):
        _assert_same(r, o)


def test_write_back_matches(jax_engine):
    st_j = convert.problem_state_from_jax(jax_engine.state)
    st_t = convert.problem_state_from_jax(jax_engine.state)
    arrays, plan = twin.build_window(st_t, _port_graph(jax_engine.graph),
                                     15, 3, 3)
    rng = np.random.default_rng(0)
    ep = arrays.edge_pose + rng.normal(0, 0.01, arrays.edge_pose.shape)
    ls = arrays.lm_state + rng.normal(0, 0.01, arrays.lm_state.shape)
    jwin.write_back(st_j, plan, ep.astype(np.float32), ls.astype(np.float32))
    twin.write_back(st_t, plan, ep.astype(np.float32), ls.astype(np.float32))
    np.testing.assert_array_equal(st_j.k2k_pose, st_t.k2k_pose)
    np.testing.assert_array_equal(st_j.lm_state, st_t.lm_state)


def test_bucket_ladder_unchanged():
    for n in (0, 1, 8, 9, 63, 64, 65, 256, 257, 5000):
        assert twin._bucket(n, 8) == jwin._bucket(n, 8)
        assert twin._bucket(n, 64) == jwin._bucket(n, 64)
