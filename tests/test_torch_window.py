"""Host window build of the port against the JAX package: on the same
problem state, ``build_window`` gives bit-identical padded arrays and plans,
and ``write_back`` writes the same values (both are numpy, no tolerance) —
on an SE(2) range-bearing map, an SE(3)/Euclidean3D map (7-wide pose rows;
pad slots copy slot 0, so no zero quaternion) and a graph-SLAM map whose
closure edges make the keyframe graph cyclic.  The JAX state carried across
by ``convert`` (problem state, window batch) keeps its widths."""

import dataclasses

import numpy as np
import pytest
import torch

from srba_tpu import Observation as JObservation
from srba_tpu import SrbaEngine as JEngine
from srba_tpu import SrbaParams as JParams
from srba_tpu.solver import window as jwin
from srba_tpu.utils.datasets import (make_graph_slam_dataset,
                                     make_world_loop_2d, make_world_loop_3d,
                                     observe)
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


@pytest.fixture(scope="module", params=["RangeBearing3D", "RelativePoses2D"])
def jax_engine_wide(request):
    """A 16-KF SE(3) range-bearing map, or a 30-KF graph-SLAM map with
    closure edges, built by the JAX engine (no solves)."""
    model = request.param
    if model == "RangeBearing3D":
        world = make_world_loop_3d(num_kfs=16, radius=6.0, num_landmarks=80,
                                   seed=2)
        ds = observe(world, model, noise_std=0.005, sensor_range=5.0,
                     odo_noise_std=0.02, seed=2)
    else:
        world = make_world_loop_2d(num_kfs=30, radius=3.0, num_landmarks=1,
                                   seed=5, revolutions=2.0)
        ds = make_graph_slam_dataset(world, noise_std=0.002,
                                     loop_closure_range=1.5,
                                     odo_noise_std=0.01, seed=5)
    eng = JEngine(model, params=JParams(max_tree_depth=3,
                                        max_optimize_depth=3),
                  device_master=False)
    for k, frame in enumerate(ds.frames):
        eng.define_new_keyframe(
            [JObservation(lm_id=m, z=z) for m, z in frame],
            run_local_optimization=False,
            edge_init={k - 1: ds.odometry[k - 1]} if k else None)
    return eng


@pytest.mark.parametrize("root,depth,gather,cap", [
    (15, 3, True, None), (15, 2, False, None), (8, 3, True, 2),
    (3, 1, True, None)])
def test_build_window_bit_identical_se3_and_graph_slam(jax_engine_wide, root,
                                                       depth, gather, cap):
    eng = jax_engine_wide
    if eng.model.is_pose_landmark:
        # The graph is cyclic: closure edges beyond the chain exist.
        assert eng.state.num_edges > eng.state.num_kfs - 1
        root = root + 14       # on the second revolution
    st = convert.problem_state_from_jax(eng.state)
    assert (st.pose_dim, st.lm_dim, st.z_dim) == \
        (eng.state.pose_dim, eng.state.lm_dim, eng.state.z_dim)
    g = _port_graph(eng.graph)
    ref = jwin.build_window(eng.state, eng.graph, root, depth, 3,
                            extra_obs_per_lm_cap=cap, gather_floats=gather)
    out = twin.build_window(st, g, root, depth, 3, extra_obs_per_lm_cap=cap,
                            gather_floats=gather)
    assert ref is not None and out is not None
    for r, o in zip(ref, out):
        _assert_same(r, o)
    arrays = out[0]
    if gather and eng.group.name == "SE3":
        q = arrays.edge_pose[:, 3:]
        np.testing.assert_allclose(np.linalg.norm(q, axis=-1), 1.0,
                                   atol=1e-6)   # pad rows copy slot 0


def test_window_batch_converts_at_se3_width(jax_engine_wide):
    """A JAX ``WindowBatch`` of a wide window crosses into the port with
    every field's shape, dtype and value."""
    import jax.numpy as jnp
    from srba_tpu.solver import lm as jlm
    eng = jax_engine_wide
    arrays, _ = jwin.build_window(eng.state, eng.graph,
                                  eng.state.num_kfs - 1, 3, 3)
    dim = eng.group.dim
    jb = jlm.WindowBatch(
        edge_pose=jnp.asarray(arrays.edge_pose),
        edge_opt=jnp.asarray(arrays.edge_opt),
        lm_state=jnp.asarray(arrays.lm_state),
        lm_opt=jnp.asarray(arrays.lm_opt), obs_z=jnp.asarray(arrays.obs_z),
        obs_lm=jnp.asarray(arrays.obs_lm),
        path_edge=jnp.asarray(arrays.path_edge),
        path_sign=jnp.asarray(arrays.path_sign),
        obs_valid=jnp.asarray(arrays.obs_valid),
        whitener=jnp.asarray(eng._whitener),
        sensor_pose_inv=jnp.asarray(eng._sensor_pose_inv),
        edge_prior=jnp.asarray(arrays.edge_prior),
        edge_prior_w=jnp.asarray(arrays.edge_prior_w),
        iters_cap=jnp.asarray(3, jnp.int32))
    tb = convert.window_batch_from_jax(jb, device="cpu")
    assert tb.edge_pose.shape[1] == tb.edge_prior.shape[1] == dim
    assert tb.sensor_pose_inv.shape == (dim,) and tb.iters_cap == 3
    for f in dataclasses.fields(tb):
        v = getattr(tb, f.name)
        if isinstance(v, torch.Tensor):
            ref = np.asarray(getattr(jb, f.name))
            assert v.numpy().dtype == ref.dtype, f.name
            np.testing.assert_array_equal(v.numpy(), ref, err_msg=f.name)
