"""The port's multi-process paths (``srba_tpu_torch.parallel.multihost``) on
a real two-rank gloo ring on this CPU, the twins of tests/test_multihost.py
(which runs them as JAX processes and is ``slow``), plus the window-sharded
sweep of ``__graft_entry__.dryrun_multichip``.

One ring (two processes, ``jax`` blocked in each) runs, in order:

* ``MultiHostEngine`` on tests/test_multihost.py's 12-keyframe
  RangeBearing2D loop (rank 0 feeds and ``stop()``s, rank 1 ``serve()``s)
  with ``broadcast_batch`` 1, 4 and 5 (the last replayed with direct
  ``define_new_keyframe()`` calls on rank 1, its final round two keyframes
  and the stop);
* the edge-sharded PGO of tests/test_multihost.py's 40-node SE(3) ring
  (``optimize_global_pose_graph(mesh=...)``);
* ``refine_map(sweeps=2, stride=3, mesh=...)`` on dryrun_multichip's
  24-keyframe world built from raw odometry.

Held to: the replicas bitwise equal; the engine against the JAX package's
single-process host-window engine (ATE abs 2e-3, as tests/test_multihost.py)
and against the port's (ATE abs 2e-3, tables atol 1e-3: the ranks' sums
round otherwise than one device's); batch 4 and 5 bitwise batch 1; the PGO
against JAX's single-process solve (``err_final`` rel 1e-3, sum of |nodes|
rel 1e-4); the sweep against the port's single-device ``refine_map`` (map
error rel 1.7e-4, PERF.md's level of agreement between the card and the
CPU) and against JAX's ``refine_map(mesh=make_mesh(2))`` (rel 1e-3,
tests/test_refine_map.py's mesh-against-one-device tolerance: on this world
the JAX package's own two- and four-device sweeps end 9.5e-5 apart, the
port's and JAX's single-device sweeps 1.45e-4, the port's ring and JAX's
two devices 2.4e-4), and under 1.0 as the dry run asserts; ``stop()``
returning its tail's infos.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_sharding import leave_ring, join_ring, run_ring

torch.set_num_threads(1)

KFS = 12
BATCHES = (1, 4, 5)
PARAMS = dict(max_tree_depth=3, max_optimize_depth=3)


def _engine_data(tds):
    world = tds.make_world_loop_2d(num_kfs=KFS, radius=6.0, num_landmarks=40,
                                   seed=5)
    ds = tds.observe(world, "RangeBearing2D", noise_std=0.005,
                     sensor_range=5.0, odo_noise_std=0.01, seed=5)
    return world, ds


def _sweep_data(tds):
    world = tds.make_world_loop_2d(num_kfs=24, radius=8.0, num_landmarks=50,
                                   seed=1)
    ds = tds.observe(world, "RangeBearing2D", noise_std=0.005,
                     sensor_range=6.0, odo_noise_std=0.02, seed=1)
    return world, ds


def _pgo_problem():
    """tests/test_multihost.py's 40-node SE(3) ring (numpy only)."""
    from srba_tpu_torch.ops.np_lie import NpSE3

    rng = np.random.default_rng(0)
    K = 40
    th = 2 * np.pi * np.arange(K) / K
    gt = np.stack([NpSE3.pexp(np.asarray(
        [5 * np.cos(t), 5 * np.sin(t), 0, 0, 0, t], np.float32))
        for t in th])

    def rel(i, j):
        return NpSE3.compose(NpSE3.inverse(gt[i]), gt[j]).astype(np.float32)

    edges = [{"from": k - 1, "to": k, "rel_pose": NpSE3.retract(
        rel(k - 1, k), rng.normal(0, 0.01, 6).astype(np.float32))}
        for k in range(1, K)]
    edges.append({"from": 0, "to": K - 1, "rel_pose": rel(0, K - 1)})
    nodes = np.stack([NpSE3.retract(
        gt[k], rng.normal(0, 0.1, 6).astype(np.float32)) for k in range(K)])
    nodes[0] = gt[0]
    return {"group": "SE3", "nodes": nodes, "edges": edges}


def _feed(eng, Observation, ds, run_local=True):
    """bench.py's feed: each frame's observations, odometry edge seeds."""
    out = []
    for k, frame in enumerate(ds.frames):
        out.append(eng.define_new_keyframe(
            [Observation(lm_id=m, z=z) for m, z in frame],
            edge_init={k - 1: ds.odometry[k - 1]} if k else None,
            **({} if run_local else {"run_local_optimization": False})))
    return out


def ring_worker(rank, nprocs, store, out):
    import srba_tpu_torch as port
    from srba_tpu_torch.models.noise import NoiseIdentity
    from srba_tpu_torch.parallel import multihost as mh
    from srba_tpu_torch.solver.global_graphslam import (
        PGOConfig, optimize_global_pose_graph)
    from srba_tpu_torch.utils import datasets as tds

    mesh = join_ring(rank, nprocs, store)
    res = {}
    world, ds = _engine_data(tds)
    for B in BATCHES:
        eng = mh.MultiHostEngine(
            "RangeBearing2D", noise=NoiseIdentity(0.005), mesh=mesh,
            broadcast_batch=B, params=port.SrbaParams(**PARAMS),
            device="cpu")
        if mh.is_coordinator():
            _feed(eng, port.Observation, ds)
            tail = eng.stop()
            res[f"b{B}_tail_kfs"] = np.asarray([i.kf_id for i in tail])
        elif B == 5:
            served = []
            while not eng.stopped:
                got = eng.define_new_keyframe()
                served.append([i.kf_id for i in got])
            res["b5_rounds"] = np.asarray([len(r) for r in served])
            res["b5_tail_kfs"] = np.asarray(served[-1])
            res["b5_served"] = sum(len(r) for r in served)
        else:
            res[f"b{B}_served"] = eng.serve()
        G, _ = eng.create_complete_spanning_tree(0)
        res[f"b{B}_ate"] = tds.ate_rmse(G[:, :2], world.gt_poses[:, :2])
        res[f"b{B}_num_kfs"] = eng.num_keyframes
        st = eng.get_rba_state()
        res[f"b{B}_edges"] = st.k2k_pose[: st.num_edges]
        res[f"b{B}_lms"] = st.lm_state[: st.num_lms]

    G, info = optimize_global_pose_graph(
        _pgo_problem(), PGOConfig(group="SE3", max_outer=15, cg_iters=50),
        mesh=mesh, device="cpu")
    res["pgo_nodes"] = G
    res.update({f"pgo_{k}": v for k, v in info.items()})

    world, ds = _sweep_data(tds)
    eng = port.SrbaEngine("RangeBearing2D",
                          params=port.SrbaParams(**PARAMS), device="cpu")
    _feed(eng, port.Observation, ds, run_local=False)
    res["sweep_e0"] = eng.eval_overall_squared_error()
    info = eng.refine_map(sweeps=2, stride=3, mesh=mesh)
    res["sweep_e1"] = eng.eval_overall_squared_error()
    res["sweep_windows"] = info["windows"]
    res["sweep_pose"] = eng.device_master.pose.numpy()
    res["sweep_lm"] = eng.device_master.lm.numpy()
    np.savez(f"{out}.{rank}.npz", **res)
    leave_ring()


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    return run_ring("tests.test_torch_multihost:ring_worker", 2,
                    tmp_path_factory.mktemp("ring"))


def _replicas_equal(ring, prefix):
    keys = [k for k in ring[0] if k.startswith(prefix)
            and k not in (f"{prefix}tail_kfs", f"{prefix}served",
                          f"{prefix}rounds")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(ring[0][k], ring[1][k], err_msg=k)


def test_engine_ring_matches_single_process(ring):
    """The keyframe broadcast and the observation-sharded window solves:
    12 keyframes served, replicas bitwise equal, the ATE of the JAX
    package's and the port's single-process host-window engines."""
    from srba_tpu import Observation as JObservation
    from srba_tpu import SrbaEngine as JEngine
    from srba_tpu import SrbaParams as JParams
    from srba_tpu.models.noise import NoiseIdentity as JNoise
    from srba_tpu.utils.datasets import ate_rmse as jate_rmse

    import srba_tpu_torch as port
    from srba_tpu_torch.models.noise import NoiseIdentity
    from srba_tpu_torch.utils import datasets as tds

    assert int(ring[1]["b1_served"]) == KFS
    assert all(int(r["b1_num_kfs"]) == KFS for r in ring)
    _replicas_equal(ring, "b1_")
    ate = float(ring[0]["b1_ate"])

    world, ds = _engine_data(tds)
    jeng = JEngine("RangeBearing2D", device_master=False,
                   noise=JNoise(0.005), params=JParams(**PARAMS))
    _feed(jeng, JObservation, ds)
    G, _ = jeng.create_complete_spanning_tree(0)
    assert ate == pytest.approx(
        float(jate_rmse(G[:, :2], world.gt_poses[:, :2])), abs=2e-3)
    assert ate < 0.05

    teng = port.SrbaEngine("RangeBearing2D", device_master=False,
                           noise=NoiseIdentity(0.005),
                           params=port.SrbaParams(**PARAMS), device="cpu")
    _feed(teng, port.Observation, ds)
    G, _ = teng.create_complete_spanning_tree(0)
    assert ate == pytest.approx(
        float(tds.ate_rmse(G[:, :2], world.gt_poses[:, :2])), abs=2e-3)
    st = teng.get_rba_state()
    np.testing.assert_allclose(ring[0]["b1_edges"],
                               st.k2k_pose[: st.num_edges], atol=1e-3)
    np.testing.assert_allclose(ring[0]["b1_lms"], st.lm_state[: st.num_lms],
                               atol=1e-3)


@pytest.mark.parametrize("batch", [4, 5])
def test_batched_broadcast_is_bitwise_unbatched(ring, batch):
    """broadcast_batch > 1 replays the same keyframes in the same order:
    the same maps, bit for bit."""
    b = f"b{batch}_"
    assert int(ring[1][b + "served"]) == KFS
    _replicas_equal(ring, b)
    for k in ("edges", "lms", "ate", "num_kfs"):
        np.testing.assert_array_equal(ring[0][b + k], ring[0]["b1_" + k])


def test_stop_returns_the_tail_infos(ring):
    """12 keyframes in rounds of 5: stop() ships the last two with the stop
    record and returns their infos; the other rank's call that receives
    that round returns them too (the JAX package's stop() drops them)."""
    assert ring[0]["b5_tail_kfs"].tolist() == [10, 11]
    assert ring[1]["b5_tail_kfs"].tolist() == [10, 11]
    assert ring[1]["b5_rounds"].tolist() == [5, 5, 2]
    assert ring[0]["b4_tail_kfs"].tolist() == []
    assert ring[0]["b1_tail_kfs"].tolist() == []


def test_edge_sharded_pgo_matches_single_process(ring):
    from srba_tpu.solver.global_graphslam import (PGOConfig,
                                                  optimize_global_pose_graph)

    _replicas_equal(ring, "pgo_")
    G, info = optimize_global_pose_graph(
        _pgo_problem(), PGOConfig(group="SE3", max_outer=15, cg_iters=50))
    assert float(ring[0]["pgo_err_final"]) == pytest.approx(
        info["err_final"], rel=1e-3, abs=1e-6)
    assert float(np.abs(ring[0]["pgo_nodes"]).sum()) == pytest.approx(
        float(np.abs(G).sum()), rel=1e-4)
    assert float(ring[0]["pgo_converged"]) == 1.0


def test_window_sharded_sweep_matches_jax(ring):
    """dryrun_multichip's sweep: the port on two ranks against the port on
    one device and the JAX package on a two-device mesh."""
    from srba_tpu import Observation as JObservation
    from srba_tpu import SrbaEngine as JEngine
    from srba_tpu import SrbaParams as JParams
    from srba_tpu.parallel.sharding import make_mesh
    from srba_tpu.utils import datasets as jds

    import srba_tpu_torch as port
    from srba_tpu_torch.utils import datasets as tds

    _replicas_equal(ring, "sweep_")
    got = float(ring[0]["sweep_e1"])
    world, ds = _sweep_data(tds)
    teng = port.SrbaEngine("RangeBearing2D",
                           params=port.SrbaParams(**PARAMS), device="cpu")
    _feed(teng, port.Observation, ds, run_local=False)
    tinfo = teng.refine_map(sweeps=2, stride=3)
    assert got == pytest.approx(teng.eval_overall_squared_error(),
                                rel=1.7e-4)

    world, ds = _sweep_data(jds)
    jeng = JEngine("RangeBearing2D", params=JParams(**PARAMS))
    _feed(jeng, JObservation, ds, run_local=False)
    e0 = jeng.eval_overall_squared_error()
    info = jeng.refine_map(sweeps=2, stride=3, mesh=make_mesh(2))
    e1 = jeng.eval_overall_squared_error()
    assert float(ring[0]["sweep_e0"]) == pytest.approx(e0, rel=1e-5)
    assert float(ring[0]["sweep_windows"]) == info["windows"] \
        == tinfo["windows"]
    assert got == pytest.approx(e1, rel=1e-3)
    assert np.isfinite(got) and got < 1.0


def test_keyframe_codec_matches_jax():
    """The wire record of a keyframe is the JAX package's, field for
    field; decoding it gives the port's Observations back."""
    from srba_tpu import Observation as JObservation
    from srba_tpu.parallel.multihost import KeyframeCodec as JCodec

    import srba_tpu_torch as port
    from srba_tpu_torch.parallel.multihost import KeyframeCodec

    z = [np.asarray([1.0 + i, 0.1 * i], np.float32) for i in range(3)]
    rel = np.asarray([0.5, -0.25], np.float32)
    kw = [dict(), dict(fixed_rel_pos=rel), dict(init_rel_pos=rel)]
    t_obs = [port.Observation(lm_id=7 + i, z=z[i], **kw[i]) for i in range(3)]
    j_obs = [JObservation(lm_id=7 + i, z=z[i], **kw[i]) for i in range(3)]
    edge_init = {4: np.asarray([0.1, 0.0, 0.2], np.float32)}
    codec = KeyframeCodec(z_dim=2, lm_dim=2, pose_dim=3, max_obs=8,
                          max_init_edges=2)
    jcodec = JCodec(z_dim=2, lm_dim=2, pose_dim=3, max_obs=8,
                    max_init_edges=2)
    msg = codec.encode(t_obs, edge_init, run_opt=False)
    jmsg = jcodec.encode(j_obs, edge_init, run_opt=False)
    assert msg.keys() == jmsg.keys()
    for k in msg:
        assert np.asarray(msg[k]).dtype == np.asarray(jmsg[k]).dtype, k
        np.testing.assert_array_equal(msg[k], jmsg[k], err_msg=k)
    obs, e_init, run_opt, stop = codec.decode(msg)
    assert (run_opt, stop) == (False, False)
    assert all(type(o) is port.Observation for o in obs)
    assert [o.lm_id for o in obs] == [7, 8, 9]
    assert obs[0].fixed_rel_pos is None and obs[0].init_rel_pos is None
    np.testing.assert_array_equal(obs[1].fixed_rel_pos, rel)
    np.testing.assert_array_equal(obs[2].init_rel_pos, rel)
    np.testing.assert_array_equal(e_init[4], edge_init[4])
    assert codec.decode(codec.encode([], None, False, stop=True))[3]
    with pytest.raises(ValueError, match="max_obs"):
        codec.encode(t_obs * 3, None, True)


def test_broadcast_and_initialize_on_one_rank():
    """On a world of one rank the broadcast hands back the record (int32
    and float32 leaves, two packed tensors); other dtypes and a
    multi-process world without its address are refused."""
    from srba_tpu_torch.parallel import multihost as mh
    from tests.test_torch_sharding import one_rank_mesh

    one_rank_mesh()
    rec = {"n": np.int32(3), "ids": np.arange(4, dtype=np.int32),
           "z": np.full((2, 3), 0.5, np.float32)}
    out = mh.broadcast_from_coordinator(rec)
    assert list(out) == list(rec)
    for k in rec:
        assert out[k].dtype == np.asarray(rec[k]).dtype
        np.testing.assert_array_equal(out[k], rec[k])
    with pytest.raises(ValueError, match="int32 and float32"):
        mh.broadcast_from_coordinator({"x": np.zeros(2, np.float64)})
    assert (mh.process_index(), mh.process_count(),
            mh.is_coordinator()) == (0, 1, True)
    mh.sync_processes()
    mh.initialize()          # a process group exists: nothing changes
    assert mh.process_count() == 1
    with pytest.raises(ValueError, match="coordinator_address"):
        mh.initialize("localhost:29500", num_processes=2)
