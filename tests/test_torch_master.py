"""Device-master step of the port against the JAX package: three consecutive
per-keyframe steps fed the same staged rows and window arrays (the JAX
engine drives; each of its ``DeviceMaster.step`` calls is mirrored into the
port's ``DeviceMaster``, which starts from the JAX masters), then the
masters and infos compared — for SE(2) range-bearing, for SE(3)
range-bearing (7-wide pose rows) and for graph-SLAM (pose landmarks); plus
the master bookkeeping (lazy infos, capacity growth, prefetch-backed mirror
sync).

Tolerances: masters at atol 1e-4 (m / rad; one window solve's f32 rounding,
the solver tests' delta tolerance); errors at rtol 1e-4; ``iters``, ``lam``
and ``num_obs`` exactly — ``rel_tol=0.3`` makes every stop decision
decisive (see tests/test_torch_solver.py).
"""

import numpy as np
import pytest
import torch

from srba_tpu import Observation as JObservation
from srba_tpu import SrbaEngine as JEngine
from srba_tpu import SrbaParams as JParams
from srba_tpu.models.noise import NoiseIdentity
from srba_tpu.solver import master as jmaster
from srba_tpu.utils.datasets import (make_graph_slam_dataset,
                                     make_world_loop_2d, make_world_loop_3d,
                                     observe)
from srba_tpu_torch import convert
from srba_tpu_torch.engine.device_master import DeviceMaster, LazyInfo
from srba_tpu_torch.solver import master as tmaster

torch.set_num_threads(1)

MASTER_ATOL, ERR_RTOL = 1e-4, 1e-4


def _frames(model="RangeBearing2D"):
    if model == "RangeBearing2D":
        world = make_world_loop_2d(num_kfs=12, radius=6.0, num_landmarks=60,
                                   seed=3)
        ds = observe(world, model, noise_std=0.005, sensor_range=5.0,
                     odo_noise_std=0.03, seed=3)
    elif model == "RangeBearing3D":
        world = make_world_loop_3d(num_kfs=12, radius=6.0, num_landmarks=80,
                                   seed=3)
        ds = observe(world, model, noise_std=0.005, sensor_range=5.0,
                     odo_noise_std=0.03, seed=3)
    else:
        world = make_world_loop_2d(num_kfs=12, radius=3.0, num_landmarks=1,
                                   seed=3, revolutions=2.0)
        ds = make_graph_slam_dataset(world, noise_std=0.005,
                                     loop_closure_range=1.5,
                                     odo_noise_std=0.03, seed=3)
    return [([JObservation(lm_id=m, z=z) for m, z in frame],
             {k - 1: ds.odometry[k - 1]} if k else None)
            for k, frame in enumerate(ds.frames)]


def _live(dm_pose, dm_prior, dm_lm, n_e, n_l):
    return (np.asarray(dm_pose)[:n_e], np.asarray(dm_prior)[:n_e],
            np.asarray(dm_lm)[:n_l])


def _three_mirrored_steps(model):
    frames = _frames(model)
    jeng = JEngine(model, noise=NoiseIdentity(0.005),
                   params=JParams(max_tree_depth=3, max_optimize_depth=3,
                                  rel_tol=0.3))
    for obs, init in frames[:9]:
        jeng.define_new_keyframe(obs, edge_init=init)
    jdm = jeng.device_master
    pdm = convert.device_master_from_jax(jdm, device="cpu")
    pairs = []
    orig_step = jdm.step

    def mirrored_step(cfg, whitener, spinv, calib, *window, iters_cap=0):
        for row, prior in zip(jdm._pend_edges, jdm._pend_priors):
            pdm.stage_edge(row, prior[-1])
        for row in jdm._pend_lms:
            pdm.stage_landmark(row)
        tinfo = pdm.step(convert.solver_config_from_jax(cfg), whitener,
                         spinv, calib, *window, iters_cap=iters_cap)
        jinfo = orig_step(cfg, whitener, spinv, calib, *window,
                          iters_cap=iters_cap)
        pairs.append((jinfo, tinfo))
        return jinfo

    jdm.step = mirrored_step
    for obs, init in frames[9:12]:
        jeng.define_new_keyframe(obs, edge_init=init)
        assert (pdm.num_edges, pdm.num_lms) == (jdm.num_edges, jdm.num_lms)
        ref = _live(jdm.pose, jdm.prior, jdm.lm, jdm.num_edges, jdm.num_lms)
        out = _live(pdm.pose, pdm.prior, pdm.lm, pdm.num_edges, pdm.num_lms)
        for r, o in zip(ref, out):
            np.testing.assert_allclose(o, r, atol=MASTER_ATOL)
        # Rows beyond the live ones stay untouched zeros in both.
        assert not pdm.pose[pdm.num_edges:].any()
    assert len(pairs) == 3
    return jeng, pdm, pairs


def test_three_master_steps_match_jax():
    jeng, pdm, pairs = _three_mirrored_steps("RangeBearing2D")
    jdm = jeng.device_master
    for jinfo, tinfo in pairs:
        assert isinstance(tinfo, LazyInfo)
        for k in ("err_init", "err_final"):
            assert tinfo[k] == pytest.approx(jinfo[k], rel=ERR_RTOL), k
        for k in ("iters", "lam", "num_obs"):
            assert tinfo[k] == jinfo[k], (k, dict(tinfo), dict(jinfo))
    assert pdm.step_seq == jdm.step_seq


def test_pack_window_ints_matches_jax():
    rng = np.random.default_rng(0)
    args = [rng.integers(0, 9, 8), rng.integers(0, 2, 8),
            rng.integers(0, 60, 64), rng.integers(0, 2, 64),
            rng.integers(0, 64, 64), rng.integers(0, 2, 64),
            rng.integers(0, 8, (64, 3)),
            rng.choice([-1.0, 0.0, 1.0], (64, 3))]
    np.testing.assert_array_equal(tmaster.pack_window_ints(*args),
                                  jmaster.pack_window_ints(*args))


def test_lazy_info_fetches_on_first_read():
    info = LazyInfo({"err_init": torch.tensor(2.0),
                     "err_final": torch.tensor(1.0),
                     "iters": torch.tensor(3, dtype=torch.int32),
                     "lam": torch.tensor(1e-5),
                     "num_obs": torch.tensor(40.0)})
    assert "err_final" in info and len(info) == 5 and info._dev is not None
    assert info["iters"] == 3.0 and info._dev is None
    assert set(info.keys()) == {"err_init", "err_final", "iters", "lam",
                                "num_obs"}


def test_master_grows_past_initial_capacity():
    dm = DeviceMaster(3, 2, device="cpu")
    n = dm.pose.shape[0] + 5
    for i in range(n):
        dm.stage_edge(np.asarray([i, 0.0, 0.0], np.float32), prior_w=1.0)
    dm.flush_append()
    assert dm.num_edges == n and dm.pose.shape[0] >= n
    host_pose = np.zeros((n, 3), np.float32)
    dm.dirty = True
    dm.sync_to_host(host_pose, np.zeros((0, 2), np.float32))
    np.testing.assert_array_equal(host_pose[:, 0], np.arange(n))
    assert float(dm.prior[n - 1, 3]) == 1.0


def test_prefetch_serves_mirror_sync():
    dm = DeviceMaster(3, 2, device="cpu")
    dm.stage_edge(np.asarray([1.0, 2.0, 0.5], np.float32))
    dm.stage_landmark(np.asarray([3.0, 4.0], np.float32))
    dm.flush_append()
    dm.dirty = True
    dm.maybe_prefetch(max_age=2, force=True)
    assert dm._prefetch is not None
    pose, lm = np.zeros((1, 3), np.float32), np.zeros((1, 2), np.float32)
    dm.sync_to_host(pose, lm)      # exact: the prefetch is of this step
    assert dm.sync_stats["pf_hit"] == 1 and dm.sync_stats["miss"] == 0
    np.testing.assert_array_equal(pose[0], [1.0, 2.0, 0.5])
    np.testing.assert_array_equal(lm[0], [3.0, 4.0])
    assert not dm.dirty


def test_grow_master_and_append_match_jax_semantics():
    m = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    g = tmaster.grow_master(m, 8)
    assert g.shape == (8, 3) and torch.equal(g[:4], m) and not g[4:].any()
    pose, prior, lm = (torch.zeros(16, 3), torch.zeros(16, 4),
                       torch.zeros(64, 2))
    rows = np.arange(8 * 3 + 8 * 4 + 64 * 2, dtype=np.float32)
    tmaster.make_append_only(3, 2)(pose, prior, lm, rows,
                                   np.asarray([12, 0]), 8, 64)
    # Start clamped so the 8 rows fit (lax.dynamic_update_slice semantics).
    np.testing.assert_array_equal(pose[8:].numpy().ravel(), rows[:24])
    np.testing.assert_array_equal(lm.numpy().ravel(), rows[56:])



@pytest.mark.parametrize("model", ["RangeBearing3D", "RelativePoses2D"])
def test_three_master_steps_match_jax_se3_and_graph_slam(model):
    """The same mirrored steps at SE(3) width (7-wide pose rows, Euclidean3D)
    and in graph-SLAM mode (fixed identity pose landmarks, closure edges)."""
    jeng, pdm, pairs = _three_mirrored_steps(model)
    assert pdm.pose_dim == jeng.group.dim and pdm.lm_dim == jeng.lm_type.dim
    for jinfo, tinfo in pairs:
        for k in ("err_init", "err_final"):
            assert tinfo[k] == pytest.approx(jinfo[k], rel=ERR_RTOL), k
        for k in ("iters", "lam", "num_obs"):
            assert tinfo[k] == jinfo[k], (k, dict(tinfo), dict(jinfo))
    if model == "RelativePoses2D":
        # Pose landmarks are fixed: their rows never move.
        assert torch.equal(pdm.lm[:pdm.num_lms],
                           torch.zeros(pdm.num_lms, 3))


def test_masked_scatter_adds_exact_zeros_at_se3_width():
    """An SE(3) master step changes only the window's opt rows: fixed and
    pad slots (global id 0, repeated) add exact zeros."""
    frames = _frames("RangeBearing3D")
    jeng = JEngine("RangeBearing3D", noise=NoiseIdentity(0.005),
                   params=JParams(max_tree_depth=3, max_optimize_depth=2))
    for obs, init in frames[:8]:
        jeng.define_new_keyframe(obs, edge_init=init,
                                 run_local_optimization=False)
    from srba_tpu.solver.window import build_window
    arrays, plan = build_window(jeng.state, jeng.graph, 7, 2, 3,
                                gather_floats=False)
    assert (arrays.edge_gids[len(plan.edge_ids):] == 0).all()
    pdm = convert.device_master_from_jax(jeng.device_master, device="cpu")
    pdm.flush_append()
    before_pose, before_lm = pdm.pose.clone(), pdm.lm.clone()
    pdm.step(convert.solver_config_from_jax(jeng._solver_cfg),
             jeng._whitener, jeng._sensor_pose_inv, None,
             arrays.edge_gids, arrays.edge_opt, arrays.lm_gids,
             arrays.lm_opt, arrays.obs_lm, arrays.obs_valid,
             arrays.path_edge, arrays.path_sign, arrays.obs_z)
    moved_e = (pdm.pose != before_pose).any(dim=1).nonzero().flatten()
    moved_l = (pdm.lm != before_lm).any(dim=1).nonzero().flatten()
    opt_e = set(plan.edge_ids[plan.edge_opt].tolist())
    opt_l = set(plan.lm_ids[plan.lm_opt].tolist())
    assert moved_e.numel() > 0 and set(moved_e.tolist()) <= opt_e
    assert moved_l.numel() > 0 and set(moved_l.tolist()) <= opt_l
    q = pdm.pose[:pdm.num_edges, 3:]
    assert torch.allclose(torch.linalg.vector_norm(q, dim=-1),
                          torch.ones(pdm.num_edges), atol=1e-6)
