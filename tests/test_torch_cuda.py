"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).  The CUDA
kernel has no CPU or interpret mode, so without a card they skip.  On a
machine with a card and no JAX, run them with

    python -m pytest -o addopts="" -m cuda tests/test_torch_cuda.py

(``-o addopts=""`` drops the JAX package's test boot plugin from the
pytest settings).  This file imports no JAX.

Tolerances: kernel vs plain at rtol 2e-4 / atol 2e-5 (the block tests'
tolerance); CUDA vs CPU engine state at atol 1e-3 (the e2e parity
tolerance of tests/test_torch_e2e_rb2d.py, _rb3d.py and _graphslam.py).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or "
                    "interpret mode")
    return torch.device("cuda")


def _launches(d=None):
    """The SPD kernel's launches so far, at block size ``d`` or in all."""
    from srba_tpu_torch.ops import block_linalg as bl
    return sum(n for (_, dd), n in bl.spd_inverse_cuda.launches_by_shape.items()
               if d is None or dd == d)


def _spd_stack(B, d, seed=0, cond=5.0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, d, d)).astype(np.float32)
    return A @ A.transpose(0, 2, 1) + cond * np.eye(d, dtype=np.float32)


@pytest.mark.parametrize("d", [1, 2, 3, 6])
@pytest.mark.parametrize("B", [1, 7, 300, 2048])
def test_kernel_matches_plain(cuda, B, d):
    from srba_tpu_torch.ops import block_linalg as bl
    m = torch.as_tensor(_spd_stack(B, d), device=cuda)
    n0 = bl.spd_inverse_cuda.launches_by_shape.get((B, d), 0)
    out = bl.spd_inverse(m)
    torch.cuda.synchronize()
    assert bl.spd_inverse_cuda.launches_by_shape[(B, d)] == n0 + 1
    torch.testing.assert_close(out, bl.spd_inverse_unrolled(m), rtol=2e-4,
                               atol=2e-5)


def test_kernel_rejects_what_it_does_not_take(cuda):
    from srba_tpu_torch.ops import block_linalg as bl
    m = torch.as_tensor(_spd_stack(8, 2), device=cuda)
    with pytest.raises(TypeError):
        bl.spd_inverse_cuda(m.double())
    with pytest.raises(ValueError):
        bl.spd_inverse_cuda(m.transpose(-1, -2))
    with pytest.raises(ValueError):
        bl.spd_inverse_cuda(torch.eye(4, device=cuda).repeat(3, 1, 1))


@pytest.mark.parametrize("d", [1, 2, 3, 6])
@pytest.mark.parametrize("edge", [-1, 0, 1, "2T+1"])
def test_kernel_matches_plain_at_tile_edges(cuda, d, edge):
    """B = T - 1, T, T + 1 and 2T + 1 for the T blocks a CTA takes (at
    d = 3 the odd ones leave tail bytes that are not a multiple of 16)."""
    from srba_tpu_torch.ops import block_linalg as bl
    T = bl.kernel_tile(d)
    B = 2 * T + 1 if edge == "2T+1" else T + edge
    m = torch.as_tensor(_spd_stack(B, d, seed=B), device=cuda)
    out = bl.spd_inverse(m)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, bl.spd_inverse_unrolled(m), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("d", [1, 2, 3, 6])
def test_kernel_on_views_at_a_one_block_offset(cuda, d):
    """A contiguous view one block into a stack (36 B off at d = 3, not
    16-byte aligned) as input and as output: the plain version's result,
    bitwise equal to the kernel on an aligned copy."""
    from srba_tpu_torch.ops import block_linalg as bl
    B = 2 * bl.kernel_tile(d) + 3
    big = torch.as_tensor(_spd_stack(B + 1, d, seed=2), device=cuda)
    view = big[1:]
    assert view.is_contiguous()
    assert view.data_ptr() % 16 == (d * d * 4) % 16
    aligned = bl.spd_inverse(view.clone())
    out = bl.spd_inverse(view)
    out_big = torch.empty_like(big)
    assert bl.spd_inverse_cuda(view, out_big[1:]).data_ptr() \
        == out_big[1:].data_ptr()
    torch.cuda.synchronize()
    assert torch.equal(out, aligned)
    assert torch.equal(out_big[1:], aligned)
    torch.testing.assert_close(out, bl.spd_inverse_unrolled(view),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("d", [1, 2, 3, 6])
def test_non_spd_blocks_give_non_finite_entries_where_plain_does(cuda, d):
    """Blocks that are not positive definite (negated, or with a negative
    last pivot; at d = 1 a zero and a negative value): NaN and inf in the
    same entries as the plain version, the other blocks unharmed."""
    from srba_tpu_torch.ops import block_linalg as bl
    m = torch.as_tensor(_spd_stack(300, d, seed=3), device=cuda)
    m[5] = -m[5]
    m[200, d - 1, d - 1] = -50.0
    if d == 1:
        m[7] = 0.0
    out = bl.spd_inverse(m)
    ref = bl.spd_inverse_unrolled(m)
    torch.cuda.synchronize()
    assert torch.equal(out.isnan(), ref.isnan())
    assert torch.equal(out.isinf(), ref.isinf())
    if d > 1:
        assert out[5].isnan().all() and out[200].isnan().any()
    fin = ref.isfinite()
    torch.testing.assert_close(out[fin], ref[fin], rtol=2e-4, atol=2e-5)
    ok = torch.ones(300, dtype=torch.bool, device=cuda)
    ok[[5, 7, 200]] = False
    assert out[ok].isfinite().all()


def test_kernel_refuses_what_it_is_not_built_for(cuda):
    """The C entry point refuses a block size it has no kernel for (and
    reports no tile for it); the wrapper refuses an output of the wrong
    shape."""
    from srba_tpu_torch.ops import block_linalg as bl
    m = torch.as_tensor(_spd_stack(300, 6), device=cuda)
    out = torch.empty_like(m)
    lib = bl.load_kernel_library()
    assert lib.srba_spd_inverse_tile(4) == 0
    rc = lib.srba_spd_inverse_f32(m.data_ptr(), out.data_ptr(), 50, 4,
                                  torch.cuda.current_stream().cuda_stream)
    assert lib.srba_cuda_error_string(rc).decode() == "invalid argument"
    with pytest.raises(ValueError):
        bl.spd_inverse_cuda(m, out[1:])


def _run(device, frames, odometry, model="RangeBearing2D", sigma=0.005):
    import srba_tpu_torch as port
    from srba_tpu_torch.models.noise import NoiseIdentity
    eng = port.SrbaEngine(
        model, noise=NoiseIdentity(sigma),
        params=port.SrbaParams(max_tree_depth=3, max_optimize_depth=3),
        device=device)
    for k, frame in enumerate(frames):
        eng.define_new_keyframe(
            [port.Observation(lm_id=m, z=z) for m, z in frame],
            edge_init={k - 1: odometry[k - 1]} if k else None)
    return eng


def test_engine_on_cuda_matches_cpu_and_repeats_bitwise(cuda):
    from srba_tpu_torch.utils.datasets import make_world_loop_2d, observe
    world = make_world_loop_2d(num_kfs=25, radius=6.0, num_landmarks=60,
                               seed=7)
    ds = observe(world, "RangeBearing2D", noise_std=0.005, sensor_range=5.0,
                 odo_noise_std=0.03, seed=7)
    n0 = _launches()
    eg = _run("cuda", ds.frames, ds.odometry)
    assert _launches() > n0
    ec = _run("cpu", ds.frames, ds.odometry)
    sg, sc = eg.get_rba_state(), ec.get_rba_state()
    np.testing.assert_allclose(sg.k2k_pose[:sg.num_edges],
                               sc.k2k_pose[:sc.num_edges], atol=1e-3)
    np.testing.assert_allclose(sg.lm_state[:sg.num_lms],
                               sc.lm_state[:sc.num_lms], atol=1e-3)
    eg2 = _run("cuda", ds.frames, ds.odometry)
    assert torch.equal(eg.device_master.pose, eg2.device_master.pose)
    assert torch.equal(eg.device_master.lm, eg2.device_master.lm)


def _wide_dataset(model):
    from srba_tpu_torch.utils import datasets as tds
    if model == "RangeBearing3D":
        world = tds.make_world_loop_3d(num_kfs=20, radius=6.0,
                                       num_landmarks=80, seed=2)
        return tds.observe(world, model, noise_std=0.005, sensor_range=5.0,
                           odo_noise_std=0.02, seed=2), 0.005
    world = tds.make_world_loop_2d(num_kfs=25, radius=5.0, num_landmarks=1,
                                   seed=4)
    return tds.make_graph_slam_dataset(world, noise_std=0.005,
                                       odo_noise_std=0.05,
                                       loop_closure_range=3.0, seed=4), 0.005


@pytest.mark.parametrize("model", ["RangeBearing3D", "RelativePoses2D"])
def test_se3_and_graph_slam_engines_on_cuda_match_cpu(cuda, model):
    """The 20-KF 3D range-bearing loop and the 25-KF graph-SLAM loop on the
    card against the CPU, through the kernel at block size 3, and bitwise
    equal masters on a rerun."""
    ds, sigma = _wide_dataset(model)
    n0 = _launches(3)
    eg = _run("cuda", ds.frames, ds.odometry, model, sigma)
    assert _launches(3) > n0
    assert eg.device_master.pose.is_cuda and eg.device_master.lm.is_cuda
    ec = _run("cpu", ds.frames, ds.odometry, model, sigma)
    sg, sc = eg.get_rba_state(), ec.get_rba_state()
    assert (sg.num_edges, sg.num_lms) == (sc.num_edges, sc.num_lms)
    np.testing.assert_allclose(sg.k2k_pose[:sg.num_edges],
                               sc.k2k_pose[:sc.num_edges], atol=1e-3)
    np.testing.assert_allclose(sg.lm_state[:sg.num_lms],
                               sc.lm_state[:sc.num_lms], atol=1e-3)
    eg2 = _run("cuda", ds.frames, ds.odometry, model, sigma)
    assert torch.equal(eg.device_master.pose, eg2.device_master.pose)
    assert torch.equal(eg.device_master.lm, eg2.device_master.lm)


def _ring_problem(group, K=200, seed=0):
    """A noisy SE(2)/SE(3) ring of K poses with a chord every 20 poses and
    perturbed initial nodes (the port's numpy groups, no JAX)."""
    from srba_tpu_torch.ops.np_lie import NpSE2, NpSE3
    g = NpSE2 if group == "SE2" else NpSE3
    dof = 3 if group == "SE2" else 6
    rng = np.random.default_rng(seed)
    th = 2 * np.pi * np.arange(K) / K
    if group == "SE2":
        gt = np.stack([[8 * np.cos(t), 8 * np.sin(t), t + np.pi / 2]
                       for t in th]).astype(np.float32)
        gt[:, 2] = np.arctan2(np.sin(gt[:, 2]), np.cos(gt[:, 2]))
    else:
        gt = np.stack([g.pexp(np.asarray(
            [8 * np.cos(t), 8 * np.sin(t), 0.2 * np.sin(3 * t), 0, 0,
             t + np.pi / 2], np.float32)) for t in th])

    def rel(i, j):
        return g.compose(g.inverse(gt[i]), gt[j]).astype(np.float32)

    edges = [{"from": k - 1, "to": k, "rel_pose": g.retract(
        rel(k - 1, k), rng.normal(0, 0.01, dof).astype(np.float32))}
        for k in range(1, K)]
    edges += [{"from": i, "to": (i + K // 2) % K,
               "rel_pose": rel(i, (i + K // 2) % K)}
              for i in range(0, K, 20)]
    nodes = np.stack([g.retract(gt[k], rng.normal(0, 0.05, dof).astype(
        np.float32)) for k in range(K)]).astype(np.float32)
    nodes[0] = gt[0]
    return {"group": group, "nodes": nodes, "edges": edges}


@pytest.mark.parametrize("group,d", [("SE2", 3), ("SE3", 6)])
def test_pgo_on_cuda_matches_cpu_and_repeats_bitwise(cuda, group, d):
    """The K = 200 global PGO (chordal init) on the card against the CPU
    (nodes atol 1e-3, err_final rel 1e-3: the whole-solve tolerances of
    tests/test_torch_global_pgo.py), bitwise equal on a rerun, through the
    kernel on [256, d, d].  CG runs to its tolerance (cg_iters 1000): with
    100 iterations each LM step stops short, LM certifies on relative
    progress away from the optimum, and two roundings stop ~2e-3 apart at
    equal error (the JAX package and the port on the CPU as well); with
    whole CG solves both reach the optimum (~7e-5 apart on the CPU)."""
    from srba_tpu_torch.ops import block_linalg as bl
    from srba_tpu_torch.solver.global_graphslam import (
        PGOConfig, optimize_global_pose_graph)
    prob = _ring_problem(group)
    cfg = PGOConfig(group=group, cg_iters=1000, chordal_init=True)
    n0 = bl.spd_inverse_cuda.launches_by_shape.get((256, d), 0)
    G, info = optimize_global_pose_graph(prob, cfg, device=cuda)
    n1 = bl.spd_inverse_cuda.launches_by_shape.get((256, d), 0)
    # One launch per LM iteration.
    assert n1 - n0 == info["iters"] > 0
    assert info["converged"] == 1.0
    Gc, ic = optimize_global_pose_graph(prob, cfg, device="cpu")
    np.testing.assert_allclose(G, Gc, atol=1e-3)
    assert info["err_final"] == pytest.approx(ic["err_final"], rel=1e-3)
    G2, _ = optimize_global_pose_graph(prob, cfg, device=cuda)
    assert np.array_equal(G, G2)


def _stereo_window(device, n_kfs=10):
    """A depth-3 window of the mounted-stereo map of tests/test_torch_solver
    .py, built by the port's engine on the CPU (edges at their odometry
    seeds), as a ``WindowBatch`` on ``device``."""
    import srba_tpu_torch as port
    from srba_tpu_torch.models.noise import NoiseIdentity
    from srba_tpu_torch.models.observations import (StereoCalib,
                                                    calib_constants)
    from srba_tpu_torch.models.sensor_pose import SensorPoseSE3
    from srba_tpu_torch.ops.np_lie import CAMERA_SENSOR_POSE_SE3
    from srba_tpu_torch.solver.lm import WindowBatch
    from srba_tpu_torch.solver.window import build_window
    from srba_tpu_torch.utils import datasets as tds
    calib = StereoCalib.make(fx=200.0, fy=200.0, cx=160.0, cy=120.0,
                             baseline=0.12)
    world = tds.make_world_loop_3d(num_kfs=20, radius=6.0, num_landmarks=150,
                                   height_amp=0.5, seed=8)
    ds = tds.observe(world, "StereoCamera", calib=calib, noise_std=0.3,
                     sensor_range=8.0, odo_noise_std=0.02, seed=8)
    eng = port.SrbaEngine(
        "StereoCamera", calib=calib, noise=NoiseIdentity(0.3),
        sensor_pose=SensorPoseSE3(CAMERA_SENSOR_POSE_SE3),
        params=port.SrbaParams(max_tree_depth=3, max_optimize_depth=3),
        device="cpu")
    for k, frame in enumerate(ds.frames[:n_kfs]):
        eng.define_new_keyframe(
            [port.Observation(lm_id=m, z=z) for m, z in frame],
            run_local_optimization=False,
            edge_init={k - 1: ds.odometry[k - 1]} if k else None)
    eng.sync()
    arrays, _ = build_window(eng.state, eng.graph, n_kfs - 1, 3, 3)

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    batch = WindowBatch(
        edge_pose=dev(arrays.edge_pose), edge_opt=dev(arrays.edge_opt),
        lm_state=dev(arrays.lm_state), lm_opt=dev(arrays.lm_opt),
        obs_z=dev(arrays.obs_z), obs_lm=dev(arrays.obs_lm, torch.int32),
        path_edge=dev(arrays.path_edge, torch.int32),
        path_sign=dev(arrays.path_sign), obs_valid=dev(arrays.obs_valid),
        whitener=dev(eng._whitener), sensor_pose_inv=dev(eng._sensor_pose_inv),
        calib=calib_constants(calib),
        edge_prior=dev(arrays.edge_prior),
        edge_prior_w=dev(arrays.edge_prior_w))
    return eng._solver_cfg, batch


def test_stereo_window_solve_on_cuda_matches_cpu(cuda):
    """The mounted-stereo window's LM solve on the card against the CPU
    (state atol 1e-3, errors rel 1e-3: the stereo tolerances of
    tests/test_torch_solver.py), through the kernel at block size 3."""
    import dataclasses

    from srba_tpu_torch.solver.lm import make_lm_solver
    cfg, bg = _stereo_window(cuda)
    _, bc = _stereo_window("cpu")
    cfg = dataclasses.replace(cfg, rel_tol=0.05)
    n0 = _launches(3)
    eg, lg, ig = make_lm_solver(cfg, device=cuda)[0](bg)
    assert _launches(3) > n0 and eg.is_cuda
    ec, lc, ic = make_lm_solver(cfg, device="cpu")[0](bc)
    np.testing.assert_allclose(eg.cpu().numpy(), ec.numpy(), atol=1e-3)
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), atol=1e-3)
    for k in ("err_init", "err_final"):
        assert float(ig[k]) == pytest.approx(float(ic[k]), rel=1e-3)
    assert float(ig["iters"]) == float(ic["iters"]) == 5
    assert float(ig["err_final"]) < float(ig["err_init"])


def _closure_run(device, noise, odo):
    """30 keyframes of the stereo world above, mounted camera, areas of 5
    keyframes: one bootstrapped closure edge (27, 0)."""
    import srba_tpu_torch as port
    from srba_tpu_torch.ecps import LocalAreasFixedGrid
    from srba_tpu_torch.models.noise import NoiseIdentity
    from srba_tpu_torch.models.observations import StereoCalib
    from srba_tpu_torch.models.sensor_pose import SensorPoseSE3
    from srba_tpu_torch.ops.np_lie import CAMERA_SENSOR_POSE_SE3
    from srba_tpu_torch.utils import datasets as tds
    calib = StereoCalib.make(fx=200.0, fy=200.0, cx=160.0, cy=120.0,
                             baseline=0.12)
    world = tds.make_world_loop_3d(num_kfs=30, radius=6.0, num_landmarks=400,
                                   height_amp=0.5, seed=8)
    ds = tds.observe(world, "StereoCamera", calib=calib, noise_std=noise,
                     sensor_range=8.0, odo_noise_std=odo, seed=8)
    eng = port.SrbaEngine(
        "StereoCamera", calib=calib, noise=NoiseIdentity(0.3),
        sensor_pose=SensorPoseSE3(CAMERA_SENSOR_POSE_SE3),
        ecp=LocalAreasFixedGrid(submap_size=5, min_obs_count_loop_closure=5),
        params=port.SrbaParams(max_tree_depth=3, max_optimize_depth=3),
        device=device)
    for k, frame in enumerate(ds.frames):
        eng.define_new_keyframe(
            [port.Observation(lm_id=m, z=z) for m, z in frame],
            edge_init={k - 1: ds.odometry[k - 1]} if k else None)
    return eng, world


def _edge_list(st):
    return list(zip(st.k2k_from[:st.num_edges].tolist(),
                    st.k2k_to[:st.num_edges].tolist()))


def test_config3_shaped_run_on_cuda_matches_cpu(cuda):
    """Config #3's path at a small size with exact data (whose windows are
    well conditioned): the same edges and closure on the card as on the
    CPU, states and the global PGO's nodes within atol 1e-3, bitwise equal
    masters on a rerun."""
    n0 = _launches(3)
    eg, _ = _closure_run(cuda, 0.0, 0.0)
    assert _launches(3) > n0
    ec, _ = _closure_run("cpu", 0.0, 0.0)
    sg, sc = eg.get_rba_state(), ec.get_rba_state()
    assert _edge_list(sg) == _edge_list(sc)
    assert (27, 0) in _edge_list(sg)
    np.testing.assert_allclose(sg.k2k_pose[:sg.num_edges],
                               sc.k2k_pose[:sc.num_edges], atol=1e-3)
    np.testing.assert_allclose(sg.lm_state[:sg.num_lms],
                               sc.lm_state[:sc.num_lms], atol=1e-3)
    eg2, _ = _closure_run(cuda, 0.0, 0.0)
    assert torch.equal(eg.device_master.pose, eg2.device_master.pose)
    assert torch.equal(eg.device_master.lm, eg2.device_master.lm)
    Gg, ig = eg.optimize_global()
    Gc, ic = ec.optimize_global()
    assert ig["converged"] == ic["converged"] == 1.0
    np.testing.assert_allclose(Gg, Gc, atol=1e-3)


def test_config3_shaped_global_pgo_on_cuda(cuda):
    """With noise (0.3 px, odometry 0.02) the terminal ``optimize_global()``
    on the card takes LM steps through the kernel at [256, 6, 6], once per
    iteration, certifies, and ends within 0.1 m ATE."""
    from srba_tpu_torch.ops import block_linalg as bl
    from srba_tpu_torch.utils.datasets import ate_rmse
    eng, world = _closure_run(cuda, 0.3, 0.02)
    assert (27, 0) in _edge_list(eng.get_rba_state())
    n0 = bl.spd_inverse_cuda.launches_by_shape.get((256, 6), 0)
    G, info = eng.optimize_global()
    n1 = bl.spd_inverse_cuda.launches_by_shape.get((256, 6), 0)
    assert info["converged"] == 1.0
    assert n1 - n0 == info["iters"] >= 1
    assert ate_rmse(G[:, :3], world.gt_poses[:, :3]) < 0.1


def _camera_run(device, model, noise, odo, K=60, seed=9):
    """tests/test_triangulate.py's 60-keyframe world through a mounted
    monocular or RGB-D camera, no landmark init anywhere."""
    import srba_tpu_torch as port
    from srba_tpu_torch.models.observations import CameraCalib
    from srba_tpu_torch.models.sensor_pose import SensorPoseSE3
    from srba_tpu_torch.ops.np_lie import CAMERA_SENSOR_POSE_SE3
    from srba_tpu_torch.utils import datasets as tds
    calib = CameraCalib.make()
    world = tds.make_world_loop_3d(num_kfs=K, radius=6.0, num_landmarks=150,
                                   height_amp=0.3, seed=seed)
    ds = tds.observe(world, model, calib=calib, noise_std=noise,
                     sensor_range=7.0, odo_noise_std=odo, seed=seed)
    eng = port.SrbaEngine(
        model, calib=calib, sensor_pose=SensorPoseSE3(CAMERA_SENSOR_POSE_SE3),
        params=port.SrbaParams(max_tree_depth=4, max_optimize_depth=3,
                               use_robust_kernel=True), device=device)
    for k, frame in enumerate(ds.frames):
        eng.define_new_keyframe(
            [port.Observation(lm_id=m, z=z) for m, z in frame],
            edge_init={k - 1: ds.odometry[k - 1]} if k else None)
    G, _ = eng.create_complete_spanning_tree(0)
    return eng, float(tds.ate_rmse(G[:, :3], world.gt_poses[:, :3]))


def test_monocular_run_on_cuda_matches_cpu(cuda):
    """Config #5's path at a small size: landmarks by deferred two-view
    triangulation (host numpy on the odometry, so the same landmarks with
    the same base keyframes on the card as on the CPU), the robust kernel,
    the kernel on [L, 3, 3]; ATE within 1e-2 m of the CPU's (the windows
    carry a scale gauge) and under the JAX test's 0.35 m, masters bitwise
    equal on a rerun."""
    n0 = _launches(3)
    eg, ate_g = _camera_run(cuda, "MonocularCamera", 0.2, 0.005)
    assert _launches(3) > n0
    ec, ate_c = _camera_run("cpu", "MonocularCamera", 0.2, 0.005)
    sg, sc = eg.get_rba_state(), ec.get_rba_state()
    assert eg._lm_id_map == ec._lm_id_map and eg.num_landmarks > 30
    assert eg.num_pending_landmarks == ec.num_pending_landmarks
    np.testing.assert_array_equal(sg.lm_base[:sg.num_lms],
                                  sc.lm_base[:sc.num_lms])
    assert abs(ate_g - ate_c) < 1e-2 and ate_g < 0.35
    eg2, _ = _camera_run(cuda, "MonocularCamera", 0.2, 0.005)
    assert torch.equal(eg.device_master.pose, eg2.device_master.pose)
    assert torch.equal(eg.device_master.lm, eg2.device_master.lm)


def test_rgbd_run_on_cuda_matches_cpu(cuda):
    """The RGB-D camera with exact data: states within atol 1e-3 of the
    CPU's and ATE under 1e-2 m."""
    eg, ate_g = _camera_run(cuda, "RGBDCamera", 0.0, 0.0, K=20, seed=12)
    ec, ate_c = _camera_run("cpu", "RGBDCamera", 0.0, 0.0, K=20, seed=12)
    sg, sc = eg.get_rba_state(), ec.get_rba_state()
    np.testing.assert_allclose(sg.k2k_pose[:sg.num_edges],
                               sc.k2k_pose[:sc.num_edges], atol=1e-3)
    np.testing.assert_allclose(sg.lm_state[:sg.num_lms],
                               sc.lm_state[:sc.num_lms], atol=1e-3)
    assert ate_g < 1e-2 and ate_c < 1e-2


def _run_mode(device, frames, odometry, device_master=True, run_local=True):
    import srba_tpu_torch as port
    from srba_tpu_torch.models.noise import NoiseIdentity
    eng = port.SrbaEngine(
        "RangeBearing2D", noise=NoiseIdentity(0.004),
        params=port.SrbaParams(max_tree_depth=4, max_optimize_depth=4),
        device_master=device_master, device=device)
    for k, frame in enumerate(frames):
        eng.define_new_keyframe(
            [port.Observation(lm_id=m, z=z) for m, z in frame],
            edge_init={k - 1: odometry[k - 1]} if k else None,
            run_local_optimization=run_local)
    return eng


def _loop_25(seed=3):
    from srba_tpu_torch.utils.datasets import make_world_loop_2d, observe
    world = make_world_loop_2d(num_kfs=25, radius=8.0, num_landmarks=60,
                               seed=seed)
    return observe(world, "RangeBearing2D", noise_std=0.005,
                   sensor_range=6.0, odo_noise_std=0.01, seed=seed)


def test_host_window_engine_on_cuda_matches_cpu(cuda):
    """The 25-KF host-window run (tests/test_device_master.py's data) on
    the card against the CPU (state atol 1e-3), through the kernel, and a
    bitwise-equal rerun."""
    ds = _loop_25()
    n0 = _launches(2)
    eg = _run_mode("cuda", ds.frames, ds.odometry, device_master=False)
    assert eg.device_master is None and _launches(2) > n0
    ec = _run_mode("cpu", ds.frames, ds.odometry, device_master=False)
    sg, sc = eg.get_rba_state(), ec.get_rba_state()
    np.testing.assert_allclose(sg.k2k_pose[:sg.num_edges],
                               sc.k2k_pose[:sc.num_edges], atol=1e-3)
    np.testing.assert_allclose(sg.lm_state[:sg.num_lms],
                               sc.lm_state[:sc.num_lms], atol=1e-3)
    sg2 = _run_mode("cuda", ds.frames, ds.odometry,
                    device_master=False).get_rba_state()
    assert np.array_equal(sg.k2k_pose, sg2.k2k_pose)
    assert np.array_equal(sg.lm_state, sg2.lm_state)


def test_refine_map_on_cuda_matches_cpu(cuda):
    """Three sweeps of the 30-KF odometry map of tests/test_refine_map.py on
    the card against the CPU (map error rel 1e-3), the kernel launched at
    [W*L, 2, 2] once per LM iteration of each phase, a bitwise rerun."""
    from srba_tpu_torch.ops import block_linalg as bl
    from srba_tpu_torch.utils.datasets import make_world_loop_2d, observe
    world = make_world_loop_2d(num_kfs=30, radius=8.0, num_landmarks=70,
                               seed=6)
    ds = observe(world, "RangeBearing2D", noise_std=0.004, sensor_range=6.0,
                 odo_noise_std=0.02, seed=6)
    out = []
    for device in ("cuda", "cpu", "cuda"):
        eng = _run_mode(device, ds.frames, ds.odometry, run_local=False)
        bl.spd_inverse_cuda.launches_by_shape = {}
        info = eng.refine_map(sweeps=3, stride=3)
        out.append((eng, info, dict(bl.spd_inverse_cuda.launches_by_shape)))
    (eg, ig, shapes), (ec, ic, _), (eg2, _, _) = out
    assert ig["windows"] == ic["windows"] > 0
    assert shapes and all(d == 2 and B % 64 == 0 for B, d in shapes)
    assert sum(shapes.values()) == 6 * eg._solver_cfg.max_iters
    assert eg.eval_overall_squared_error() == pytest.approx(
        ec.eval_overall_squared_error(), rel=1e-3)
    assert torch.equal(eg.device_master.pose, eg2.device_master.pose)
    assert torch.equal(eg.device_master.lm, eg2.device_master.lm)


def test_segmented_solve_on_cuda_reruns_bitwise(cuda):
    """The segmented normal equations on the card: two solves of the same
    window bitwise equal, and within the one-hot solve's error (rel
    1e-3)."""
    import dataclasses

    from srba_tpu_torch.solver.lm import make_lm_solver
    from srba_tpu_torch.solver.window import build_window
    ds = _loop_25()
    eng = _run_mode("cpu", ds.frames, ds.odometry, run_local=False)
    arrays, _ = build_window(eng.state, eng.graph, 24, 4, 4)
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt)
    from srba_tpu_torch.solver.lm import WindowBatch
    batch = WindowBatch(
        edge_pose=t(arrays.edge_pose), edge_opt=t(arrays.edge_opt),
        lm_state=t(arrays.lm_state), lm_opt=t(arrays.lm_opt),
        obs_z=t(arrays.obs_z), obs_lm=t(arrays.obs_lm, torch.int32),
        path_edge=t(arrays.path_edge, torch.int32),
        path_sign=t(arrays.path_sign), obs_valid=t(arrays.obs_valid),
        whitener=t(eng._whitener), sensor_pose_inv=t(eng._sensor_pose_inv),
        edge_prior=t(arrays.edge_prior),
        edge_prior_w=t(arrays.edge_prior_w))
    res = {}
    for neq in ("segmented", "onehot"):
        solve, _ = make_lm_solver(
            dataclasses.replace(eng._solver_cfg, neq=neq), device=cuda)
        res[neq] = [solve(batch) for _ in range(2 if neq == "segmented"
                                                else 1)]
    (e1, l1, i1), (e2, l2, i2) = res["segmented"]
    assert torch.equal(e1, e2) and torch.equal(l1, l2)
    assert all(torch.equal(i1[k], i2[k]) for k in i1)
    assert float(i1["err_final"]) == pytest.approx(
        float(res["onehot"][0][2]["err_final"]), rel=1e-3)
