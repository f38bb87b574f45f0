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
