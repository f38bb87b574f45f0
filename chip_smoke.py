#!/usr/bin/env python3
"""Smoke run of the srba_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. card and flags: the card's name and power limit, torch version, TF32 off;
2. build of the hand-written CUDA kernel (SPD block inverse) from source,
   with nvcc's ``-Xptxas -v`` registers, shared memory and spills per
   kernel, and the blocks each CTA takes;
3. the kernel against its plain torch version on the card, at the solver's
   shapes, the edges of a CTA's blocks and a view one block into a stack,
   with a SHA-256 of each output; then at the eight measured shapes
   (``srba_tpu_torch/tools/spd_inverse_bench.py``) the time per call of the
   kernel's wrapper, the plain version and ``torch.linalg.inv_ex``, and
   the kernel's device time per launch (cold, warm, profiler) with its HBM
   bound and share of it;
4. a large window solve (E=256 edges, L=4096 landmarks, N=16384
   observations, depth 4) for 6 LM iterations;
5. config #1 end to end (2D range-bearing SE(2), 100-keyframe loop, the
   data and parameters of bench.py's headline config) through
   ``SrbaEngine(device="cuda")``: warm-up on the first 10 keyframes, timed
   pass with the kernel's launch count, ATE bound, agreement with the same
   run on the CPU;
6. determinism: a third run's device masters bitwise equal to the timed
   run's;
7. config #2 (3D range-bearing SE(3), bench.py's data and parameters) and
8. config #4 (relative-pose graph-SLAM SE(2), bench.py's data and
   parameters), each: warm-up on the first 10 keyframes, timed pass with
   KF/s, ATE bound and the kernel's launch count (block size 3), the
   profiler table, the first 20 keyframes on the CPU against the card, and
   a rerun of those 20 keyframes on the card with bitwise-equal masters;
9. the 20k-node SE(3) global pose-graph optimization of bench.py's
   ``bench_pgo`` (its problem and config unchanged): warm and timed calls,
   certification, the kernel on ``[32768, 6, 6]``, a profiled call's split
   by scope, the kernel against its plain version on the preconditioner
   stacks that call built, bitwise-equal reruns, the same solve on the CPU
   against the card;
10. config #4's global PGO after phase 8's timed pass: LM-PCG from the
   incremental map (the kernel on ``[256, 3, 3]``, held against its plain
   version on the stacks the solve built), then the terminal
   ``optimize_global()``: certification, ATE and total squared error before
   and after, and one more keyframe after the write-back;
11. chordal initialization on the card: the four-revolution SE(3) yaw-drift
   problem of tests/test_chordal.py, ATE bound, and the times of the SVD
   projection and the matrix-to-quaternion step;
12. config #3 end to end (stereo SE(3) with the camera mounted on the
   robot, local-areas edge policy, loop closures bootstrapped from the
   re-observed landmarks; bench.py's data and parameters, 500 keyframes):
   a warm pass and a timed pass of the whole run, KF/s, edges with the
   closure edges apart, closure fits by outcome and weak fits flushed, the
   kernel's launches by shape, the profiler table with the host mirror's
   prefetch hits and misses, the two passes' masters bitwise equal, the
   first 20 keyframes on the CPU against the card (ATE), and those
   keyframes' window steps started from the same state on both (errors);
13. config #3's terminal ``optimize_global()`` on the timed pass's engine:
   certification, error and iterations, ATE bound, the kernel on
   ``[Kp, 6, 6]`` held against its plain version on the stacks the solve
   built, and one more keyframe after the write-back.

Every phase prints its wall time.  The line before the last is the card as
``nvidia-smi`` names it; the JSON line before that lists the kernels; the
last line is the result JSON.  Imports nothing of JAX: the machine it
targets has none.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np

# bench.py ATE_BOUNDS["config1_rb2d"], ["config2_rb3d"], ["config3_stereo"]
# (after its global PGO), ["config4_graphslam"].
ATE_BOUND = {"config1": 0.16, "config2": 0.18, "config3": 0.25,
             "config4": 0.04}
KERNEL_RTOL, KERNEL_ATOL = 2e-4, 2e-5
# Port-vs-port (CUDA vs CPU) agreement: the e2e parity tolerance of
# tests/test_torch_e2e_rb2d.py (and _rb3d.py, _graphslam.py).
CPU_AGREE_ATOL = 1e-3
WARMUP_KFS, AGREE_KFS = 10, 20
# Config #3, CUDA vs CPU.  Its windows have near-flat directions and its LM
# runs 3 iterations per keyframe, so the two devices' roundings take the
# state apart along them within the first 20 keyframes (PERF.md): the runs
# are held to |ATE diff| < 1e-2 m (a 25th of the bound), and each
# keyframe's step, started from the same state on both, to the same
# initial error (rel 1e-5: f32 sums of ~1e3 terms) and final error (rel
# 1e-2).
CONFIG3_ATE_AGREE = 1e-2
STEP_ERR_INIT_RTOL, STEP_ERR_FINAL_RTOL = 1e-5, 1e-2
# Global PGO, CUDA vs CPU: the whole-solve parity tolerances of
# tests/test_torch_global_pgo.py (nodes atol 1e-3, err_final rel 1e-3).
PGO_NODE_ATOL, PGO_ERR_RTOL = 1e-3, 1e-3
# tests/test_chordal.py: the four-revolution SE(3) problem ends within 0.1 m.
CHORDAL_ATE_BOUND = 0.1


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    """A phase's check: raises (so the script exits non-zero) if it fails."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def large_window_batch(E=256, L=4096, N=16384, D=4, seed=0):
    """Seeded RangeBearing2D/SE2 window: the 2D analogue of
    benchmarks/solver_engines.make_batch (a chain of E edges, landmarks
    based on random keyframes, each observed from up to D hops before its
    base, then the unknowns perturbed)."""
    import torch

    from srba_tpu_torch.models.observations import RangeBearing2D
    from srba_tpu_torch.ops.np_lie import NpSE2
    from srba_tpu_torch.solver.lm import WindowBatch

    rng = np.random.default_rng(seed)
    edge_pose = rng.normal(0, 0.15, (E, 3)).astype(np.float32)
    # Global pose at KF k: edge e is T_{e+1<-e}, so G[e+1] = G[e] o inv(e).
    G = [NpSE2.identity()]
    for e in range(E):
        G.append(NpSE2.compose(G[-1], NpSE2.inverse(edge_pose[e])))
    G = np.asarray(G, np.float32)
    lm_world = rng.uniform(-5, 5, (L, 2)).astype(np.float32)
    lm_base = rng.integers(0, E + 1, L)
    lm_state = NpSE2.apply(NpSE2.inverse(G[lm_base]),
                           lm_world).astype(np.float32)
    obs_lm = rng.integers(0, L, N).astype(np.int32)
    base = lm_base[obs_lm]
    obs_kf = np.maximum(0, base - rng.integers(0, D + 1, N))
    hops = base - obs_kf
    path_edge = np.zeros((N, D), np.int32)
    path_sign = np.zeros((N, D), np.float32)
    T = np.zeros((N, 3), np.float32)
    for k in range(D):
        on = k < hops
        eid = np.where(on, obs_kf + k, 0)
        path_edge[:, k] = eid
        path_sign[:, k] = np.where(on, -1.0, 0.0)
        step = np.where(on[:, None], NpSE2.inverse(edge_pose[eid]), 0.0)
        T = NpSE2.compose(T, step)
    pt = NpSE2.apply(T, lm_state[obs_lm]).astype(np.float32)
    obs_z = RangeBearing2D.h(pt) + rng.normal(0, 0.01, (N, 2))
    edge_pose = NpSE2.retract(edge_pose, rng.normal(0, 0.02, (E, 3)))
    lm_state = lm_state + rng.normal(0, 0.05, lm_state.shape)

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device="cuda")

    return WindowBatch(
        edge_pose=dev(edge_pose), edge_opt=dev(np.ones(E)),
        lm_state=dev(lm_state), lm_opt=dev(np.ones(L)),
        obs_z=dev(obs_z), obs_lm=dev(obs_lm, torch.int32),
        path_edge=dev(path_edge, torch.int32), path_sign=dev(path_sign),
        obs_valid=dev(np.ones(N)), whitener=dev(np.eye(2) * 100.0),
        sensor_pose_inv=dev(NpSE2.identity()))


def make_config(name: str):
    """bench.py's data and parameters of config #1 (``bench.py:98-120``),
    #2 (``:127-145``), #3 (``:152-188``) or #4 (``:195-216``), unreduced.
    Returns (world, dataset, observation model, noise sigma, ATE
    dimensions, the engine's other arguments)."""
    import srba_tpu_torch as port
    from srba_tpu_torch.ecps import LocalAreasFixedGrid
    from srba_tpu_torch.models.observations import StereoCalib
    from srba_tpu_torch.models.sensor_pose import SensorPoseSE3
    from srba_tpu_torch.ops.np_lie import CAMERA_SENSOR_POSE_SE3
    from srba_tpu_torch.utils import datasets as tds

    depth4 = {"params": port.SrbaParams(max_tree_depth=4,
                                        max_optimize_depth=4)}
    if name == "config1":
        world = tds.make_world_loop_2d(num_kfs=100, radius=10.0,
                                       num_landmarks=180, seed=11)
        ds = tds.observe(world, "RangeBearing2D", noise_std=0.005,
                         sensor_range=6.0, odo_noise_std=0.01, seed=11)
        return world, ds, "RangeBearing2D", 0.005, 2, depth4
    if name == "config2":
        world = tds.make_world_loop_3d(num_kfs=100, radius=9.0,
                                       num_landmarks=250, height_amp=1.0,
                                       seed=3)
        ds = tds.observe(world, "RangeBearing3D", noise_std=0.005,
                         sensor_range=6.0, odo_noise_std=0.01, seed=3)
        return world, ds, "RangeBearing3D", 0.005, 3, depth4
    if name == "config3":
        world = tds.make_world_loop_3d(num_kfs=500, radius=8.0,
                                       num_landmarks=400, height_amp=0.5,
                                       seed=1)
        calib = StereoCalib.make(fx=200.0, fy=200.0, cx=160.0, cy=120.0,
                                 baseline=0.12)
        ds = tds.observe(world, "StereoCamera", calib=calib, noise_std=0.3,
                         sensor_range=9.0, odo_noise_std=0.01, seed=1)
        return world, ds, "StereoCamera", 0.3, 3, {
            "calib": calib,
            "sensor_pose": SensorPoseSE3(CAMERA_SENSOR_POSE_SE3),
            "ecp": LocalAreasFixedGrid(submap_size=10,
                                       min_obs_count_loop_closure=5),
            "params": port.SrbaParams(max_tree_depth=4, max_optimize_depth=3,
                                      extra_obs_per_lm_cap=6,
                                      incremental_max_iters=3)}
    world = tds.make_world_loop_2d(num_kfs=150, radius=8.0, num_landmarks=1,
                                   seed=5, revolutions=2.0)
    ds = tds.make_graph_slam_dataset(world, noise_std=0.002,
                                     loop_closure_range=1.5,
                                     odo_noise_std=0.01, seed=5)
    return world, ds, "RelativePoses2D", 0.002, 2, depth4


def run_config(cfg, device: str, num_kfs=None):
    """One pass of a config through the port (the first ``num_kfs``
    keyframes, all by default), fed as bench.py's ``_drive`` feeds it;
    returns (engine, seconds, ATE).  The timed section ends in ``fence()``,
    a device synchronize."""
    import srba_tpu_torch as port
    from srba_tpu_torch.models.noise import NoiseIdentity
    from srba_tpu_torch.utils.datasets import ate_rmse

    world, ds, model, sigma, d, engine_kw = cfg
    eng = port.SrbaEngine(model, noise=NoiseIdentity(sigma), device=device,
                          **engine_kw)
    t0 = time.perf_counter()
    for k, frame in enumerate(ds.frames[:num_kfs]):
        obs = [port.Observation(lm_id=m, z=z) for m, z in frame]
        edge_init = {k - 1: ds.odometry[k - 1]} if k > 0 else None
        eng.define_new_keyframe(obs, edge_init=edge_init)
    eng.fence()
    dt = time.perf_counter() - t0
    G, _ = eng.create_complete_spanning_tree(0)
    ate = float(ate_rmse(np.asarray(G)[:, :d], world.gt_poses[:len(G), :d]))
    return eng, dt, ate


def reset_launch_counts(bl) -> None:
    bl.spd_inverse_cuda.launches_by_shape = {}


def launches_by_d(bl) -> dict:
    """The kernel's launches since the last reset, per block size d."""
    out = {}
    for (_, d), n in bl.spd_inverse_cuda.launches_by_shape.items():
        out[d] = out.get(d, 0) + n
    return out


def shapes(by_shape) -> str:
    return ", ".join(f"[{B},{d},{d}] x{n}" for (B, d), n in by_shape.items())


@contextmanager
def pgo_kernel_inputs():
    """Records a copy of every stack the global PGO run inside hands
    ``spd_inverse`` (which still runs the kernel and counts)."""
    from srba_tpu_torch.solver import global_graphslam as pgo
    seen = []
    spd_inverse = pgo.spd_inverse

    def recorder(m):
        seen.append(m.clone())
        return spd_inverse(m)

    pgo.spd_inverse = recorder
    try:
        yield seen
    finally:
        pgo.spd_inverse = spd_inverse


@contextmanager
def window_buckets():
    """Counts the padded window shapes (E, L, N) and LM iteration caps of
    every device step run inside (the steps themselves are unchanged)."""
    from collections import Counter

    from srba_tpu_torch.engine.device_master import DeviceMaster
    seen = Counter()
    step = DeviceMaster.step

    def recorder(self, cfg, *args, iters_cap: int = 0):
        edge_ids, lm_ids, obs_lm = args[3], args[5], args[7]
        seen[(len(edge_ids), len(lm_ids), len(obs_lm),
              iters_cap or cfg.max_iters)] += 1
        return step(self, cfg, *args, iters_cap=iters_cap)

    DeviceMaster.step = recorder
    try:
        yield seen
    finally:
        DeviceMaster.step = step


def check_kernel_on(tag: str, bl, stacks) -> None:
    """The kernel against its plain version on stacks a solve built, at
    (KERNEL_RTOL, KERNEL_ATOL).  (Padding nodes' blocks are ``1e-8 * I``,
    so entries of the inverses reach 1e8.)"""
    import torch
    check(len(stacks) > 0, f"{tag}: the solve handed the kernel nothing")
    err = scale = 0.0
    for m in stacks:
        out, ref = bl.spd_inverse_cuda(m), bl.spd_inverse_unrolled(m)
        torch.cuda.synchronize()
        e = float((out - ref).abs().max())
        err, scale = max(err, e), max(scale, float(ref.abs().max()))
        check(torch.allclose(out, ref, rtol=KERNEL_RTOL, atol=KERNEL_ATOL),
              f"{tag}: kernel != plain on a {list(m.shape)} stack the solve "
              f"built: max|diff| {e:.3e}")
    log(f"{tag}: kernel matches plain (rtol {KERNEL_RTOL}, atol "
        f"{KERNEL_ATOL}) on the solve's {len(stacks)} preconditioner "
        f"stack(s) {sorted({tuple(m.shape) for m in stacks})}, max|diff| "
        f"{err:.3e} at max|inverse entry| {scale:.3e}")


def masters_equal(a, b) -> bool:
    import torch
    da, db = a.device_master, b.device_master
    return (torch.equal(da.pose, db.pose) and torch.equal(da.lm, db.lm)
            and torch.equal(da.prior, db.prior))


def agree_with_cpu(tag, eng_gpu, ate_gpu, eng_cpu, ate_cpu):
    """CUDA vs CPU state of the same run, within ``CPU_AGREE_ATOL``."""
    st_gpu, st_cpu = eng_gpu.get_rba_state(), eng_cpu.get_rba_state()
    check((st_gpu.num_edges, st_gpu.num_lms)
          == (st_cpu.num_edges, st_cpu.num_lms),
          f"{tag}: CUDA and CPU runs built different problems")
    ne, nl = st_gpu.num_edges, st_gpu.num_lms
    d_edge = float(np.abs(st_gpu.k2k_pose[:ne] - st_cpu.k2k_pose[:ne]).max())
    d_lm = float(np.abs(st_gpu.lm_state[:nl] - st_cpu.lm_state[:nl]).max())
    return d_edge, d_lm, abs(ate_gpu - ate_cpu)


def mean_device_step_ms(eng) -> float:
    return 1e3 * eng.profiler.mean(
        "define_new_keyframe.optimize_local_area.device_step")


def phase_config(num: int, name: str, card: str, bl):
    """Phases 7 and 8: warm-up, timed pass, CPU agreement and bitwise
    rerun of one config.  Returns the kernel's launches per block size in
    the timed pass, the timed pass's engine and the config's data."""
    t_phase = time.perf_counter()
    cfg = make_config(name)
    _, warm, _ = run_config(cfg, "cuda", WARMUP_KFS)
    log(f"[{num}] {name} warm-up ({WARMUP_KFS} KFs): {warm:.3f} s")
    reset_launch_counts(bl)
    eng, dt, ate = run_config(cfg, "cuda")
    launches = launches_by_d(bl)
    dm = eng.device_master
    check(dm.pose.is_cuda and dm.prior.is_cuda and dm.lm.is_cuda,
          f"{name} masters are not CUDA tensors")
    check(launches.get(3, 0) > 0,
          f"{name} never launched the spd_inverse kernel on [L, 3, 3]")
    kfs = eng.num_keyframes
    log(f"[{num}] {name} timed pass on {card}: {kfs} KFs in {dt:.3f} s = "
        f"{kfs / dt:.2f} KF/s, ATE {ate:.6f} m (bound {ATE_BOUND[name]}), "
        f"{eng.state.num_edges} edges, spd_inverse kernel launches "
        f"{sum(launches.values())} by block size {launches}, mean "
        f"device_step {mean_device_step_ms(eng):.3f} ms")
    check(ate <= ATE_BOUND[name], f"{name} ATE {ate} > bound")
    log(f"[{num}] {eng.profiler.report()}")
    eng_g, _, ate_g = run_config(cfg, "cuda", AGREE_KFS)
    eng_c, _, ate_c = run_config(cfg, "cpu", AGREE_KFS)
    d_edge, d_lm, d_ate = agree_with_cpu(name, eng_g, ate_g, eng_c, ate_c)
    log(f"[{num}] {name} first {AGREE_KFS} KFs, CUDA vs CPU: max|edge diff| "
        f"{d_edge:.3e}, max|landmark diff| {d_lm:.3e}, |ATE diff| "
        f"{d_ate:.3e} (atol {CPU_AGREE_ATOL})")
    check(max(d_edge, d_lm, d_ate) < CPU_AGREE_ATOL,
          f"{name} on CUDA disagrees with the same run on the CPU")
    eng_g2, _, ate_g2 = run_config(cfg, "cuda", AGREE_KFS)
    check(masters_equal(eng_g, eng_g2) and ate_g2 == ate_g,
          f"{name} masters differ between two runs")
    log(f"[{num}] {name} rerun of the first {AGREE_KFS} KFs on the card: "
        "pose, prior and landmark masters bitwise equal")
    log(f"[{num}] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return launches, eng, cfg


def pgo20k_problem(K=20000):
    """bench.py ``bench_pgo``'s problem (``bench.py:344-370``), unchanged:
    an SE(3) ring of K poses with 0.02-sigma odometry edges, K/100 exact
    chords, initial nodes perturbed by 0.3 per tangent component, seed 0."""
    from srba_tpu_torch.ops.np_lie import NpSE3

    rng = np.random.default_rng(0)
    th = 2 * np.pi * np.arange(K) / K
    gt = np.stack([NpSE3.pexp(np.asarray(
        [30 * np.cos(t), 30 * np.sin(t), np.sin(3 * t), 0, 0,
         t + np.pi / 2], np.float32)) for t in th])

    def rel(i, j):
        return NpSE3.compose(NpSE3.inverse(gt[i]), gt[j]).astype(np.float32)

    edges = [{"from": k - 1, "to": k,
              "rel_pose": NpSE3.retract(
                  rel(k - 1, k), rng.normal(0, 0.02, 6).astype(np.float32))}
             for k in range(1, K)]
    for c in range(K // 100):
        i = int(c * 100)
        j = (i + K // 2) % K
        edges.append({"from": i, "to": j, "rel_pose": rel(i, j)})
    nodes = np.stack([NpSE3.retract(gt[k],
                                    rng.normal(0, 0.3, 6).astype(np.float32))
                      for k in range(K)])
    nodes[0] = gt[0]
    return {"group": "SE3", "nodes": nodes, "edges": edges}


def phase_pgo20k(card: str, bl):
    """Phase 9: bench.py's 20k-node SE(3) PGO on the card.  Returns the
    kernel's launches per block size in the timed call."""
    from srba_tpu_torch.solver.global_graphslam import (
        PGOConfig, optimize_global_pose_graph)
    from srba_tpu_torch.utils.profiler import Profiler

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    prob = pgo20k_problem()
    K, E = len(prob["nodes"]), len(prob["edges"])
    log(f"[9] bench_pgo problem: {K} nodes, {E} edges, built in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = PGOConfig(group="SE3", max_outer=30, cg_iters=100,
                    abs_tol_per_edge=2e-5)
    t0 = time.perf_counter()
    G_warm, _ = optimize_global_pose_graph(prob, cfg, device="cuda")
    log(f"[9] warm call: {time.perf_counter() - t0:.3f} s")
    reset_launch_counts(bl)
    torch_sync()
    t0 = time.perf_counter()
    G, info = optimize_global_pose_graph(prob, cfg, device="cuda")
    torch_sync()
    dt = time.perf_counter() - t0
    launches = launches_by_d(bl)
    by_shape = dict(bl.spd_inverse_cuda.launches_by_shape)
    log(f"[9] timed call on {card}: {K} nodes / {E} edges SE3 in {dt:.3f} s, "
        f"err {info['err_init']:.6e} -> {info['err_final']:.6e}, "
        f"converged={info['converged']:.0f} iters={info['iters']:.0f} "
        f"cg_iters_total={info['cg_iters_total']:.0f} "
        f"escalations={info['escalations']:.0f}")
    log(f"[9] spd_inverse kernel launches by [B, d]: {shapes(by_shape)}")
    check(info["converged"] == 1.0, f"20k PGO not certified: {info}")
    check(info["err_final"] < info["err_init"], f"20k PGO no descent: {info}")
    check(set(by_shape) == {(32768, 6)} and by_shape[(32768, 6)] > 0,
          f"20k PGO kernel shapes {by_shape}, expected [32768, 6, 6]")
    check(np.array_equal(G, G_warm), "20k PGO nodes differ between runs")
    log("[9] warm and timed calls: nodes bitwise equal")
    prof = Profiler()
    with pgo_kernel_inputs() as stacks:
        t0 = time.perf_counter()
        G_p, info_p = optimize_global_pose_graph(prob, cfg, device="cuda",
                                                 profiler=prof)
        dt_p = time.perf_counter() - t0
    log(f"[9] profiled call (each scope waits for the device): "
        f"{dt_p:.3f} s; host syncs per solve "
        f"{prof.counters['pgo_host_syncs'] / prof.counters['pgo_solves']:.0f}"
        f", incidence width {prof.counters['pgo_incidence_width']}")
    log(f"[9] {prof.report()}")
    check(np.array_equal(G_p, G), "20k PGO nodes differ when profiled")
    check_kernel_on("[9]", bl, stacks)
    t0 = time.perf_counter()
    G_c, info_c = optimize_global_pose_graph(prob, cfg, device="cpu")
    d_node = float(np.abs(G_c - G).max())
    d_err = abs(info_c["err_final"] - info["err_final"]) / info["err_final"]
    log(f"[9] same solve on the CPU ({time.perf_counter() - t0:.1f} s): "
        f"iters {info_c['iters']:.0f}, cg_iters_total "
        f"{info_c['cg_iters_total']:.0f}; max|node diff| {d_node:.3e} "
        f"(atol {PGO_NODE_ATOL}), err_final rel diff {d_err:.3e} "
        f"(rtol {PGO_ERR_RTOL})")
    check(d_node < PGO_NODE_ATOL and d_err < PGO_ERR_RTOL,
          "20k PGO on CUDA disagrees with the CPU")
    log(f"[9] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_config4_pgo(eng, cfg4, card: str, bl):
    """Phase 10: config #4's global PGO on the timed pass's engine.  The
    engine's default solve (chordal init, pseudo-Huber) certifies config
    #4's map at its chordal initialization, with no LM iteration and so no
    kernel launch (the JAX package takes the same decision), so the phase
    first solves LM-PCG from the incremental map (chordal off, no
    write-back) and then makes the terminal ``optimize_global()`` with its
    write-back.  Returns the kernel's launches per block size in both
    calls."""
    from srba_tpu_torch import Observation
    from srba_tpu_torch.solver.global_graphslam import PGOConfig
    from srba_tpu_torch.utils.datasets import ate_rmse
    from srba_tpu_torch.utils.profiler import Profiler

    t_phase = time.perf_counter()
    world, ds, _, _, d, _ = cfg4

    def ate(G=None):
        if G is None:
            G, _ = eng.create_complete_spanning_tree(0)
        return float(ate_rmse(np.asarray(G)[:, :d],
                              world.gt_poses[:len(G), :d]))

    ate_before, err_before = ate(), eng.eval_overall_squared_error()
    reset_launch_counts(bl)
    prof = Profiler()
    torch_sync()
    with pgo_kernel_inputs() as stacks:
        t0 = time.perf_counter()
        G_lm, info_lm = eng.optimize_global(
            PGOConfig(group="SE2", robust_delta=0.1), write_back=False,
            profiler=prof)
        torch_sync()
        dt_lm = time.perf_counter() - t0
    by_shape_lm = dict(bl.spd_inverse_cuda.launches_by_shape)
    log(f"[10] config4 LM-PCG from the incremental map (chordal off, no "
        f"write-back, profiled: each scope waits for the device) on {card}: "
        f"{dt_lm:.3f} s, {eng.num_keyframes} nodes / {eng.state.num_edges} "
        f"edges, incidence width {prof.counters['pgo_incidence_width']}, "
        f"host syncs {prof.counters['pgo_host_syncs']}; ATE "
        f"{ate_before:.6f} -> {ate(G_lm):.6f} m; info {info_lm}; "
        f"spd_inverse kernel launches by [B, d]: {shapes(by_shape_lm)}")
    check(info_lm["converged"] == 1.0 and info_lm["iters"] >= 1,
          f"config4 LM-PCG not certified after an LM step: {info_lm}")
    check(by_shape_lm.get((256, 3), 0) == info_lm["iters"],
          f"config4 PGO kernel shapes {by_shape_lm}, expected [256, 3, 3] "
          "once per LM iteration")
    torch_sync()
    t0 = time.perf_counter()
    _, info = eng.optimize_global()
    torch_sync()
    dt = time.perf_counter() - t0
    launches = launches_by_d(bl)
    ate_after, err_after = ate(), eng.eval_overall_squared_error()
    log(f"[10] config4 optimize_global() on {card}: {dt:.3f} s; info {info}")
    log(f"[10] ATE {ate_before:.6f} -> {ate_after:.6f} m (bound "
        f"{ATE_BOUND['config4']}), eval_overall_squared_error "
        f"{err_before:.6e} -> {err_after:.6e}; spd_inverse kernel launches "
        f"in both calls by [B, d]: "
        f"{shapes(bl.spd_inverse_cuda.launches_by_shape)}")
    check(info["converged"] == 1.0, f"config4 PGO not certified: {info}")
    check(ate_after <= ATE_BOUND["config4"], f"config4 PGO ATE {ate_after}")
    check(err_after <= 1.05 * err_before + 1e-6,
          f"config4 PGO made the map worse: {err_before} -> {err_after}")
    n = eng.num_keyframes
    eng.define_new_keyframe([Observation(lm_id=n - 1, z=ds.odometry[-1])],
                            edge_init={n - 1: ds.odometry[-1]})
    eng.fence()
    check(eng.num_keyframes == n + 1 and bool(np.isfinite(
        eng.eval_overall_squared_error())),
        "config4: incremental step after the write-back failed")
    log(f"[10] one more keyframe after the write-back: {eng.num_keyframes} "
        "KFs, finite error")
    check_kernel_on("[10]", bl, stacks)
    log(f"[10] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return launches


def chordal_problem(K=120, radius=10.0, yaw_revolutions=4.0, seed=0):
    """tests/test_chordal.py's four-revolution SE(3) problem
    (``TestChordalSE3.test_four_revolutions_yaw_drift_converges``): a
    circle of K poses, 0.005-sigma consecutive edges, exact closures every
    10 poses plus (0, K-1), nodes dead-reckoned with a yaw bias that adds
    up to ``yaw_revolutions`` turns."""
    from srba_tpu_torch.ops.np_lie import NpSE3

    th = 2 * np.pi * np.arange(K) / K
    gt = np.stack([NpSE3.pexp(np.asarray(
        [radius * np.cos(t), radius * np.sin(t), 0, 0, 0, t + np.pi / 2],
        np.float32)) for t in th])
    rng = np.random.default_rng(seed)

    def rel(i, j):
        return NpSE3.compose(NpSE3.inverse(gt[i]), gt[j]).astype(np.float32)

    edges = [{"from": k - 1, "to": k, "rel_pose": NpSE3.retract(
        rel(k - 1, k), (rng.normal(0, 0.005, 6)).astype(np.float32))}
        for k in range(1, K)]
    for i, j in [(i, (i + K // 2) % K) for i in range(0, K, 10)] \
            + [(0, K - 1)]:
        edges.append({"from": i, "to": j, "rel_pose": rel(i, j)})
    bias = np.zeros(6, np.float32)
    bias[-1] = 2 * np.pi * yaw_revolutions / (K - 1)
    nodes = np.zeros_like(gt)
    nodes[0] = gt[0]
    for k in range(1, K):
        nodes[k] = NpSE3.compose(nodes[k - 1], NpSE3.retract(
            edges[k - 1]["rel_pose"], bias))
    return {"group": "SE3", "nodes": nodes.astype(np.float32),
            "edges": edges}, gt


def phase_chordal(card: str):
    """Phase 11: SE(3) chordal initialization on the card."""
    import torch

    from srba_tpu_torch.solver.chordal import _matrix_to_quat, _project_so
    from srba_tpu_torch.solver.global_graphslam import (
        PGOConfig, optimize_global_pose_graph)
    from srba_tpu_torch.tools.spd_inverse_bench import cuda_time_ms

    t_phase = time.perf_counter()
    prob, gt = chordal_problem()
    ate0 = float(np.sqrt(np.mean(np.sum(
        (prob["nodes"][:, :3] - gt[:, :3]) ** 2, -1))))
    cfg = PGOConfig(group="SE3", max_outer=40, cg_iters=100,
                    chordal_init=True, chordal_cg_iters=400)
    t0 = time.perf_counter()
    G, info = optimize_global_pose_graph(prob, cfg, device="cuda")
    dt = time.perf_counter() - t0
    ate = float(np.sqrt(np.mean(np.sum((G[:, :3] - gt[:, :3]) ** 2, -1))))
    log(f"[11] SE3 chordal + LM-PCG, {len(G)} nodes, 4 revolutions of yaw "
        f"drift: ATE {ate0:.3f} -> {ate:.6f} m (bound {CHORDAL_ATE_BOUND}) "
        f"in {dt:.3f} s; info {info}")
    check(ate < CHORDAL_ATE_BOUND, f"SE3 chordal ATE {ate}")
    rng = np.random.default_rng(1)
    for B in (256, 32768):
        M = torch.as_tensor(rng.normal(size=(B, 3, 3)).astype(np.float32),
                            device="cuda")
        R, _ = _project_so(M, 3)
        svd_ms = cuda_time_ms(lambda m: _project_so(m, 3), M, iters=20)
        q_ms = cuda_time_ms(_matrix_to_quat, R, iters=20)
        log(f"[11] [{B},3,3] on {card}: SVD projection {svd_ms * 1e3:.2f} "
            f"us, matrix-to-quaternion {q_ms * 1e3:.2f} us (median of 5 x "
            "20 calls)")
    log(f"[11] phase wall time {time.perf_counter() - t_phase:.1f} s")


def phase_config3(card: str, bl):
    """Phase 12: config #3 end to end, a warm and a timed pass of the whole
    run as bench.py makes them (the two passes' masters then compare
    bitwise).  Returns the kernel's launches per block size in the timed
    pass, the timed pass's engine and the config's data."""
    t_phase = time.perf_counter()
    cfg = make_config("config3")
    K = len(cfg[1].frames)
    with window_buckets() as buckets:
        eng_w, warm, _ = run_config(cfg, "cuda")
    log(f"[12] config3 warm pass ({eng_w.num_keyframes} KFs): {warm:.3f} s; "
        "window steps by padded (E, L, N) and LM iterations: "
        + ", ".join(f"{key} x{n}" for key, n in sorted(buckets.items())))
    reset_launch_counts(bl)
    eng, dt, ate = run_config(cfg, "cuda")
    launches = launches_by_d(bl)
    by_shape = dict(bl.spd_inverse_cuda.launches_by_shape)
    dm = eng.device_master
    check(dm.pose.is_cuda and dm.prior.is_cuda and dm.lm.is_cuda,
          "config3 masters are not CUDA tensors")
    check(set(launches) == {3} and launches[3] > 0,
          f"config3 kernel launches by block size {launches}, expected "
          "[L, 3, 3] only")
    closures = eng.state.num_edges - (K - 1)
    fits = {k: v for k, v in sorted(eng.profiler.counters.items())
            if k.startswith("closure_")}
    log(f"[12] config3 timed pass on {card}: {K} KFs in {dt:.3f} s = "
        f"{K / dt:.2f} KF/s, ATE before the global PGO {ate:.6f} m, "
        f"{eng.num_landmarks} landmarks, {eng.state.num_obs} observations, "
        f"{eng.state.num_edges} edges of which {closures} closure edges, "
        f"{len(eng._closure_pending)} weak fits still pending; closure "
        f"counters {fits}; host mirror {dm.sync_stats}")
    log(f"[12] spd_inverse kernel launches {sum(launches.values())} by "
        f"[B, d]: {shapes(by_shape)}; mean device_step "
        f"{mean_device_step_ms(eng):.3f} ms")
    check(closures >= 1, "config3 created no closure edge")
    log(f"[12] {eng.profiler.report()}")
    check(masters_equal(eng_w, eng),
          "config3 masters differ between the warm and timed passes")
    log("[12] warm and timed passes: pose, prior and landmark masters "
        "bitwise equal")
    eng_g, _, ate_g = run_config(cfg, "cuda", AGREE_KFS)
    eng_c, _, ate_c = run_config(cfg, "cpu", AGREE_KFS)
    d_edge, d_lm, d_ate = agree_with_cpu("config3", eng_g, ate_g, eng_c,
                                         ate_c)
    err_g = eng_g.eval_overall_squared_error()
    err_c = eng_c.eval_overall_squared_error()
    d_err = abs(err_g - err_c) / err_c
    log(f"[12] config3 first {AGREE_KFS} KFs, CUDA vs CPU: max|edge diff| "
        f"{d_edge:.3e}, max|landmark diff| {d_lm:.3e}, |ATE diff| "
        f"{d_ate:.3e} (atol {CONFIG3_ATE_AGREE}), total squared error "
        f"{err_g:.6e} vs {err_c:.6e}, rel diff {d_err:.3e}")
    check(d_ate < CONFIG3_ATE_AGREE,
          "config3 on CUDA disagrees with the same run on the CPU")
    lockstep_steps("[12] config3", cfg, AGREE_KFS)
    log(f"[12] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return launches, eng, cfg


def lockstep_steps(tag: str, cfg, num_kfs: int) -> None:
    """The config's first ``num_kfs`` keyframes on the card and on the CPU
    in lockstep, the card's masters set to the CPU's before each keyframe,
    so that each keyframe's window solve starts from the same state on
    both.  Checks each step's initial error (the residual chain on the same
    state) at ``STEP_ERR_INIT_RTOL`` and its final error at
    ``STEP_ERR_FINAL_RTOL``; prints how far the step's results lie apart
    (LM runs a capped number of iterations on windows with near-flat
    directions, where roundings move the state along them)."""
    import srba_tpu_torch as port
    from srba_tpu_torch.models.noise import NoiseIdentity

    _, ds, model, sigma, _, engine_kw = cfg
    engs = [port.SrbaEngine(model, noise=NoiseIdentity(sigma), device=dev,
                            **engine_kw) for dev in ("cuda", "cpu")]
    worst = {"err_init": 0.0, "err_final": 0.0, "state": 0.0}
    forks = []
    for k, frame in enumerate(ds.frames[:num_kfs]):
        g, c = engs[0].device_master, engs[1].device_master
        for a, b in ((g.pose, c.pose), (g.prior, c.prior), (g.lm, c.lm)):
            a.copy_(b)
        infos = []
        for eng in engs:
            info = eng.define_new_keyframe(
                [port.Observation(lm_id=m, z=z) for m, z in frame],
                edge_init={k - 1: ds.odometry[k - 1]} if k else None)
            infos.append(info.optimize_results)
        if k == 0:
            continue   # the first keyframe has nothing to solve
        ig, ic = ({key: float(v) for key, v in dict(i).items()}
                  for i in infos)
        for key in ("err_init", "err_final"):
            worst[key] = max(worst[key], abs(ig[key] - ic[key]) / ic[key])
        ne, nl = g.num_edges, g.num_lms
        ds_k = max(float((g.pose[:ne].cpu() - c.pose[:ne]).abs().max()),
                   float((g.lm[:nl].cpu() - c.lm[:nl]).abs().max()))
        worst["state"] = max(worst["state"], ds_k)
        if ds_k > CPU_AGREE_ATOL:
            forks.append(f"KF {k}: {ds_k:.2e} (lam {ig['lam']:.0e} / "
                         f"{ic['lam']:.0e}, err_final {ig['err_final']:.6e} "
                         f"/ {ic['err_final']:.6e})")
    log(f"{tag} lockstep, each KF's step from the same masters on the card "
        f"and the CPU, first {num_kfs} KFs: max rel diff err_init "
        f"{worst['err_init']:.3e} (rtol {STEP_ERR_INIT_RTOL}), err_final "
        f"{worst['err_final']:.3e} (rtol {STEP_ERR_FINAL_RTOL}); max|state "
        f"diff| after a step {worst['state']:.3e}; steps apart by more than "
        f"{CPU_AGREE_ATOL}: {forks or 'none'}")
    check(worst["err_init"] < STEP_ERR_INIT_RTOL
          and worst["err_final"] < STEP_ERR_FINAL_RTOL,
          f"{tag}: a window step on CUDA disagrees with the CPU's")


def phase_config3_pgo(eng, cfg3, card: str, bl):
    """Phase 13: config #3's terminal ``optimize_global()`` (chordal init,
    pseudo-Huber 0.1, the pending weak fits flushed first) on phase 12's
    timed engine, with its write-back.  Returns the kernel's launches per
    block size."""
    from srba_tpu_torch import Observation
    from srba_tpu_torch.ops.np_lie import NpSE3
    from srba_tpu_torch.utils.datasets import ate_rmse

    t_phase = time.perf_counter()
    world, ds = cfg3[0], cfg3[1]
    G0, _ = eng.create_complete_spanning_tree(0)
    ate_before = float(ate_rmse(G0[:, :3], world.gt_poses[:, :3]))
    err_before = eng.eval_overall_squared_error()
    reset_launch_counts(bl)
    torch_sync()
    with pgo_kernel_inputs() as stacks:
        t0 = time.perf_counter()
        G, info = eng.optimize_global()
        torch_sync()
        dt = time.perf_counter() - t0
    by_shape = dict(bl.spd_inverse_cuda.launches_by_shape)
    launches = launches_by_d(bl)
    ate = float(ate_rmse(np.asarray(G)[:, :3], world.gt_poses[:, :3]))
    err_after = eng.eval_overall_squared_error()
    log(f"[13] config3 optimize_global() on {card}: {len(G)} nodes / "
        f"{eng.state.num_edges} edges in {dt:.3f} s; err "
        f"{info['err_init']:.6e} -> {info['err_final']:.6e}, "
        f"converged={info['converged']:.0f} iters={info['iters']:.0f} "
        f"cg_iters_total={info['cg_iters_total']:.0f} "
        f"escalations={info['escalations']:.0f}")
    log(f"[13] ATE {ate_before:.6f} -> {ate:.6f} m (bound "
        f"{ATE_BOUND['config3']}), eval_overall_squared_error "
        f"{err_before:.6e} -> {err_after:.6e}; spd_inverse kernel launches "
        f"by [B, d]: {shapes(by_shape)}")
    check(info["converged"] == 1.0, f"config3 PGO not certified: {info}")
    check(ate <= ATE_BOUND["config3"], f"config3 PGO ATE {ate} > bound")
    check(len(by_shape) == 1 and all(d == 6 and B >= len(G)
                                     for B, d in by_shape)
          and sum(by_shape.values()) == info["iters"] >= 1,
          f"config3 PGO kernel shapes {by_shape}, expected [Kp, 6, 6] once "
          "per LM iteration")
    check_kernel_on("[13]", bl, stacks)
    n = eng.num_keyframes
    eng.define_new_keyframe(
        [Observation(lm_id=m, z=z) for m, z in ds.frames[-1]],
        edge_init={n - 1: NpSE3.identity()})
    eng.fence()
    check(eng.num_keyframes == n + 1 and bool(np.isfinite(
        eng.eval_overall_squared_error())),
        "config3: incremental step after the write-back failed")
    log(f"[13] one more keyframe after the write-back: {eng.num_keyframes} "
        "KFs, finite error")
    log(f"[13] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return launches


def torch_sync() -> None:
    import torch
    torch.cuda.synchronize()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    from srba_tpu_torch.ops import block_linalg as bl

    t_start = time.perf_counter()
    # -- 1. card and flags ---------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"[1] card: {card}")
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"device 0: {torch.cuda.get_device_name(0)}")

    def check_flags():
        check(torch.backends.cuda.matmul.allow_tf32 is False
              and torch.backends.cudnn.allow_tf32 is False
              and torch.get_float32_matmul_precision() == "highest",
              "TF32 must stay off")

    check_flags()
    log("[1] TF32: matmul.allow_tf32=False cudnn.allow_tf32=False "
        "float32_matmul_precision=highest")

    # -- 2. kernel build -----------------------------------------------------
    from srba_tpu_torch.tools import spd_inverse_bench as kb
    t0 = time.perf_counter()
    bl.load_kernel_library()
    log(f"[2] spd_inverse kernel built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    report = bl.ptxas_report(bl.build_kernel_library()).read_text()
    ptxas = kb.ptxas_summary(report)
    for name, regs, smem, spill_st, spill_ld in ptxas:
        log(f"[2] ptxas -v {name}: {regs} registers, {smem} B shared "
            f"memory, {spill_st} B spill stores, {spill_ld} B spill loads")
    # Two kernels (aligned or not) per block size.
    check(len(ptxas) == 8, f"ptxas report lists {len(ptxas)} kernels, not 8")
    tiles = {d: bl.kernel_tile(d) for d in (1, 2, 3, 6)}
    check(all(t > 0 for t in tiles.values()) and bl.kernel_tile(4) == 0,
          f"blocks per CTA {tiles}")
    log("[2] blocks per CTA: " + ", ".join(f"d={d} {t}"
                                           for d, t in tiles.items()))

    # -- 3. kernel vs plain version on the card ------------------------------
    t_phase = time.perf_counter()
    max_err = 0.0
    # The B of the paths: 64 and 256 (window buckets), 256 (config #4's
    # PGO), 512 (config #3's PGO), 32768 (pgo20k); others test odd and large
    # stacks and the edges of a CTA's T blocks (T - 1, T + 1, 2T + 1).
    kernel_shapes = [(B, d) for d in (1, 2, 3, 6)
                     for B in (1, 7, 300, 64, 256, 512, 4096, 32768,
                               131072)]
    kernel_shapes += [(B, d) for d, T in tiles.items()
                      for B in (T - 1, T + 1, 2 * T + 1)]
    for B, d in kernel_shapes:
        m = torch.as_tensor(kb.spd_stack(B, d), device="cuda")
        out = bl.spd_inverse_cuda(m)
        ref = bl.spd_inverse_unrolled(m)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        max_err = max(max_err, err)
        check(torch.allclose(out, ref, rtol=KERNEL_RTOL, atol=KERNEL_ATOL),
              f"kernel != plain at [{B},{d},{d}]: max|diff| {err:.3e}")
        log(f"[3] [{B},{d},{d}] output sha256 {kb.output_digest(out)}")
    m = torch.as_tensor(kb.spd_stack(8192, 6, cond=6.0), device="cuda")
    err = float((bl.spd_inverse_cuda(m) - bl.spd_inverse_unrolled(m))
                .abs().max())
    max_err = max(max_err, err)
    check(err < 1e-3, f"kernel != plain at [8192,6,6]: {err:.3e}")
    # A view one block into a stack: 36 B off 16-byte alignment at d = 3.
    big = torch.as_tensor(kb.spd_stack(4098, 3), device="cuda")
    view_out = bl.spd_inverse_cuda(big[1:])
    check(torch.equal(view_out, bl.spd_inverse_cuda(big[1:].clone()))
          and torch.allclose(view_out, bl.spd_inverse_unrolled(big[1:]),
                             rtol=KERNEL_RTOL, atol=KERNEL_ATOL),
          "kernel on a view at a 36-byte offset")
    log(f"[3] kernel matches plain (rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}) "
        f"at {len(kernel_shapes)} shapes, d in {{1,2,3,6}}; "
        f"[8192,6,6] max|diff| {err:.3e} (< 1e-3); "
        f"max|diff| overall {max_err:.3e}; a [4097,3,3] view at a 36-byte "
        "offset bitwise equal to the kernel on an aligned copy")
    timer = kb.KernelTimer()
    times = {}
    for B, d in kb.SHAPES:
        times[(B, d)] = kb.measure_shape(B, d, timer)
        log(f"[3] {kb.format_shape(B, d, times[(B, d)])} (on {card})")
    log(f"[3] phase wall time {time.perf_counter() - t_phase:.1f} s")

    # -- 4. large window solve -----------------------------------------------
    t_phase = time.perf_counter()
    from srba_tpu_torch.solver.lm import SolverConfig, make_lm_solver
    batch = large_window_batch()
    cfg = SolverConfig(obs_model="RangeBearing2D", pose_group="SE2",
                       lm_type="Euclidean2D", max_depth=4, max_iters=6,
                       rel_tol=0.0)
    solve, _ = make_lm_solver(cfg, device="cuda")
    reset_launch_counts(bl)
    t0 = time.perf_counter()
    _, _, info = solve(batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, _, info = solve(batch)
    torch.cuda.synchronize()
    dt_warm = time.perf_counter() - t0
    info = {k: float(v) for k, v in info.items()}
    check(bool(np.isfinite(info["err_final"]))
          and info["err_final"] < info["err_init"],
          f"large window did not descend: {info}")
    check(sum(launches_by_d(bl).values()) > 0,
          "large window never launched the spd_inverse kernel")
    log(f"[4] large window E=256 L=4096 N=16384 D=4, 6 LM iterations: "
        f"err {info['err_init']:.6e} -> {info['err_final']:.6e}, "
        f"iters {info['iters']:.0f}, first call {dt:.3f} s, "
        f"second call {dt_warm:.3f} s")
    log(f"[4] phase wall time {time.perf_counter() - t_phase:.1f} s")

    # -- 5. config #1 end to end ---------------------------------------------
    t_phase = time.perf_counter()
    cfg1 = make_config("config1")
    _, warm, _ = run_config(cfg1, "cuda", WARMUP_KFS)
    log(f"[5] config #1 warm-up ({WARMUP_KFS} KFs): {warm:.3f} s")
    reset_launch_counts(bl)
    eng, dt, ate = run_config(cfg1, "cuda")
    launches = {"config1": launches_by_d(bl)}
    dm = eng.device_master
    check(dm.pose.is_cuda and dm.prior.is_cuda and dm.lm.is_cuda,
          "config #1 masters are not CUDA tensors")
    check(launches["config1"].get(2, 0) > 0,
          "config #1 never launched the spd_inverse kernel on [L, 2, 2]")
    kfs = eng.num_keyframes
    log(f"[5] config #1 timed pass on {card}: {kfs} KFs in {dt:.3f} s = "
        f"{kfs / dt:.2f} KF/s, ATE {ate:.6f} m (bound "
        f"{ATE_BOUND['config1']}), spd_inverse kernel launches "
        f"{sum(launches['config1'].values())} by block size "
        f"{launches['config1']}")
    check(ate <= ATE_BOUND["config1"], f"config #1 ATE {ate} > bound")
    log(f"[5] {eng.profiler.report()}")
    eng_cpu, _, ate_cpu = run_config(cfg1, "cpu")
    d_edge, d_lm, d_ate = agree_with_cpu("config #1", eng, ate, eng_cpu,
                                         ate_cpu)
    log(f"[5] same run on the CPU: ATE {ate_cpu:.6f} m; CUDA vs CPU "
        f"max|edge diff| {d_edge:.3e}, max|landmark diff| {d_lm:.3e}, "
        f"|ATE diff| {d_ate:.3e} (atol {CPU_AGREE_ATOL})")
    check(max(d_edge, d_lm, d_ate) < CPU_AGREE_ATOL,
          "config #1 on CUDA disagrees with the same run on the CPU")
    log(f"[5] phase wall time {time.perf_counter() - t_phase:.1f} s")

    # -- 6. determinism -------------------------------------------------------
    t_phase = time.perf_counter()
    eng2, _, ate2 = run_config(cfg1, "cuda")
    check(masters_equal(eng, eng2) and ate2 == ate,
          "config #1 masters differ between two runs")
    log("[6] config #1 rerun: pose, prior and landmark masters bitwise "
        "equal to the timed run's")
    log(f"[6] phase wall time {time.perf_counter() - t_phase:.1f} s")
    check_flags()

    # -- 7. config #2, 8. config #4 -------------------------------------------
    launches["config2"], _, _ = phase_config(7, "config2", card, bl)
    launches["config4"], eng4, cfg4 = phase_config(8, "config4", card, bl)
    check_flags()

    # -- 9. 20k-node SE(3) PGO, 10. config #4's optimize_global, 11. chordal
    launches["pgo20k"] = phase_pgo20k(card, bl)
    check_flags()
    launches["config4_pgo"] = phase_config4_pgo(eng4, cfg4, card, bl)
    check_flags()
    phase_chordal(card)
    check_flags()

    # -- 12. config #3 end to end, 13. its global PGO ------------------------
    launches["config3"], eng3, cfg3 = phase_config3(card, bl)
    check_flags()
    launches["config3_pgo"] = phase_config3_pgo(eng3, cfg3, card, bl)
    check_flags()

    # The main path's shape: config #1's Schur blocks.
    main = times[(64, 2)]
    log(json.dumps({"kernels": [{
        "name": "spd_inverse",
        "route": "cuda",
        "source": "srba_tpu_torch/csrc/spd_inverse.cu",
        "replaces": "srba_tpu/ops/block_linalg.py:84",
        "launches": sum(sum(v.values()) for v in launches.values()),
        "launches_by_path": {k: sum(v.values())
                             for k, v in launches.items()},
        "d_by_path": {k: sorted(v) for k, v in launches.items()},
        "max_abs_err": max_err,
        "shape": "[64,2,2]",
        # ms, plain_ms and library_ms: time per call, one method for all.
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_us"] / 1e3,
        "bound_by": "bytes",
        "library_ms": main["library_ms"],
        # The kernel's device time per launch, in a CUDA graph.
        "cold_ms": main["cold_ms"],
        "warm_ms": main["warm_ms"],
        "ms_by_shape": {f"[{B},{d},{d}]": r for (B, d), r in times.items()},
    }]}))
    log(f"total wall time {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
