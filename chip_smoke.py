#!/usr/bin/env python3
"""Smoke run of the srba_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. card and flags: the card's name and power limit, torch version, TF32 off;
2. build of the hand-written CUDA kernel (SPD block inverse) from source;
3. the kernel against its plain torch version on the card, at the solver's
   shapes, with times of both;
4. a large window solve (E=256 edges, L=4096 landmarks, N=16384
   observations, depth 4) for 6 LM iterations;
5. config #1 end to end (2D range-bearing SE(2), 100-keyframe loop, the
   data and parameters of bench.py's headline config) through
   ``SrbaEngine(device="cuda")``: warm-up pass, timed pass with the kernel's
   launch count, ATE bound, agreement with the same run on the CPU;
6. determinism: a third run's device masters bitwise equal to the timed
   run's.

The line before the last is the card as ``nvidia-smi`` names it; the JSON
line before that lists the kernels; the last line is the result JSON.
Imports nothing of JAX: the machine it targets has none.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

ATE_BOUND_CONFIG1 = 0.16          # bench.py ATE_BOUNDS["config1_rb2d"]
KERNEL_RTOL, KERNEL_ATOL = 2e-4, 2e-5
# Port-vs-port (CUDA vs CPU) agreement on config #1: the e2e parity
# tolerance of tests/test_torch_e2e_rb2d.py.
CPU_AGREE_ATOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    """A phase's check: raises (so the script exits non-zero) if it fails."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def spd_stack(B, d, seed=0, cond=5.0):
    """SPD test stacks as in tests/test_block_linalg.py."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, d, d)).astype(np.float32)
    return A @ A.transpose(0, 2, 1) + cond * np.eye(d, dtype=np.float32)


def cuda_time_ms(fn, x, iters=200, repeats=5):
    """Median over ``repeats`` of the mean time per call of ``fn(x)`` over
    ``iters`` back-to-back calls, by CUDA events (warmed up first)."""
    import torch
    for _ in range(10):
        fn(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn(x)
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / iters)
    return statistics.median(times)


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


def run_config1(device: str):
    """bench.py's config #1 through the port; returns (engine, seconds,
    ATE).  The timed section ends in ``fence()``, a device synchronize."""
    import srba_tpu_torch as port
    from srba_tpu_torch.models.noise import NoiseIdentity
    from srba_tpu_torch.utils.datasets import (ate_rmse, make_world_loop_2d,
                                               observe)

    K = 100
    world = make_world_loop_2d(num_kfs=K, radius=10.0, num_landmarks=180,
                               seed=11)
    ds = observe(world, "RangeBearing2D", noise_std=0.005, sensor_range=6.0,
                 odo_noise_std=0.01, seed=11)
    eng = port.SrbaEngine(
        "RangeBearing2D", noise=NoiseIdentity(0.005),
        params=port.SrbaParams(max_tree_depth=4, max_optimize_depth=4),
        device=device)
    t0 = time.perf_counter()
    for k, frame in enumerate(ds.frames):
        obs = [port.Observation(lm_id=m, z=z) for m, z in frame]
        edge_init = {k - 1: ds.odometry[k - 1]} if k > 0 else None
        eng.define_new_keyframe(obs, edge_init=edge_init)
    eng.fence()
    dt = time.perf_counter() - t0
    G, _ = eng.create_complete_spanning_tree(0)
    ate = float(ate_rmse(np.asarray(G)[:, :2], world.gt_poses[:, :2]))
    return eng, dt, ate


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    from srba_tpu_torch.ops import block_linalg as bl

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
    t0 = time.perf_counter()
    bl.load_kernel_library()
    log(f"[2] spd_inverse kernel built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")

    # -- 3. kernel vs plain version on the card ------------------------------
    max_err = 0.0
    shapes = [(B, d) for d in (1, 2, 3, 6)
              for B in (1, 7, 300, 64, 4096, 131072)]
    for B, d in shapes:
        m = torch.as_tensor(spd_stack(B, d), device="cuda")
        out = bl.spd_inverse_cuda(m)
        ref = bl.spd_inverse_unrolled(m)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        max_err = max(max_err, err)
        check(torch.allclose(out, ref, rtol=KERNEL_RTOL, atol=KERNEL_ATOL),
              f"kernel != plain at [{B},{d},{d}]: max|diff| {err:.3e}")
    m = torch.as_tensor(spd_stack(8192, 6, cond=6.0), device="cuda")
    err = float((bl.spd_inverse_cuda(m) - bl.spd_inverse_unrolled(m))
                .abs().max())
    max_err = max(max_err, err)
    check(err < 1e-3, f"kernel != plain at [8192,6,6]: {err:.3e}")
    log(f"[3] kernel matches plain (rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}) "
        f"at {len(shapes)} shapes, d in {{1,2,3,6}}; "
        f"[8192,6,6] max|diff| {err:.3e} (< 1e-3); "
        f"max|diff| overall {max_err:.3e}")
    times = {}
    for B, d in ((64, 2), (4096, 2), (131072, 6)):
        m = torch.as_tensor(spd_stack(B, d), device="cuda")
        k_ms = cuda_time_ms(bl.spd_inverse_cuda, m)
        p_ms = cuda_time_ms(bl.spd_inverse_unrolled, m)
        times[(B, d)] = (k_ms, p_ms)
        log(f"[3] [{B},{d},{d}]: kernel {k_ms * 1e3:.2f} us, "
            f"plain torch {p_ms * 1e3:.2f} us (median of 5 x 200 calls)")

    # -- 4. large window solve -----------------------------------------------
    from srba_tpu_torch.solver.lm import SolverConfig, make_lm_solver
    batch = large_window_batch()
    cfg = SolverConfig(obs_model="RangeBearing2D", pose_group="SE2",
                       lm_type="Euclidean2D", max_depth=4, max_iters=6,
                       rel_tol=0.0)
    solve, _ = make_lm_solver(cfg, device="cuda")
    n0 = bl.spd_inverse_cuda.launches
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
    check(bl.spd_inverse_cuda.launches > n0,
          "large window never launched the spd_inverse kernel")
    log(f"[4] large window E=256 L=4096 N=16384 D=4, 6 LM iterations: "
        f"err {info['err_init']:.6e} -> {info['err_final']:.6e}, "
        f"iters {info['iters']:.0f}, first call {dt:.3f} s, "
        f"second call {dt_warm:.3f} s")

    # -- 5. config #1 end to end ---------------------------------------------
    _, warm, ate_w = run_config1("cuda")
    log(f"[5] config #1 warm-up pass: {warm:.3f} s, ATE {ate_w:.6f} m")
    bl.spd_inverse_cuda.launches = 0
    eng, dt, ate = run_config1("cuda")
    launches = bl.spd_inverse_cuda.launches
    dm = eng.device_master
    check(dm.pose.is_cuda and dm.prior.is_cuda and dm.lm.is_cuda,
          "config #1 masters are not CUDA tensors")
    check(launches > 0, "config #1 never launched the spd_inverse kernel")
    kfs = eng.num_keyframes
    log(f"[5] config #1 timed pass on {card}: {kfs} KFs in {dt:.3f} s = "
        f"{kfs / dt:.2f} KF/s, ATE {ate:.6f} m (bound {ATE_BOUND_CONFIG1}), "
        f"spd_inverse kernel launches {launches}")
    check(ate <= ATE_BOUND_CONFIG1, f"config #1 ATE {ate} > bound")
    log(f"[5] {eng.profiler.report()}")
    eng_cpu, dt_cpu, ate_cpu = run_config1("cpu")
    st_gpu, st_cpu = eng.get_rba_state(), eng_cpu.get_rba_state()
    ne, nl = st_gpu.num_edges, st_gpu.num_lms
    d_edge = float(np.abs(st_gpu.k2k_pose[:ne] - st_cpu.k2k_pose[:ne]).max())
    d_lm = float(np.abs(st_gpu.lm_state[:nl] - st_cpu.lm_state[:nl]).max())
    log(f"[5] same run on the CPU: ATE {ate_cpu:.6f} m; CUDA vs CPU "
        f"max|edge diff| {d_edge:.3e}, max|landmark diff| {d_lm:.3e}, "
        f"|ATE diff| {abs(ate - ate_cpu):.3e} (atol {CPU_AGREE_ATOL})")
    check(d_edge < CPU_AGREE_ATOL and d_lm < CPU_AGREE_ATOL
          and abs(ate - ate_cpu) < CPU_AGREE_ATOL,
          "config #1 on CUDA disagrees with the same run on the CPU")

    # -- 6. determinism -------------------------------------------------------
    eng2, _, ate2 = run_config1("cuda")
    dm2 = eng2.device_master
    same = (torch.equal(dm.pose, dm2.pose) and torch.equal(dm.lm, dm2.lm)
            and torch.equal(dm.prior, dm2.prior))
    check(same and ate2 == ate, "config #1 masters differ between two runs")
    log("[6] config #1 rerun: pose, prior and landmark masters bitwise "
        "equal to the timed run's")
    check_flags()

    k_ms, p_ms = times[(64, 2)]
    log(json.dumps({"kernels": [{
        "name": "spd_inverse",
        "route": "cuda",
        "source": "srba_tpu_torch/csrc/spd_inverse.cu",
        "replaces": "srba_tpu/ops/block_linalg.py:84",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
