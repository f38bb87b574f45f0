#!/usr/bin/env python3
"""Smoke run of the srba_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py                  # phases 1-23
    python3 chip_smoke.py --config5-full   # phases 1-3, then config #5
                                           # unreduced (5000 keyframes)
    python3 chip_smoke.py --bucket-pairs   # phases 1-3, then the window
                                           # variants on configs #1, #2

Phases (any failure raises and the script exits non-zero):

1. card and flags: the card's name and power limit, torch version, TF32 off;
2. build of the native C++ window builder (its g++ command, library and
   hash; from here on every device-master engine the script, the CLI or a
   tutorial makes must build its windows with it) and of the hand-written
   CUDA kernel (SPD block inverse) from source, with nvcc's ``-Xptxas -v``
   registers, shared memory and spills per kernel, and the blocks each
   CTA takes;
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
   a warm pass and a timed pass of the whole run, KF/s, window buckets,
   edges with the
   closure edges apart, closure fits by outcome and weak fits flushed, the
   kernel's launches by shape, the profiler table with the host mirror's
   prefetch hits and misses, the two passes' masters bitwise equal, the
   first 20 keyframes on the CPU against the card (ATE), and those
   keyframes' window steps started from the same state on both (errors);
13. config #3's terminal ``optimize_global()`` on the timed pass's engine:
   certification, error and iterations, ATE bound, the kernel on
   ``[Kp, 6, 6]`` held against its plain version on the stacks the solve
   built, and one more keyframe after the write-back;
14. config #5 (monocular SE(3) with the camera mounted on the robot,
   landmarks by deferred two-view triangulation, robust kernel,
   local-areas edge policy, loop closures by multi-start PnP; bench.py's
   data, parameters and calls) at 1000 keyframes with its periodic
   ``optimize_global(periodic=True, use_edge_info=True)`` every 250 (bench:
   5000 and 1250): KF/s, each periodic solve, edges with the closure edges
   apart, closure fits by outcome, landmarks materialized and pending,
   window buckets, the kernel's launches by shape, the profiler table; a
   rerun of the first 100 keyframes with masters bitwise equal to the
   drive's there; the first 20 keyframes on the CPU against the card (ATE,
   the materialized landmarks identical, ``lockstep_steps``);
15. config #5's terminal ``optimize_global(use_edge_info=True)`` on phase
   14's engine: certification, ATE bound, closure count, the kernel on
   ``[1024, 6, 6]`` held against its plain version on the stacks the solve
   built, and one more keyframe after the write-back;
16. config #1 in the host-window engine mode
   (``SrbaEngine(device_master=False)``: each window uploaded, solved and
   fetched in one download, written into the host state), bench.py's data
   and parameters after the same warm-up as phase 5: KF/s, mean
   ``device_solve`` and ``write_back``, the kernel's launches by shape, ATE
   bound, the same edges as phase 5's device-master drive, error and ATE
   within the JAX package's master-vs-host tolerances of phase 5's, a
   bitwise-equal rerun;
17. the solver variants — one-hot and segmented normal equations under the
   Schur solver, and the no-Schur solver — on phase 4's large window and on
   a config #2 window bucket: ``err_final`` agreement, a bitwise rerun of
   the segmented solve, the config #2 bucket on the CPU against the card,
   the time per solve of each, and no kernel launch by the no-Schur solver;
18. ``refine_map(sweeps=3)`` (the map-parallel sweeps: every window of a
   red-black phase in one batched solve, the kernel once per LM iteration
   on all their landmark blocks ``[W*L, l, l]``) on configs #1 and #2 built
   from raw odometry, on the card and on the CPU from the same state: the
   error below half the start, card and CPU within rel 1e-3, a bitwise
   rerun, windows and buckets per phase, launches by shape, time per
   sweep, the kernel held to its plain version on the sweeps' own stacks
   and timed at their shapes; then ``refine_map(sweeps=2)`` on phase 5's
   optimized map (error at most 1.05 times before) and one more keyframe;
19. the adaptive ``LocalAreasVar1`` policy on tests/test_ecps.py's
   two-revolution loop (80 keyframes) on the card and on the CPU:
   identical centers, keyframe areas and edges, ATE bound, at most one
   center opened on the second revolution, closure edges;
20. the ``srba_slam_torch`` CLI in this process
   (``srba_tpu_torch.cli.main``): (a) config #1's data written as dataset
   and ground-truth files and run with phase 5's engine and every output
   (metrics, g2o, scene JSON, HTML, checkpoint, profile): phase 5's
   edges, landmarks, ATE and kernel launches by shape, and its state
   bitwise when the files round-trip exactly; (b) stopped at KF 50 with a
   checkpoint and resumed to KF 100 (ATE within 0.01 m of (a)), and the
   checkpoint loaded on the card and saved again bitwise; (c) (a)'s
   exported map read back, ``--pgo-g2o`` on phase 19's var1 map (a loop:
   certified after at least one LM iteration, the error lower), then on
   phase 9's
   problem written as g2o text (read back equal to phase 9's arrays): the
   iterations, certification and error of the same solve on phase 9's
   arrays (the CLI's settings are the JAX CLI's, not bench_pgo's), and
   phase 9's error beside it, the kernel on
   ``[32768, 6, 6]`` held against its plain version on that solve's
   stacks;
21. the six tutorials (``srba_tpu_torch/examples``), ``main(device=
   "cuda")`` at their own sizes, each with its wall time;
22. the mesh paths (``srba_tpu_torch.parallel``) in this process on a
   world of one rank (NCCL): config #1 through ``SrbaEngine(
   device_master=False, mesh=make_mesh())`` (tables, ATE and every window
   solve's info bitwise phase 16's), pgo20k with ``mesh=`` (nodes bitwise
   phase 9's), config #4's ``optimize_global(mesh=...)`` on phase 8's map
   from a checkpoint (its LM-PCG and terminal calls bitwise phase 10's),
   ``refine_map(mesh=...)`` on config #1 (masters bitwise phase 18's);
   each with the kernel held to plain on the stacks it built and its
   all-reduce rounds per solve with their mean time;
23. a two-rank gloo ring on the one card (this script in two more
   processes, ``--ring-worker``): config #1 through ``MultiHostEngine``
   with ``broadcast_batch`` 1 and 4 (rank 0 feeds bench.py's 100 KFs,
   rank 1 serves: 100 KFs served, replicas bitwise equal, batch 4 bitwise
   batch 1, ATE within its bound and 2e-3 m of phase 22's, the kernel on
   ``[64,2,2]`` held to plain in each rank; KF/s, broadcast time per KF,
   all-reduce time per LM iteration), the edge-sharded pgo20k (certified,
   error within rel 1e-3 of phase 9's, nodes bitwise across ranks) and
   the window-sharded ``refine_map`` on config #1 (error below half its
   start and within rel 3e-2 of phase 18's, masters bitwise across
   ranks).  A rank that
   fails or outlives its time limit fails the phase.

With ``--config5-full`` phases 4-23 are skipped and config #5 runs as
``bench.py``'s ``bench_config5`` does (5000 keyframes, periodic solves
every 1250, the terminal solve, ATE bound 1.0 m), printing bench's report
line.

With ``--bucket-pairs`` phases 4-23 are skipped and configs #1 and #2 run
four rounds each of three window variants, interleaved: the native core
padded by the engine's ratchet (the default), the Python builder with the
same ratchet (no g++), and the native core with no ratchet (each window at
its own bucket); each run's KF/s, mean ``device_step`` and ``window_build``
and buckets, and the means per variant.

Every phase prints its wall time.  The line before the last is the card as
``nvidia-smi`` names it; the JSON line before that lists the kernels; the
last line is the result JSON.  Imports nothing of JAX: the machine it
targets has none.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np

# bench.py ATE_BOUNDS["config1_rb2d"], ["config2_rb3d"], ["config3_stereo"]
# (after its global PGO), ["config4_graphslam"], ["config5_mono5k"]; config
# #5 at 1000 keyframes: tests/test_midscale_regression.py's 0.8 m.
ATE_BOUND = {"config1": 0.16, "config2": 0.18, "config3": 0.25,
             "config4": 0.04, "config5_1k": 0.8, "config5": 1.0}
# Config #5: bench.py runs 5000 keyframes and refines globally after every
# 1250th; phase 14 cuts both by 5.  tests/test_midscale_regression.py asks
# for at least 10 closure edges at 1000 keyframes.
CONFIG5_KFS, CONFIG5_REFINE_EVERY, CONFIG5_MIN_CLOSURES = 1000, 250, 10
CONFIG5_FULL_KFS, CONFIG5_FULL_REFINE_EVERY = 5000, 1250
RERUN_KFS = 100
# Config #5, CUDA vs CPU over the first 20 keyframes.  A monocular window's
# capped LM run (6 iterations, the robust kernel, a depth gauge per
# landmark seen from nearby keyframes only) can end in another basin when
# its start moves by a rounding.  The limits come from the CPU against
# itself with the masters nudged by 1e-7 or 1e-6 (relative), and from
# deliberate faults in the step (tests/test_torch_midscale.py::
# test_config5_rounding_spread, PERF.md §6):
# - each keyframe's step from the same masters: the median over the steps
#   of the final errors' relative difference (nudged 2.3e-5..7.3e-5;
#   robust weights dropped or taken without their square root 6.2e-4 and
#   6.3e-4, Schur inverse 1e-3 off 0.41), and its largest (nudged up to
#   0.70: KF 18's step forks);
# - the free-running ATE: the widest gap between two nudged runs (2.1e-2).
CONFIG5_STEP_MEDIAN_RTOL, CONFIG5_STEP_MAX_RTOL = 3e-4, 2.0
CONFIG5_ATE_AGREE = 2.2e-2
# The JAX package on the CPU on phase 14's data and calls (1000 KFs, the
# periodic solves, the terminal one): tests/test_torch_midscale.py::
# test_config5_bench_calls[1000-0.8].
JAX_CPU_CONFIG5_1K = {"closures": 59, "ate": 0.2447}
KERNEL_RTOL, KERNEL_ATOL = 2e-4, 2e-5
# Each block's largest difference from plain over its own largest inverse
# entry.  The sweep stacks' landmark blocks have inverse entries of ~1e-5
# (sigma 0.005), below KERNEL_ATOL, so only this per-block scale holds
# them; plain f32 against float64 stays under 2.2e-6 on those stacks
# (condition numbers up to 36; the CPU port, configs #1 and #2, three
# sweeps).
KERNEL_BLOCK_RTOL = 2e-4
# Port-vs-port (CUDA vs CPU) agreement: the e2e parity tolerance of
# tests/test_torch_e2e_rb2d.py (and _rb3d.py, _graphslam.py).
CPU_AGREE_ATOL = 1e-3
WARMUP_KFS, AGREE_KFS = 10, 20
# --bucket-pairs: rounds of the three window variants per config, the
# first a warm-up.
BUCKET_PAIR_ROUNDS = 4
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
# Phase 16, host-window vs device-master config #1: the JAX package's own
# master-vs-host tolerances (tests/test_device_master.py:29-40).
HOST_ERR_RTOL, HOST_ATE_RTOL, HOST_ATE_ATOL = 2e-3, 1e-2, 1e-4
# Phase 17: the variants agree in err_final (tests/test_solver_variants.py),
# and so do the card and the CPU on the config #2 bucket.
VARIANT_ERR_RTOL = 1e-3
VARIANT_TIMED_CALLS = 3
# Phase 18 (tests/test_refine_map.py): three sweeps bring the raw-odometry
# map's error below half its start; card and CPU agree at rel 1e-3 (the
# JAX package's mesh-vs-single sweep tolerance); two sweeps on an
# optimized map leave its error at most 1.05 times what it was.
REFINE_SWEEPS, REFINE_GAIN, REFINE_CPU_RTOL = 3, 0.5, 1e-3
REFINE_STABLE_SWEEPS, REFINE_STABLE = 2, 1.05
# Phase 19 (tests/test_ecps.py::TestLocalAreasVar1, its two-revolution
# loop): ATE < 0.5 m, at most one center opened on the second revolution,
# at least one closure edge.
VAR1_KFS, VAR1_ATE_BOUND, VAR1_LATE_CENTERS = 80, 0.5, 1
# Phase 20 (tests/test_cli_io.py): the resumed run within 0.01 m of the
# uninterrupted one; the CLI's config #1 run within 1e-3 m of phase 5's
# (the summary rounds the ATE to 6 decimals).  load_g2o renormalizes every
# quaternion in float64: a float32 quaternion of phase 9's problem moves by
# at most a few float32 ulps.
RESUME_ATE_ATOL, CLI_ATE_ATOL, G2O_QUAT_ATOL = 0.01, 1e-3, 1e-6
# Phase 23, two gloo ranks on the one card (the ranks sum their shards in
# rank order, and the sweep solves each rank's share of the windows as a
# batch of its own, so the ring rounds otherwise than one rank): config
# #1's ATE within 2e-3 m of phase 22's (tests/test_multihost.py's ring
# against one process), pgo20k's error within rel 1e-3 of phase 9's (the
# global PGO's CPU-agreement tolerance), refine_map's error below half its
# start (phase 18's gain) and within rel 3e-2 of phase 18's: three sweeps
# from raw odometry end up to 1.078e-02 from the unperturbed run with the
# masters nudged by 1e-7 or 1e-6 (30 CPU runs), and 7.0 (700%) off with
# half the windows' deltas dropped (tests/test_torch_midscale.py::
# test_refine_map_rounding_spread).  A rank that has not finished in
# RING_TIMEOUT seconds fails the phase; every collective of the ring fails
# after RING_GROUP_TIMEOUT seconds.
RING_RANKS, RING_BATCHES = 2, (1, 4)
RING_ATE_ATOL, RING_PGO_ERR_RTOL, RING_REFINE_RTOL = 2e-3, 1e-3, 3e-2
RING_TIMEOUT, RING_GROUP_TIMEOUT = 480, 120


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


def make_config(name: str, num_kfs: int = CONFIG5_KFS):
    """bench.py's data and parameters of config #1 (``bench.py:98-120``),
    #2 (``:127-145``), #3 (``:152-188``) or #4 (``:195-216``), unreduced,
    or of config #5 (``:233-258``) at ``num_kfs`` keyframes; or ("var1")
    tests/test_ecps.py's two-revolution loop under ``LocalAreasVar1(3,
    4)``.  Returns (world, dataset, observation model, noise sigma, ATE
    dimensions, the engine's other arguments)."""
    import srba_tpu_torch as port
    from srba_tpu_torch.ecps import LocalAreasFixedGrid, LocalAreasVar1
    from srba_tpu_torch.models.observations import CameraCalib, StereoCalib
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
    if name == "var1":
        world = tds.make_world_loop_2d(num_kfs=VAR1_KFS, radius=6.0,
                                       num_landmarks=120, seed=9,
                                       revolutions=2.0)
        ds = tds.observe(world, "RangeBearing2D", noise_std=0.003,
                         sensor_range=4.5, odo_noise_std=0.02, seed=9)
        return world, ds, "RangeBearing2D", 1.0, 2, {
            "ecp": LocalAreasVar1(min_obs_to_join=3,
                                  min_obs_count_loop_closure=4),
            "params": port.SrbaParams(max_tree_depth=4,
                                      max_optimize_depth=3)}
    if name == "config5":
        world = tds.make_world_loop_3d_large(num_kfs=num_kfs, radius=30.0,
                                             num_landmarks=1200,
                                             revolutions=2.5, seed=7)
        calib = CameraCalib.make()
        ds = tds.observe_sparse(world, "MonocularCamera", calib=calib,
                                noise_std=0.3, sensor_range=7.0,
                                odo_noise_std=0.005, seed=7)
        return world, ds, "MonocularCamera", 0.3, 3, {
            "calib": calib,
            "sensor_pose": SensorPoseSE3(CAMERA_SENSOR_POSE_SE3),
            "ecp": LocalAreasFixedGrid(submap_size=10,
                                       min_obs_count_loop_closure=6),
            "params": port.SrbaParams(max_tree_depth=3, max_optimize_depth=2,
                                      use_robust_kernel=True,
                                      kernel_param=3.0,
                                      extra_obs_per_lm_cap=4,
                                      incremental_max_iters=6)}
    world = tds.make_world_loop_2d(num_kfs=150, radius=8.0, num_landmarks=1,
                                   seed=5, revolutions=2.0)
    ds = tds.make_graph_slam_dataset(world, noise_std=0.002,
                                     loop_closure_range=1.5,
                                     odo_noise_std=0.01, seed=5)
    return world, ds, "RelativePoses2D", 0.002, 2, depth4


def run_config(cfg, device: str, num_kfs=None, on_kf=None,
               run_local: bool = True, **engine_extra):
    """One pass of a config through the port (the first ``num_kfs``
    keyframes, all by default), fed as bench.py's ``_drive`` feeds it, with
    ``on_kf(k, engine)`` after each keyframe (``run_local=False``: no
    window solve, the raw odometry map; ``engine_extra``: more engine
    arguments, such as ``device_master=False``); returns (engine, seconds,
    ATE).  Each engine gets its own copy of the config's edge-creation
    policy (``LocalAreasVar1`` keeps state).  The timed section ends in
    ``fence()``, a device synchronize (the host-window mode ends each
    solve in a download)."""
    import srba_tpu_torch as port
    from srba_tpu_torch.models.noise import NoiseIdentity
    from srba_tpu_torch.utils.datasets import ate_rmse

    world, ds, model, sigma, d, engine_kw = cfg
    engine_kw = dict(engine_kw, **engine_extra)
    if "ecp" in engine_kw:
        engine_kw["ecp"] = copy.deepcopy(engine_kw["ecp"])
    eng = port.SrbaEngine(model, noise=NoiseIdentity(sigma), device=device,
                          **engine_kw)
    t0 = time.perf_counter()
    for k, frame in enumerate(ds.frames[:num_kfs]):
        obs = [port.Observation(lm_id=m, z=z) for m, z in frame]
        edge_init = {k - 1: ds.odometry[k - 1]} if k > 0 else None
        eng.define_new_keyframe(obs, edge_init=edge_init,
                                run_local_optimization=run_local)
        if on_kf is not None:
            on_kf(k, eng)
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
def kernel_inputs(module):
    """Records a copy of every stack ``module``'s code hands its
    ``spd_inverse`` (which still runs the kernel and counts)."""
    seen = []
    spd_inverse = module.spd_inverse

    def recorder(m):
        seen.append(m.clone())
        return spd_inverse(m)

    module.spd_inverse = recorder
    try:
        yield seen
    finally:
        module.spd_inverse = spd_inverse


def pgo_kernel_inputs():
    """Records a copy of every stack the global PGO run inside hands
    ``spd_inverse`` (which still runs the kernel and counts)."""
    from srba_tpu_torch.solver import global_graphslam as pgo
    return kernel_inputs(pgo)


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


def buckets_line(buckets) -> str:
    return ", ".join(f"{key} x{n}" for key, n in sorted(buckets.items()))


def block_rel_diff(out, ref) -> float:
    """The largest over blocks of max|out - ref| / max|ref| in the block."""
    diff = (out - ref).abs().amax(dim=(-2, -1))
    return float((diff / ref.abs().amax(dim=(-2, -1))).max())


def check_kernel_on(tag: str, bl, stacks, per_block: bool = False) -> None:
    """The kernel against its plain version on stacks a solve built, at
    (KERNEL_RTOL, KERNEL_ATOL) and, with ``per_block``, each block at
    KERNEL_BLOCK_RTOL of its own scale.  (Padding nodes' blocks are
    ``1e-8 * I``, so entries of the inverses reach 1e8.)"""
    import torch
    check(len(stacks) > 0, f"{tag}: the solve handed the kernel nothing")
    err = scale = rel = 0.0
    for m in stacks:
        out, ref = bl.spd_inverse_cuda(m), bl.spd_inverse_unrolled(m)
        torch.cuda.synchronize()
        e, r = float((out - ref).abs().max()), block_rel_diff(out, ref)
        err, scale = max(err, e), max(scale, float(ref.abs().max()))
        rel = max(rel, r)
        check(torch.allclose(out, ref, rtol=KERNEL_RTOL, atol=KERNEL_ATOL),
              f"{tag}: kernel != plain on a {list(m.shape)} stack the solve "
              f"built: max|diff| {e:.3e}")
        check(not per_block or r <= KERNEL_BLOCK_RTOL,
              f"{tag}: kernel != plain on a {list(m.shape)} stack the solve "
              f"built: a block's max|diff| / its max|entry| {r:.3e}")
    held = f", per block {KERNEL_BLOCK_RTOL} of its scale" if per_block \
        else ""
    log(f"{tag}: kernel matches plain (rtol {KERNEL_RTOL}, atol "
        f"{KERNEL_ATOL}{held}) on the solve's {len(stacks)} "
        f"stack(s) {sorted({tuple(m.shape) for m in stacks})}, max|diff| "
        f"{err:.3e} at max|inverse entry| {scale:.3e}; largest per-block "
        f"max|diff| / block max|entry| {rel:.3e}")


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
    with window_buckets() as buckets:
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
    log(f"[{num}] {name} window steps by padded (E, L, N) and LM "
        f"iterations: {buckets_line(buckets)}")
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


def pgo20k_config():
    """bench.py ``bench_pgo``'s solver settings (``bench.py:373-374``)."""
    from srba_tpu_torch.solver.global_graphslam import PGOConfig
    return PGOConfig(group="SE3", max_outer=30, cg_iters=100,
                     abs_tol_per_edge=2e-5)


def phase_pgo20k(card: str, bl):
    """Phase 9: bench.py's 20k-node SE(3) PGO on the card.  Returns the
    kernel's launches per block size in the timed call, the problem, the
    timed call's info and its nodes."""
    from srba_tpu_torch.solver.global_graphslam import \
        optimize_global_pose_graph
    from srba_tpu_torch.utils.profiler import Profiler

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    prob = pgo20k_problem()
    K, E = len(prob["nodes"]), len(prob["edges"])
    log(f"[9] bench_pgo problem: {K} nodes, {E} edges, built in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = pgo20k_config()
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
    return launches, prob, info, G


def phase_config4_pgo(eng, cfg4, card: str, bl):
    """Phase 10: config #4's global PGO on the timed pass's engine.  The
    engine's default solve (chordal init, pseudo-Huber) certifies config
    #4's map at its chordal initialization, with no LM iteration and so no
    kernel launch (the JAX package takes the same decision), so the phase
    first solves LM-PCG from the incremental map (chordal off, no
    write-back) and then makes the terminal ``optimize_global()`` with its
    write-back.  Returns the kernel's launches per block size in both
    calls, and the nodes and info of each call: ``(launches, (G_lm,
    info_lm), (G, info))``."""
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
    G, info = eng.optimize_global()
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
    return launches, (G_lm, info_lm), (G, info)


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
    eng_w, warm, _ = run_config(cfg, "cuda")
    log(f"[12] config3 warm pass ({eng_w.num_keyframes} KFs): {warm:.3f} s")
    reset_launch_counts(bl)
    with window_buckets() as buckets:
        eng, dt, ate = run_config(cfg, "cuda")
    log("[12] config3 timed pass: window steps by padded (E, L, N) and LM "
        f"iterations: {buckets_line(buckets)}")
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
    steps = lockstep_steps("[12] config3", cfg, AGREE_KFS)
    check(steps.max() < STEP_ERR_FINAL_RTOL,
          f"[12] config3: a window step on CUDA ends at another error than "
          f"the CPU's: rel diff {steps.max():.3e} (rtol "
          f"{STEP_ERR_FINAL_RTOL})")
    log(f"[12] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return launches, eng, cfg


def lockstep_steps(tag: str, cfg, num_kfs: int) -> np.ndarray:
    """The config's first ``num_kfs`` keyframes on the card and on the CPU
    in lockstep, the card's masters set to the CPU's before each keyframe,
    so that each keyframe's window solve starts from the same state on both
    (keyframes whose window is empty on both are skipped).  Checks each
    step's initial error (the residual chain on the same state) at
    ``STEP_ERR_INIT_RTOL``; prints how far the steps' results lie apart (LM
    runs a capped number of iterations on windows with near-flat
    directions, where roundings move the state along them) and returns the
    relative differences of their final errors, for the caller to check."""
    import srba_tpu_torch as port
    from srba_tpu_torch.models.noise import NoiseIdentity

    _, ds, model, sigma, _, engine_kw = cfg
    engs = [port.SrbaEngine(model, noise=NoiseIdentity(sigma), device=dev,
                            **engine_kw) for dev in ("cuda", "cpu")]
    worst = {"err_init": 0.0, "state": 0.0}
    final, forks = [], []
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
        ig, ic = ({key: float(v) for key, v in dict(i).items()}
                  for i in infos)
        check(("skipped" in ig) == ("skipped" in ic),
              f"{tag}: KF {k}'s window is empty on one device only")
        if k == 0 or "skipped" in ic:
            continue   # nothing to solve (the first keyframe, or no window)
        worst["err_init"] = max(worst["err_init"], abs(
            ig["err_init"] - ic["err_init"]) / ic["err_init"])
        final.append(abs(ig["err_final"] - ic["err_final"]) / ic["err_final"])
        ne, nl = g.num_edges, g.num_lms
        ds_k = max(float((g.pose[:ne].cpu() - c.pose[:ne]).abs().max()),
                   float((g.lm[:nl].cpu() - c.lm[:nl]).abs().max()))
        worst["state"] = max(worst["state"], ds_k)
        if ds_k > CPU_AGREE_ATOL:
            forks.append(f"KF {k}: {ds_k:.2e} (lam {ig['lam']:.0e} / "
                         f"{ic['lam']:.0e}, err_final {ig['err_final']:.6e} "
                         f"/ {ic['err_final']:.6e})")
    final = np.asarray(final)
    check(final.size > 0, f"{tag}: no keyframe had a window to solve")
    log(f"{tag} lockstep, each KF's step from the same masters on the card "
        f"and the CPU, first {num_kfs} KFs: max rel diff err_init "
        f"{worst['err_init']:.3e} (rtol {STEP_ERR_INIT_RTOL}); rel diff "
        f"err_final median {np.median(final):.3e}, max {final.max():.3e}; "
        f"max|state diff| after a step {worst['state']:.3e}; steps apart "
        f"by more than {CPU_AGREE_ATOL}: {forks or 'none'}")
    check(worst["err_init"] < STEP_ERR_INIT_RTOL,
          f"{tag}: a window step on CUDA starts at another error than the "
          "CPU's")
    return final


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


def periodic_solves(every: int, out: list):
    """A ``run_config`` hook making bench.py ``bench_config5``'s periodic
    ``optimize_global(periodic=True, use_edge_info=True)`` after every
    ``every``-th keyframe (``bench.py:268-283``); appends (keyframe,
    seconds, info) to ``out``."""
    def on_kf(k, eng):
        if k and k % every == 0:
            t0 = time.perf_counter()
            _, info = eng.optimize_global(periodic=True, use_edge_info=True)
            out.append((k, time.perf_counter() - t0, info))
    return on_kf


@contextmanager
def landmark_inits():
    """Records (base keyframe, initial state) of every landmark the engines
    run inside materialize (the landmarks themselves are unchanged)."""
    from srba_tpu_torch.engine.engine import SrbaEngine
    seen = []
    add = SrbaEngine._add_landmark

    def recorder(self, base_kf, st, fixed=False):
        seen.append((int(base_kf), np.array(st, np.float32)))
        return add(self, base_kf, st, fixed=fixed)

    SrbaEngine._add_landmark = recorder
    try:
        yield seen
    finally:
        SrbaEngine._add_landmark = add


def config5_report(tag, eng, K, dt, periodic, by_shape, buckets) -> int:
    """Prints a config #5 drive's KF/s, periodic solves, edges, closure
    fits, landmarks, window buckets, launches and profiler table; returns
    its closure edges (every keyframe but the first has one primary
    edge)."""
    closures = eng.state.num_edges - (K - 1)
    fits = {k: v for k, v in sorted(eng.profiler.counters.items())
            if k.startswith("closure_")}
    t_pgo = sum(s for _, s, _ in periodic)
    log(f"{tag} {K} KFs in {dt:.3f} s = {K / dt:.2f} KF/s ({t_pgo:.3f} s of "
        f"it in {len(periodic)} periodic solves; {K / (dt - t_pgo):.2f} KF/s "
        f"without them), mean device_step {mean_device_step_ms(eng):.3f} ms")
    for k, s, info in periodic:
        log(f"{tag} periodic optimize_global after KF {k}: {s:.3f} s, "
            f"converged={info['converged']:.0f} iters={info['iters']:.0f} "
            f"cg_iters_total={info['cg_iters_total']:.0f} "
            f"escalations={info['escalations']:.0f}, err "
            f"{info['err_init']:.6e} -> {info['err_final']:.6e}")
    log(f"{tag} {eng.state.num_edges} edges of which {closures} closure "
        f"edges, {len(eng._closure_pending)} weak fits still pending; "
        f"closure counters {fits}; {eng.num_landmarks} landmarks "
        f"materialized, {eng.num_pending_landmarks} pending, "
        f"{eng.state.num_obs} observations; host mirror "
        f"{eng.device_master.sync_stats}")
    if buckets is not None:
        log(f"{tag} window steps by padded (E, L, N) and LM iterations: "
            f"{buckets_line(buckets)}")
    log(f"{tag} spd_inverse kernel launches {sum(by_shape.values())} by "
        f"[B, d]: {shapes(by_shape)}")
    log(f"{tag} {eng.profiler.report()}")
    return closures


def phase_config5(card: str, bl):
    """Phase 14: config #5 at 1000 keyframes on the card, its first 100
    rerun, its first 20 against the CPU.  Returns the kernel's launches per
    block size in the drive, the drive's engine and the config's data."""
    import torch

    t_phase = time.perf_counter()
    cfg = make_config("config5")
    ds = cfg[1]
    K = len(ds.frames)
    log(f"[14] config5 data: {K} KFs, {sum(len(f) for f in ds.frames)} "
        f"observations of {len({m for f in ds.frames for m, _ in f})} "
        "landmarks")
    periodic, snap = [], {}
    refine = periodic_solves(CONFIG5_REFINE_EVERY, periodic)

    def on_kf(k, eng):
        refine(k, eng)
        if k + 1 == RERUN_KFS:
            dm = eng.device_master
            snap["masters"] = [t.clone() for t in (dm.pose, dm.prior, dm.lm)]

    reset_launch_counts(bl)
    with window_buckets() as buckets:
        eng, dt, _ = run_config(cfg, "cuda", on_kf=on_kf)
    launches = launches_by_d(bl)
    by_shape = dict(bl.spd_inverse_cuda.launches_by_shape)
    dm = eng.device_master
    check(dm.pose.is_cuda and dm.prior.is_cuda and dm.lm.is_cuda,
          "config5 masters are not CUDA tensors")
    closures = config5_report(f"[14] config5 on {card}:", eng, K, dt,
                              periodic, by_shape, buckets)
    check(launches.get(3, 0) > 0 and launches.get(6, 0) > 0
          and set(launches) == {3, 6},
          f"config5 kernel launches by block size {launches}, expected "
          "[L, 3, 3] and the periodic solves' [Kp, 6, 6]")
    check(len(periodic) == (K - 1) // CONFIG5_REFINE_EVERY and all(
        info["err_final"] <= info["err_init"] for _, _, info in periodic),
        "config5: a periodic optimize_global made the map worse")
    check(closures >= CONFIG5_MIN_CLOSURES,
          f"config5 closure starvation: {closures} closure edges")

    eng_r, _, _ = run_config(cfg, "cuda", RERUN_KFS)
    dm_r = eng_r.device_master
    check(all(torch.equal(a, b) for a, b in zip(
        snap["masters"], (dm_r.pose, dm_r.prior, dm_r.lm))),
        f"config5 masters after {RERUN_KFS} KFs differ between two runs")
    log(f"[14] rerun of the first {RERUN_KFS} KFs on the card: pose, prior "
        "and landmark masters bitwise equal to the drive's there")

    with landmark_inits() as inits_g:
        eng_g, _, ate_g = run_config(cfg, "cuda", AGREE_KFS)
    with landmark_inits() as inits_c:
        eng_c, _, ate_c = run_config(cfg, "cpu", AGREE_KFS)
    err_g = eng_g.eval_overall_squared_error()
    err_c = eng_c.eval_overall_squared_error()
    same_lms = (eng_g._lm_id_map == eng_c._lm_id_map
                and len(inits_g) == len(inits_c) and all(
                    bg == bc and np.array_equal(pg, pc)
                    for (bg, pg), (bc, pc) in zip(inits_g, inits_c)))
    log(f"[14] config5 first {AGREE_KFS} KFs, CUDA vs CPU: ATE "
        f"{ate_g:.6f} vs {ate_c:.6f} m, |ATE diff| {abs(ate_g - ate_c):.3e} "
        f"(atol {CONFIG5_ATE_AGREE}), total squared error {err_g:.6e} vs "
        f"{err_c:.6e}; {len(inits_g)} landmarks materialized "
        f"({eng_g.num_pending_landmarks} pending), ids, base KFs and initial "
        f"points identical: {same_lms}")
    check(same_lms, "config5: the card and the CPU materialized different "
          "landmarks in the first keyframes")
    check(abs(ate_g - ate_c) < CONFIG5_ATE_AGREE,
          "config5 on CUDA disagrees with the same run on the CPU")
    steps = lockstep_steps("[14] config5", cfg, AGREE_KFS)
    check(np.median(steps) < CONFIG5_STEP_MEDIAN_RTOL
          and steps.max() < CONFIG5_STEP_MAX_RTOL,
          f"[14] config5: the window steps on CUDA end at other errors than "
          f"the CPU's: rel diff median {np.median(steps):.3e} (rtol "
          f"{CONFIG5_STEP_MEDIAN_RTOL}), max {steps.max():.3e} (rtol "
          f"{CONFIG5_STEP_MAX_RTOL})")
    log(f"[14] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return launches, eng, cfg


def phase_config5_pgo(eng, cfg, card: str, bl, num="15",
                      bound: str = "config5_1k"):
    """Phase 15: config #5's terminal ``optimize_global(use_edge_info=True)``
    (bench.py:294) on the drive's engine, with its write-back.  Returns the
    kernel's launches per block size, the solve's info and seconds."""
    from srba_tpu_torch import Observation
    from srba_tpu_torch.ops.np_lie import NpSE3
    from srba_tpu_torch.utils.datasets import ate_rmse

    t_phase = time.perf_counter()
    world, ds = cfg[0], cfg[1]
    K = len(ds.frames)
    G0, _ = eng.create_complete_spanning_tree(0)
    ate_before = float(ate_rmse(np.asarray(G0)[:, :3], world.gt_poses[:, :3]))
    reset_launch_counts(bl)
    torch_sync()
    with pgo_kernel_inputs() as stacks:
        t0 = time.perf_counter()
        G, info = eng.optimize_global(use_edge_info=True)
        torch_sync()
        dt = time.perf_counter() - t0
    by_shape = dict(bl.spd_inverse_cuda.launches_by_shape)
    launches = launches_by_d(bl)
    edges = eng.state.num_edges
    closures = edges - (K - 1)
    ate = float(ate_rmse(np.asarray(G)[:, :3], world.gt_poses[:, :3]))
    log(f"[{num}] config5 optimize_global(use_edge_info=True) on {card}: "
        f"{len(G)} nodes / {edges} edges ({closures} closure "
        f"edges) in {dt:.3f} s; err {info['err_init']:.6e} -> "
        f"{info['err_final']:.6e}, converged={info['converged']:.0f} "
        f"iters={info['iters']:.0f} cg_iters_total="
        f"{info['cg_iters_total']:.0f} escalations="
        f"{info['escalations']:.0f}")
    log(f"[{num}] ATE {ate_before:.6f} -> {ate:.6f} m (bound "
        f"{ATE_BOUND[bound]}); spd_inverse kernel launches by [B, d]: "
        f"{shapes(by_shape)}")
    if bound == "config5_1k":
        log(f"[{num}] the JAX package on the CPU, the same data and calls: "
            f"{JAX_CPU_CONFIG5_1K['closures']} closure edges, ATE "
            f"{JAX_CPU_CONFIG5_1K['ate']} m")
    check(info["converged"] == 1.0, f"config5 PGO not certified: {info}")
    check(closures >= CONFIG5_MIN_CLOSURES,
          f"config5 closure starvation: {closures} closure edges")
    check(len(by_shape) == 1 and all(d == 6 and B >= len(G)
                                     for B, d in by_shape)
          and sum(by_shape.values()) == info["iters"] >= 1,
          f"config5 PGO kernel shapes {by_shape}, expected [Kp, 6, 6] once "
          "per LM iteration")
    check_kernel_on(f"[{num}]", bl, stacks)
    n = eng.num_keyframes
    eng.define_new_keyframe(
        [Observation(lm_id=m, z=z) for m, z in ds.frames[-1]],
        edge_init={n - 1: NpSE3.identity()})
    eng.fence()
    check(eng.num_keyframes == n + 1 and bool(np.isfinite(
        eng.eval_overall_squared_error())),
        "config5: incremental step after the write-back failed")
    log(f"[{num}] one more keyframe after the write-back: "
        f"{eng.num_keyframes} KFs, finite error")
    log(f"[{num}] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return launches, info, dt, ate, edges


def run_config5_full(card: str, bl):
    """``--config5-full``: bench.py's ``bench_config5`` unreduced (5000
    keyframes, periodic solves after every 1250th, the terminal solve),
    with bench's report line.  Returns the kernel's launches per block size
    in the drive and in the terminal solve."""
    t_phase = time.perf_counter()
    cfg = make_config("config5", CONFIG5_FULL_KFS)
    K = len(cfg[1].frames)
    log(f"[c5] data built in {time.perf_counter() - t_phase:.1f} s: {K} KFs, "
        f"{sum(len(f) for f in cfg[1].frames)} observations")
    reset_launch_counts(bl)
    periodic = []
    refine = periodic_solves(CONFIG5_FULL_REFINE_EVERY, periodic)
    eng, dt_inc, _ = run_config(cfg, "cuda", on_kf=refine)
    launches = {"config5_full": launches_by_d(bl)}
    config5_report(f"[c5] config5 on {card}:", eng, K, dt_inc, periodic,
                   dict(bl.spd_inverse_cuda.launches_by_shape), None)
    n_lms = eng.num_landmarks
    launches["config5_full_pgo"], info, dt_ref, ate, edges = \
        phase_config5_pgo(eng, cfg, card, bl, num="c5", bound="config5")
    log(f"config5_mono5k: {K / dt_inc:.1f} KF/s  ATE={ate:.4f} m (bound "
        f"{ATE_BOUND['config5']})  incremental {dt_inc:.1f}s + PGO "
        f"{dt_ref:.1f}s, {edges} edges, {n_lms} lms, PGO "
        f"err {info['err_init']:.2e}->{info['err_final']:.2e} "
        f"conv={info.get('converged', 0):.0f}")
    log(f"[c5] wall time {time.perf_counter() - t_phase:.1f} s")
    check(ate <= ATE_BOUND["config5"], f"config5 ATE {ate} > bound")
    return launches


class _NoRatchet(dict):
    """An engine's ``_window_caps`` that keeps nothing: every window is
    padded to its own bucket (the Python builder's shapes before the
    ratchet)."""

    def __setitem__(self, key, value):
        pass


@contextmanager
def engine_variant(variant: str):
    """Engines made inside build their device-master windows as
    ``variant`` says: "native" (the default: the native core, padded by
    the engine's ratchet), "python" (the Python builder, as without g++ or
    with SRBA_TPU_TORCH_NO_NATIVE; the same shapes) or "shrink" (the native
    core with no ratchet)."""
    from srba_tpu_torch.engine.engine import SrbaEngine
    init = SrbaEngine.__init__

    def made(self, *args, **kwargs):
        init(self, *args, **kwargs)
        if variant == "python":
            self.native = None
        elif variant == "shrink":
            self._window_caps = _NoRatchet()

    SrbaEngine.__init__ = made
    try:
        yield
    finally:
        SrbaEngine.__init__ = init


def run_bucket_pairs(card: str, bl, device: str = "cuda",
                     rounds: int = BUCKET_PAIR_ROUNDS) -> dict:
    """``--bucket-pairs``: configs #1 and #2 (SE(3)) in the three
    ``engine_variant``s, interleaved in this process, the order rotated
    each round.  Prints each run's KF/s, mean ``device_step`` and
    ``window_build``, buckets and launches, then the means per variant
    over all rounds but the first (a warm-up).  Returns the kernel's
    launches per block size in the last run of each."""
    variants = ("native", "python", "shrink")
    launches, table = {}, {}
    for name in ("config1", "config2"):
        cfg = make_config(name)
        for r in range(rounds):
            for v in variants[r % 3:] + variants[:r % 3]:
                reset_launch_counts(bl)
                with engine_variant(v), window_buckets() as buckets:
                    eng, dt, ate = run_config(cfg, device)
                launches[f"{name}_{v}"] = launches_by_d(bl)
                row = (eng.num_keyframes / dt, mean_device_step_ms(eng),
                       1e3 * eng.profiler.mean(
                           "define_new_keyframe.optimize_local_area."
                           "window_build"))
                if r > 0:
                    table.setdefault((name, v), []).append(row)
                log(f"[bp] {name} {v} round {r} on {card}: "
                    f"{eng.num_keyframes / dt:.3f} KF/s, mean device_step "
                    f"{row[1]:.3f} ms, mean window_build {row[2]:.3f} ms, "
                    f"ATE {ate:.6f} m; buckets {buckets_line(buckets)}; "
                    f"launches {shapes(bl.spd_inverse_cuda.launches_by_shape)}"
                    )
    for (name, v), rows in table.items():
        m = np.mean(np.asarray(rows), axis=0)
        log(f"[bp] {name} {v}: mean of rounds 1-{rounds - 1} on {card}: "
            f"{m[0]:.3f} KF/s, device_step {m[1]:.3f} ms, window_build "
            f"{m[2]:.3f} ms")
    return launches


def edge_list(eng):
    st = eng.get_rba_state()
    n = st.num_edges
    return list(zip(st.k2k_from[:n].tolist(), st.k2k_to[:n].tolist()))


def within(x: float, ref: float, rtol: float, atol: float = 0.0) -> bool:
    """``x == pytest.approx(ref, rel=rtol, abs=atol)``."""
    return abs(x - ref) <= max(rtol * abs(ref), atol)


def phase_host_window(eng5, ate5, cfg1, card: str, bl):
    """Phase 16: config #1 in the host-window mode, held against phase 5's
    device-master drive.  Returns the kernel's launches per block size in
    the timed pass, and its engine, ATE and window solves' infos."""
    t_phase = time.perf_counter()
    _, warm, _ = run_config(cfg1, "cuda", WARMUP_KFS, device_master=False)
    log(f"[16] config #1 host-window warm-up ({WARMUP_KFS} KFs): "
        f"{warm:.3f} s")
    reset_launch_counts(bl)
    with step_infos() as infos:
        eng, dt, ate = run_config(cfg1, "cuda", device_master=False)
    launches = launches_by_d(bl)
    by_shape = dict(bl.spd_inverse_cuda.launches_by_shape)
    check(eng.device_master is None, "phase 16 engine has device masters")
    check(launches.get(2, 0) > 0,
          "host-window config #1 never launched the kernel on [L, 2, 2]")
    kfs = eng.num_keyframes
    scope = "define_new_keyframe.optimize_local_area."
    log(f"[16] config #1 host-window timed pass on {card}: {kfs} KFs in "
        f"{dt:.3f} s = {kfs / dt:.2f} KF/s, ATE {ate:.6f} m (bound "
        f"{ATE_BOUND['config1']}; device-master phase 5 {ate5:.6f} m), mean "
        f"device_solve {1e3 * eng.profiler.mean(scope + 'device_solve'):.3f}"
        f" ms, mean write_back "
        f"{1e3 * eng.profiler.mean(scope + 'write_back'):.3f} ms; "
        f"spd_inverse kernel launches {sum(launches.values())} by [B, d]: "
        f"{shapes(by_shape)}")
    log(f"[16] {eng.profiler.report()}")
    check(ate <= ATE_BOUND["config1"], f"host-window config #1 ATE {ate}")
    check(edge_list(eng) == edge_list(eng5),
          "host-window config #1 built other edges than phase 5")
    err, err5 = (eng.eval_overall_squared_error(),
                 eng5.eval_overall_squared_error())
    log(f"[16] host-window vs device-master (phase 5): the same "
        f"{len(edge_list(eng))} edges; total squared error {err:.6e} vs "
        f"{err5:.6e} (rtol {HOST_ERR_RTOL}), ATE rel diff "
        f"{abs(ate - ate5) / ate5:.3e} (rtol {HOST_ATE_RTOL}, atol "
        f"{HOST_ATE_ATOL})")
    check(within(err, err5, HOST_ERR_RTOL, 1e-6)
          and within(ate, ate5, HOST_ATE_RTOL, HOST_ATE_ATOL),
          "host-window config #1 disagrees with the device-master drive")
    eng_r, _, ate_r = run_config(cfg1, "cuda", device_master=False)
    st, st_r = eng.state, eng_r.state
    check(np.array_equal(st.k2k_pose, st_r.k2k_pose)
          and np.array_equal(st.lm_state, st_r.lm_state) and ate_r == ate,
          "host-window config #1 state differs between two runs")
    log("[16] rerun: host edge and landmark tables bitwise equal")
    log(f"[16] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return launches, (eng, ate, infos)


def config_bucket(eng, device: str):
    """The window around ``eng``'s middle keyframe at its optimize depth,
    as the host-window mode builds it, on ``device``.  (The newest
    keyframes of a closed chain loop re-observe only landmarks based beyond
    the tree depth: their windows are empty.)"""
    import torch

    from srba_tpu_torch.solver.lm import WindowBatch
    from srba_tpu_torch.solver.window import build_window

    eng.sync()
    par = eng.parameters
    arrays, _ = build_window(eng.state, eng.graph, eng.num_keyframes // 2,
                             par.max_optimize_depth, par.max_tree_depth)

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return WindowBatch(
        edge_pose=dev(arrays.edge_pose), edge_opt=dev(arrays.edge_opt),
        lm_state=dev(arrays.lm_state), lm_opt=dev(arrays.lm_opt),
        obs_z=dev(arrays.obs_z), obs_lm=dev(arrays.obs_lm, torch.int32),
        path_edge=dev(arrays.path_edge, torch.int32),
        path_sign=dev(arrays.path_sign), obs_valid=dev(arrays.obs_valid),
        whitener=dev(eng._whitener),
        sensor_pose_inv=dev(eng._sensor_pose_inv),
        edge_prior=dev(arrays.edge_prior),
        edge_prior_w=dev(arrays.edge_prior_w))


VARIANTS = (("onehot", "schur_dense_cholesky"),
            ("segmented", "schur_dense_cholesky"),
            ("onehot", "no_schur_dense_cholesky"))


def phase_solver_variants(eng2, card: str, bl):
    """Phase 17: the three solver variants on phase 4's large window and on
    a config #2 bucket.  Returns the kernel's launches per block size in
    the card's variant solves."""
    import torch

    from srba_tpu_torch.solver.lm import SolverConfig, make_lm_solver

    t_phase = time.perf_counter()
    cfg_large = SolverConfig(obs_model="RangeBearing2D", pose_group="SE2",
                             lm_type="Euclidean2D", max_depth=4, max_iters=6,
                             rel_tol=0.0)
    def title(what, b, group, d):
        return (f"{what} E={b.edge_opt.shape[0]} L={b.lm_opt.shape[0]} "
                f"N={b.obs_valid.shape[0]} ({group}, d={d})")

    large = large_window_batch()
    b2 = config_bucket(eng2, "cuda")
    problems = [(title("large window", large, "SE2", 2), cfg_large, large,
                 None),
                (title("config #2 bucket", b2, "SE3", 3), eng2._solver_cfg,
                 b2, config_bucket(eng2, "cpu"))]
    reset_launch_counts(bl)
    for title, cfg, batch, batch_cpu in problems:
        errs = {}
        for neq, solver in VARIANTS:
            vcfg = dataclasses.replace(cfg, neq=neq, solver=solver)
            solve, _ = make_lm_solver(vcfg, device="cuda")
            before = launches_by_d(bl)
            first = solve(batch)
            torch_sync()
            n_launch = {d: n - before.get(d, 0)
                        for d, n in launches_by_d(bl).items()
                        if n != before.get(d, 0)}
            times = []
            for _ in range(VARIANT_TIMED_CALLS):
                t0 = time.perf_counter()
                again = solve(batch)
                torch_sync()
                times.append(time.perf_counter() - t0)
            info = {k: float(v) for k, v in first[2].items()}
            errs[(neq, solver)] = info["err_final"]
            same = (torch.equal(first[0], again[0])
                    and torch.equal(first[1], again[1]))
            line = (f"[17] {title}, {neq} / {solver} on {card}: err "
                    f"{info['err_init']:.6e} -> {info['err_final']:.6e}, "
                    f"iters {info['iters']:.0f}; per solve median "
                    f"{1e3 * float(np.median(times)):.3f} ms over "
                    f"{VARIANT_TIMED_CALLS} calls; kernel launches per "
                    f"solve {sum(n_launch.values())}; rerun bitwise equal: "
                    f"{same}")
            if batch_cpu is not None:
                _, _, info_c = make_lm_solver(vcfg, device="cpu")[0](
                    batch_cpu)
                err_c = float(info_c["err_final"])
                line += (f"; the CPU: err_final {err_c:.6e} (rel diff "
                         f"{abs(err_c - info['err_final']) / err_c:.3e})")
                check(within(info["err_final"], err_c, VARIANT_ERR_RTOL),
                      f"[17] {title} {neq}/{solver}: card vs CPU err_final")
            log(line)
            check(np.isfinite(info["err_final"])
                  and info["err_final"] < info["err_init"],
                  f"[17] {title} {neq}/{solver} did not descend: {info}")
            if neq == "segmented":
                check(same, f"[17] {title}: segmented rerun not bitwise")
            if solver.startswith("no_schur"):
                check(not n_launch, f"[17] {title}: the no-Schur solver "
                      f"launched the SPD kernel {n_launch}")
            else:
                check(sum(n_launch.values()) == cfg.max_iters,
                      f"[17] {title}: {n_launch} launches, expected one per "
                      "LM iteration")
        ref = errs[VARIANTS[0]]
        check(all(within(e, ref, VARIANT_ERR_RTOL) for e in errs.values()),
              f"[17] {title}: variants disagree in err_final: {errs}")
        log(f"[17] {title}: err_final of the three variants within rel "
            f"{VARIANT_ERR_RTOL}: " + ", ".join(
                f"{n}/{s} {e:.6e}" for (n, s), e in errs.items()))
    log(f"[17] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return launches_by_d(bl)


@contextmanager
def sweep_records(keep_stacks: bool = False):
    """Records each refine_map sweep phase's windows and common bucket
    (W, E, L, N) and, with ``keep_stacks``, a copy of every stack the
    batched solve hands ``spd_inverse`` (which still runs the kernel and
    counts)."""
    from srba_tpu_torch.solver import multi_window as mw
    phases, stacks = [], []
    make, make_mesh, inverse = (mw.make_sweep_step, mw.make_sweep_step_mesh,
                                mw.spd_inverse)

    def recording(step):
        def recorder(*args):
            phases.append((args[3].shape[0],) + tuple(args[8:11]))
            return step(*args)
        return recorder

    def inverse_recorder(m):
        stacks.append(m.clone())
        return inverse(m)

    mw.make_sweep_step = lambda cfg: recording(make(cfg))
    mw.make_sweep_step_mesh = lambda cfg, mesh: recording(make_mesh(cfg,
                                                                    mesh))
    if keep_stacks:
        mw.spd_inverse = inverse_recorder
    try:
        yield phases, stacks
    finally:
        mw.make_sweep_step, mw.make_sweep_step_mesh, mw.spd_inverse = \
            make, make_mesh, inverse


def phase_refine_map(name: str, card: str, bl, timer, times):
    """Phase 18: ``refine_map`` on the raw-odometry map of ``name`` on the
    card and on the CPU.  Adds the kernel's times at the sweeps' shapes to
    ``times``; returns the kernel's launches per block size in the card's
    sweeps, and the card's engine and error after them."""
    from srba_tpu_torch.tools import spd_inverse_bench as kb

    t_phase = time.perf_counter()
    cfg = make_config(name)
    eng, _, _ = run_config(cfg, "cuda", run_local=False)
    eng_c, _, _ = run_config(cfg, "cpu", run_local=False)
    err0 = eng.eval_overall_squared_error()
    reset_launch_counts(bl)
    torch_sync()
    with sweep_records() as (phases, _):
        t0 = time.perf_counter()
        info = eng.refine_map(sweeps=REFINE_SWEEPS)
        eng.fence()
        dt = time.perf_counter() - t0
    launches = launches_by_d(bl)
    by_shape = dict(bl.spd_inverse_cuda.launches_by_shape)
    err1 = eng.eval_overall_squared_error()
    max_iters = eng._solver_cfg.max_iters
    log(f"[18] {name} refine_map(sweeps={REFINE_SWEEPS}) on {card}: "
        f"{dt:.3f} s = {1e3 * dt / REFINE_SWEEPS:.1f} ms per sweep, "
        f"{info['windows']:.0f} windows in {len(phases)} phases; (W, E, L, "
        f"N) per phase: {phases}; error {err0:.6e} -> {err1:.6e}; last "
        f"phase {info}")
    log(f"[18] {name} spd_inverse kernel launches {sum(by_shape.values())} "
        f"by [B, d]: {shapes(by_shape)}")
    d = cfg[4]
    check(err1 < REFINE_GAIN * err0,
          f"[18] {name}: sweeps left the error at {err1} (start {err0})")
    check(set(by_shape) == {(W * L, d) for W, _, L, _ in phases}
          and sum(by_shape.values()) == len(phases) * max_iters,
          f"[18] {name}: kernel shapes {by_shape}, expected [W*L, {d}, {d}] "
          "once per LM iteration of each phase")
    t0 = time.perf_counter()
    eng_c.refine_map(sweeps=REFINE_SWEEPS)
    err_c = eng_c.eval_overall_squared_error()
    log(f"[18] {name} the same sweeps on the CPU from the same state "
        f"({time.perf_counter() - t0:.1f} s): error {err_c:.6e}, rel diff "
        f"{abs(err1 - err_c) / err_c:.3e} (rtol {REFINE_CPU_RTOL})")
    check(within(err1, err_c, REFINE_CPU_RTOL),
          f"[18] {name}: card and CPU sweeps disagree")
    eng_r, _, _ = run_config(cfg, "cuda", run_local=False)
    with sweep_records(keep_stacks=True) as (_, stacks):
        eng_r.refine_map(sweeps=REFINE_SWEEPS)
        eng_r.fence()
    check(masters_equal(eng, eng_r),
          f"[18] {name}: masters differ between two sweep runs")
    log(f"[18] {name} rerun: pose, prior and landmark masters bitwise equal")
    check_kernel_on(f"[18] {name}", bl, stacks, per_block=True)
    for B, dd in sorted(by_shape):
        if (B, dd) not in times:
            times[(B, dd)] = kb.measure_shape(B, dd, timer)
            log(f"[18] {kb.format_shape(B, dd, times[(B, dd)])} (on {card})")
    log(f"[18] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return launches, (eng, err1)


def phase_refine_optimized(eng5, cfg1, card: str):
    """Phase 18, last part: sweeps on phase 5's optimized config #1 map,
    then one more keyframe."""
    from srba_tpu_torch import Observation

    t_phase = time.perf_counter()
    ds = cfg1[1]
    err0 = eng5.eval_overall_squared_error()
    info = eng5.refine_map(sweeps=REFINE_STABLE_SWEEPS)
    err1 = eng5.eval_overall_squared_error()
    log(f"[18] config1 refine_map(sweeps={REFINE_STABLE_SWEEPS}) on phase "
        f"5's optimized map on {card}: error {err0:.6e} -> {err1:.6e} "
        f"(at most {REFINE_STABLE} x); last phase {info}")
    check(err1 <= REFINE_STABLE * err0 + 1e-9,
          "[18] sweeps made the optimized config #1 map worse")
    n = eng5.num_keyframes
    eng5.define_new_keyframe(
        [Observation(lm_id=m, z=z) for m, z in ds.frames[-1]],
        edge_init={n - 1: ds.odometry[-1]})
    eng5.fence()
    check(eng5.num_keyframes == n + 1
          and bool(np.isfinite(eng5.eval_overall_squared_error())),
          "[18] incremental step after the sweeps failed")
    log(f"[18] one more keyframe after the sweeps: {eng5.num_keyframes} "
        f"KFs, finite error; wall time {time.perf_counter() - t_phase:.1f} s")


def phase_var1(card: str, bl):
    """Phase 19: ``LocalAreasVar1`` on the card and on the CPU.  Returns
    the kernel's launches per block size in the card's run and its
    engine."""
    t_phase = time.perf_counter()
    cfg = make_config("var1")
    reset_launch_counts(bl)
    eng, dt, ate = run_config(cfg, "cuda")
    launches = launches_by_d(bl)
    eng_c, dt_c, ate_c = run_config(cfg, "cpu")
    K = eng.num_keyframes
    centers = eng.ecp.centers
    closures = eng.state.num_edges - (K - 1)
    late = [c for c in centers if c >= K // 2]
    fits = {k: v for k, v in sorted(eng.profiler.counters.items())
            if k.startswith("closure_")}
    log(f"[19] var1 on {card}: {K} KFs in {dt:.3f} s = {K / dt:.2f} KF/s, "
        f"ATE {ate:.6f} m (bound {VAR1_ATE_BOUND}), centers {centers}, "
        f"{closures} closure edges, closure counters {fits}, spd_inverse "
        f"kernel launches {sum(launches.values())} by block size "
        f"{launches}; the CPU ({dt_c:.1f} s): ATE {ate_c:.6f} m, centers "
        f"{eng_c.ecp.centers}")
    check(launches.get(2, 0) > 0, "[19] var1 never launched the kernel")
    check(eng.ecp.get_state() == eng_c.ecp.get_state()
          and edge_list(eng) == edge_list(eng_c),
          "[19] var1: the card and the CPU built other areas or edges")
    check(ate < VAR1_ATE_BOUND, f"[19] var1 ATE {ate}")
    check(len(late) <= VAR1_LATE_CENTERS,
          f"[19] var1 opened {late} on the second revolution")
    check(closures >= 1, "[19] var1 created no closure edge")
    log("[19] card and CPU: identical centers, keyframe areas and edges")
    log(f"[19] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return launches, eng


def require_native() -> dict:
    """From here on every engine the script makes (its own, the CLI's, the
    tutorials') checks at construction that, in the device-master mode, it
    builds its windows with the native core; returns the running count of
    engines checked."""
    from srba_tpu_torch.engine.engine import SrbaEngine
    init = SrbaEngine.__init__
    seen = {"device_master": 0, "host_window": 0}

    def checked(self, *args, **kwargs):
        init(self, *args, **kwargs)
        if self.device_master is None:
            seen["host_window"] += 1
            return
        check(self.native is not None,
              "a device-master engine builds its windows without the "
              "native core")
        seen["device_master"] += 1

    SrbaEngine.__init__ = checked
    return seen


def run_cli(argv):
    """``srba_tpu_torch.cli.main(argv)`` in this process, its output
    captured.  Returns (the summary JSON of its last stdout line, its
    stderr, seconds to its return and a device synchronize)."""
    import io
    from contextlib import redirect_stderr, redirect_stdout

    from srba_tpu_torch.cli import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(out), redirect_stderr(err):
        rc = cli_main(argv)
    torch_sync()
    dt = time.perf_counter() - t0
    check(rc == 0, f"CLI {argv} exited {rc}: {err.getvalue()[-2000:]}")
    return json.loads(out.getvalue().strip().splitlines()[-1]), \
        err.getvalue(), dt


def checkpoint_arrays(path):
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def arrays_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def write_pgo_g2o(prob, path: str) -> None:
    """A pose-graph problem as ``VERTEX_SE3:QUAT`` / ``EDGE_SE3:QUAT`` text:
    its values as float32 (what the solver takes) in ``%.9g``, which
    round-trips float32; identity information."""
    def f(v):
        return " ".join(f"{x:.9g}" for x in np.asarray(v, np.float32))

    info = " ".join("1" if a == b else "0" for a in range(6)
                    for b in range(a, 6))
    lines = [f"VERTEX_SE3:QUAT {i} {f(p[:3])} {f(p[4:7])} {f(p[3:4])}"
             for i, p in enumerate(prob["nodes"])]
    lines += [f"EDGE_SE3:QUAT {e['from']} {e['to']} {f(e['rel_pose'][:3])} "
              f"{f(e['rel_pose'][4:7])} {f(e['rel_pose'][3:4])} {info}"
              for e in prob["edges"]]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def phase5_snapshot(eng, ate) -> dict:
    """What phase 20 compares with phase 5's run (later phases go on with
    its engine): its engine's configuration, counts, ATE and tables."""
    st = eng.get_rba_state()
    rows = {"k": st.num_edges, "l": st.num_lms, "o": st.num_obs}
    return {"ate": ate, "parameters": copy.deepcopy(eng.parameters),
            "noise": (eng.noise.name, eng.noise.std), "ecp": eng.ecp.name,
            "model": eng.model.name, "num_kfs": eng.num_keyframes,
            "num_edges": st.num_edges, "num_landmarks": eng.num_landmarks,
            "tables": {t: getattr(st, t)[: rows[t[0]]].copy()
                       for t in ("k2k_from", "k2k_to", "k2k_pose",
                                 "lm_base", "lm_state", "obs_z")}}


def phase_cli(card: str, bl, cfg1, snap5, pgo20k, pgo20k_info, eng_var1):
    """Phase 20: the ``srba_slam_torch`` CLI in this process on the card:
    (a) config #1's data written as dataset files and run with phase 5's
    engine; (b) stopped at KF 50, checkpointed and resumed; (c)
    ``--pgo-g2o`` on phase 19's var1 map (``eng_var1``'s export) and on
    phase 9's problem.  Returns
    the kernel's launches per block size for (a), (b) and (c)."""
    import tempfile

    from srba_tpu_torch.cli import _make_engine, build_parser
    from srba_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from srba_tpu_torch.io.dataset_io import (load_dataset, save_dataset,
                                              save_ground_truth)
    from srba_tpu_torch.io.export import save_graphslam_g2o
    from srba_tpu_torch.io.g2o import load_g2o
    from srba_tpu_torch.solver.global_graphslam import (
        PGOConfig, optimize_global_pose_graph)

    t_phase = time.perf_counter()
    world, ds, model, sigma, _, _ = cfg1
    launches = {}
    tmp = tempfile.TemporaryDirectory(prefix="srba_cli_")
    d = tmp.name
    data, gt = f"{d}/config1.txt", f"{d}/config1.txt.gt"
    save_dataset(ds, data)
    save_ground_truth(world, gt)
    name, frames, odo = load_dataset(data)
    exact = (name == model and all(
        [m for m, _ in fa] == [m for m, _ in fb]
        and all(np.array_equal(za, zb) for (_, za), (_, zb) in zip(fa, fb))
        for fa, fb in zip(frames, ds.frames))
        and all(np.array_equal(a, b) for a, b in zip(odo, ds.odometry)))
    # Phase 5's engine: bench.py's SrbaParams(max_tree_depth=4,
    # max_optimize_depth=4) (max_iters 20, the CLI's default is 12) and
    # NoiseIdentity(0.005); the chain policy is the CLI's default.
    flags = ["--max-tree-depth", "4", "--max-optimize-depth", "4",
             "--max-iters", "20", "--obs-noise-std", str(sigma),
             "--device", "cuda"]
    probe = _make_engine(build_parser().parse_args(
        ["--dataset", data, *flags]), name)
    check(probe.parameters == snap5["parameters"]
          and (probe.noise.name, probe.noise.std) == snap5["noise"]
          and probe.ecp.name == snap5["ecp"]
          and probe.model.name == snap5["model"],
          "the CLI's engine is not phase 5's")
    del probe
    log(f"[20] config #1's dataset written and read back: {len(frames)} "
        f"KFs, float32 round trip through %.9g exact: {exact}; CLI flags "
        f"{' '.join(flags)} give phase 5's engine (SrbaParams, "
        f"NoiseIdentity({sigma}), {snap5['ecp']})")

    # (a) the whole run with every output.
    out = {k: f"{d}/map.{k}" for k in ("g2o", "json", "html", "npz")}
    metrics = f"{d}/metrics.jsonl"
    reset_launch_counts(bl)
    summary, err, dt = run_cli([
        "--dataset", data, "--gt-path", gt, *flags, "--json",
        "--metrics-jsonl", metrics, "--export-g2o", out["g2o"],
        "--export-scene-json", out["json"], "--export-html", out["html"],
        "--save-checkpoint", out["npz"], "--profile-stats"])
    launches["cli_config1"] = launches_by_d(bl)
    by_shape = dict(bl.spd_inverse_cuda.launches_by_shape)
    rows = [json.loads(ln) for ln in open(metrics)]
    log(f"[20a] CLI config #1 on {card}: {json.dumps(summary)}; "
        f"{summary['num_kfs'] / dt:.2f} KF/s by the call's wall time "
        f"{dt:.3f} s (the summary's kf_per_sec {summary['kf_per_sec']} "
        "stops its clock before the last keyframe's device work ends)")
    log(f"[20a] spd_inverse kernel launches by [B, d]: {shapes(by_shape)} "
        f"(phase 5: {shapes(snap5['by_shape'])}); {len(rows)} metrics "
        "rows; "
        + " ".join(ln for ln in err.splitlines() if "mirror syncs" in ln))
    ate5 = snap5["ate"]
    d_ate = abs(summary["ate_rmse"] - ate5)
    check(summary["num_edges"] == snap5["num_edges"]
          and summary["num_landmarks"] == snap5["num_landmarks"]
          and summary["num_kfs"] == snap5["num_kfs"],
          "the CLI's config #1 run built another problem than phase 5's")
    check(summary["ate_rmse"] <= ATE_BOUND["config1"],
          f"CLI config #1 ATE {summary['ate_rmse']} > bound")
    check(d_ate <= CLI_ATE_ATOL, f"CLI config #1 ATE {summary['ate_rmse']} "
          f"vs phase 5's {ate5}")
    check(by_shape == snap5["by_shape"],
          "the CLI's config #1 run launched the kernel at other shapes or "
          "counts than phase 5's")
    check(len(rows) == len(frames) and all(np.isfinite(v) for r in rows
                                           for v in r.values()),
          "CLI metrics rows")
    tables = checkpoint_arrays(out["npz"])
    same = all(np.array_equal(tables[t], v)
               for t, v in snap5["tables"].items())
    log(f"[20a] ATE {summary['ate_rmse']} m vs phase 5's {ate5:.6f} m "
        f"(|diff| {d_ate:.1e}, atol {CLI_ATE_ATOL}; the summary rounds to "
        f"6 decimals); the CLI's checkpoint tables bitwise equal to phase "
        f"5's state: {same}")
    check(same or not exact, "with an exact dataset round trip the CLI's "
          "run must equal phase 5's bitwise")

    # (b) stop at KF 50, resume to KF 100.
    ck50, ck50b = f"{d}/ck50.npz", f"{d}/ck50b.npz"
    reset_launch_counts(bl)
    s50, _, dt50 = run_cli(["--dataset", data, *flags, "--json",
                            "--limit-kfs", "50", "--save-checkpoint", ck50])
    s100, err_r, dt100 = run_cli(["--dataset", data, "--gt-path", gt, *flags,
                                  "--json", "--resume-checkpoint", ck50])
    launches["cli_resume"] = launches_by_d(bl)
    d_res = abs(s100["ate_rmse"] - summary["ate_rmse"])
    log(f"[20b] CLI stopped at KF {s50['num_kfs']} ({dt50:.3f} s) and "
        f"resumed ({err_r.strip().splitlines()[0]}; {dt100:.3f} s): "
        f"{json.dumps(s100)}; ATE {s100['ate_rmse']} m vs uninterrupted "
        f"{summary['ate_rmse']} m, |diff| {d_res:.3e} (atol "
        f"{RESUME_ATE_ATOL}); launches {launches['cli_resume']}")
    check(s50["num_kfs"] == 50 and s100["num_kfs"] == len(frames),
          "CLI resume keyframe counts")
    check(d_res <= RESUME_ATE_ATOL
          and s100["ate_rmse"] <= ATE_BOUND["config1"],
          "the resumed CLI run's ATE")
    eng_l = load_checkpoint(ck50, device="cuda")
    check(eng_l.device_master.pose.is_cuda, "checkpoint loaded off the card")
    save_checkpoint(eng_l, ck50b)
    a, b = checkpoint_arrays(ck50), checkpoint_arrays(ck50b)
    check(arrays_equal(a, b), "a checkpoint loaded on the card and saved "
          "again differs from the original")
    log(f"[20b] the KF-50 checkpoint loaded on the card and saved again: "
        f"all {len(a)} arrays (meta included) bitwise equal")

    # (c) --pgo-g2o on a map with a loop and on phase 9's problem.  (a)'s
    # map is a tree (config #1's chain policy), already at its optimum, so
    # it is only read back; phase 19's var1 map closes its loop with a
    # closure edge, which the local windows leave inconsistent.
    prob_a = load_g2o(out["g2o"])
    check((len(prob_a["nodes"]), len(prob_a["edges"]))
          == (snap5["num_kfs"], snap5["num_edges"]),
          "(a)'s exported map.g2o does not read back as its graph")
    var1_g2o = f"{d}/var1.g2o"
    save_graphslam_g2o(eng_var1, var1_g2o)
    reset_launch_counts(bl)
    sm, _, dtm = run_cli(["--pgo-g2o", var1_g2o, "--json", "--device",
                          "cuda"])
    log(f"[20c] (a)'s map.g2o read back: {len(prob_a['nodes'])} nodes, "
        f"{len(prob_a['edges'])} edges; CLI --pgo-g2o on phase 19's var1 "
        f"map ({sm['edges']} edges on {sm['nodes']} nodes): {json.dumps(sm)} "
        f"({dtm:.3f} s)")
    check(sm["converged"] == 1 and sm["iters"] >= 1
          and sm["err_final"] < sm["err_init"],
          "CLI --pgo-g2o on the var1 map")
    big = f"{d}/pgo20k.g2o"
    t0 = time.perf_counter()
    write_pgo_g2o(pgo20k, big)
    prob = load_g2o(big)
    nodes9 = np.asarray(pgo20k["nodes"], np.float32)
    rel = np.stack([e["rel_pose"] for e in prob["edges"]])
    rel9 = np.stack([e["rel_pose"] for e in pgo20k["edges"]]).astype(
        np.float32)
    check([(e["from"], e["to"]) for e in prob["edges"]]
          == [(e["from"], e["to"]) for e in pgo20k["edges"]]
          and np.array_equal(prob["nodes"][:, :3], nodes9[:, :3])
          and np.array_equal(rel[:, :3], rel9[:, :3])
          and np.all(prob["edge_weights"] == 1.0),
          "load_g2o does not return phase 9's graph")
    d_q = max(float(np.abs(prob["nodes"] - nodes9).max()),
              float(np.abs(rel - rel9).max()))
    check(d_q <= G2O_QUAT_ATOL, f"load_g2o's quaternions {d_q:.2e} off")
    log(f"[20c] phase 9's problem written as g2o text and read back in "
        f"{time.perf_counter() - t0:.2f} s: edges, translations (as the "
        f"float32 the solver takes) and weights (all 1) bitwise equal; "
        f"quaternions within {d_q:.2e} (atol {G2O_QUAT_ATOL}: load_g2o "
        "renormalizes each in float64)")
    cli_cfg = PGOConfig(group="SE3", chordal_init=True)
    _, direct = optimize_global_pose_graph(pgo20k, cli_cfg, device="cuda")
    reset_launch_counts(bl)
    with pgo_kernel_inputs() as stacks:
        s20, _, dt20 = run_cli(["--pgo-g2o", big, "--json", "--device",
                                "cuda"])
    launches["cli_pgo_g2o"] = launches_by_d(bl)
    by_shape = dict(bl.spd_inverse_cuda.launches_by_shape)
    gap9 = abs(s20["err_final"] - pgo20k_info["err_final"]) \
        / pgo20k_info["err_final"]
    gap = abs(s20["err_final"] - direct["err_final"]) / direct["err_final"]
    log(f"[20c] CLI --pgo-g2o on phase 9's problem on {card}: "
        f"{json.dumps(s20)} ({dt20:.3f} s); kernel launches by [B, d]: "
        f"{shapes(by_shape)}")
    # The CLI solves with the JAX package's CLI settings (PGOConfig(group,
    # chordal_init=True): CG 50, abs_tol_per_edge 5e-6), not bench_pgo's
    # (CG 100, abs_tol_per_edge 2e-5, which bench.py sets above this
    # problem's noise floor of ~1.3e-5 per edge).  So it is held to the
    # same solve on phase 9's arrays, certified or not (the JAX CLI ends
    # this graph uncertified too: tests/test_torch_g2o.py holds the two
    # CLIs to each other on its 2000-node cut).
    log(f"[20c] err_final {s20['err_final']:.6e}, iters {s20['iters']}, "
        f"converged={s20['converged']}: the same solve (the CLI's "
        f"PGOConfig(group='SE3', chordal_init=True)) on phase 9's arrays "
        f"{direct['err_final']:.6e}, iters {direct['iters']:.0f}, "
        f"converged={direct['converged']:.0f}, rel diff {gap:.3e} (rtol "
        f"{PGO_ERR_RTOL}); phase 9's own solve (bench_pgo's PGOConfig: no "
        f"chordal init, CG 100, abs_tol_per_edge 2e-5) "
        f"{pgo20k_info['err_final']:.6e}, rel diff {gap9:.3e}")
    check(s20["err_final"] < s20["err_init"], "CLI --pgo-g2o 20k descent")
    check(gap < PGO_ERR_RTOL
          and (s20["iters"], s20["converged"])
          == (int(direct["iters"]), int(direct["converged"])),
          "CLI --pgo-g2o 20k is not the same solve as on phase 9's arrays")
    check(set(by_shape) == {(32768, 6)} and by_shape[(32768, 6)] > 0,
          f"CLI --pgo-g2o 20k kernel shapes {by_shape}")
    check_kernel_on("[20c]", bl, stacks)
    tmp.cleanup()
    log(f"[20] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return launches


TUTORIALS = ("tutorial_global_map_recovery", "tutorial_graph_slam_se2",
             "tutorial_local_areas_loop_closure", "tutorial_rangebearing_se2",
             "tutorial_rangebearing_se3", "tutorial_stereo_se3")


def phase_tutorials(card: str, bl):
    """Phase 21: the six tutorials, ``main(device="cuda")`` at their own
    sizes.  Returns the kernel's launches per block size over all six."""
    import importlib
    import io
    from contextlib import redirect_stdout

    t_phase = time.perf_counter()
    reset_launch_counts(bl)
    for name in TUTORIALS:
        mod = importlib.import_module(f"srba_tpu_torch.examples.{name}")
        out = io.StringIO()
        t0 = time.perf_counter()
        with redirect_stdout(out):
            mod.main(device="cuda")
        torch_sync()
        lines = out.getvalue().strip().splitlines()
        log(f"[21] {name} on {card}: {time.perf_counter() - t0:.3f} s; "
            f"{' | '.join(lines[-2:])}")
    launches = launches_by_d(bl)
    check(sum(launches.values()) > 0, "the tutorials never launched the "
          "spd_inverse kernel")
    log(f"[21] spd_inverse kernel launches by [B, d]: "
        f"{shapes(bl.spd_inverse_cuda.launches_by_shape)}")
    log(f"[21] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return launches


@contextmanager
def step_infos():
    """Records the info every ``optimize_local_area`` run inside returns
    (the window solves' errors, iterations, lambda, observations)."""
    from srba_tpu_torch.engine.engine import SrbaEngine
    seen = []
    optimize = SrbaEngine.optimize_local_area

    def recorder(self, *args, **kwargs):
        info = optimize(self, *args, **kwargs)
        seen.append(dict(info))
        return info

    SrbaEngine.optimize_local_area = recorder
    try:
        yield seen
    finally:
        SrbaEngine.optimize_local_area = optimize


@contextmanager
def collective_rounds():
    """Counts and times every ``torch.distributed`` all-reduce and
    broadcast made inside: ``{op: [calls, seconds]}``.  Each call waits for
    the card before it starts and after it ends, so its time is the
    collective's alone (the transport, for gloo the copies to the host and
    back); the numbers are the same as without the waits."""
    import torch
    import torch.distributed as dist
    seen = {"all_reduce": [0, 0.0], "broadcast": [0, 0.0]}
    inner = {op: getattr(dist, op) for op in seen}

    def timed(op):
        def call(tensor, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner[op](tensor, *args, **kwargs)
            torch.cuda.synchronize()
            seen[op][0] += 1
            seen[op][1] += time.perf_counter() - t0
            return out
        return call

    for op in seen:
        setattr(dist, op, timed(op))
    try:
        yield seen
    finally:
        for op, fn in inner.items():
            setattr(dist, op, fn)


def rounds_line(rounds, per: int, what: str) -> str:
    n, sec = rounds["all_reduce"]
    if not n:
        return "no all-reduce"
    return (f"{n} all-reduce rounds = {n / max(per, 1):.1f} per {what}, "
            f"mean {1e3 * sec / n:.3f} ms")


def save_engine(eng, name: str) -> str:
    """A checkpoint of ``eng`` under the system's temporary directory."""
    import os
    import tempfile

    from srba_tpu_torch.io.checkpoint import save_checkpoint
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_"),
                        f"{name}.npz")
    save_checkpoint(eng, path)
    return path


def digest(*arrays) -> str:
    """SHA-256 of arrays' bytes, in order."""
    import hashlib
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def state_digest(eng) -> str:
    """SHA-256 of an engine's edge and landmark tables (host mirror)."""
    st = eng.get_rba_state()
    return digest(st.k2k_pose[: st.num_edges], st.lm_state[: st.num_lms])


def masters_digest(eng) -> str:
    """SHA-256 of a device-master engine's pose, prior and landmark
    masters."""
    dm = eng.device_master
    return digest(*(t.cpu().numpy() for t in (dm.pose, dm.prior, dm.lm)))


def phase_mesh_one_rank(card: str, bl, cfg1, host16, pgo9, pgo10, refine18):
    """Phase 22: the mesh paths in this process on a world of one rank
    (NCCL): config #1 through ``SrbaEngine(device_master=False,
    mesh=make_mesh())`` against phase 16, pgo20k with ``mesh=`` against
    phase 9, config #4's ``optimize_global(mesh=...)`` (its LM-PCG and its
    terminal call, on phase 8's map from a checkpoint) against phase 10,
    ``refine_map(mesh=...)`` on config #1 against phase 18; each bitwise,
    each with its kernel stacks held to plain and its collective rounds.
    Returns the launches by path and config #1's ATE."""
    import os
    import shutil

    import torch.distributed as dist

    from srba_tpu_torch.io.checkpoint import load_checkpoint
    from srba_tpu_torch.parallel import make_mesh
    from srba_tpu_torch.parallel import multihost as mh
    from srba_tpu_torch.solver import global_graphslam as pgo
    from srba_tpu_torch.solver import lm
    from srba_tpu_torch.solver.global_graphslam import (
        PGOConfig, optimize_global_pose_graph)

    t_phase = time.perf_counter()
    mh.initialize()
    mesh = make_mesh()
    check(dist.get_backend() == "nccl" and mesh.size() == 1,
          f"[22] expected one NCCL rank, got {dist.get_backend()} x "
          f"{mesh.size()}")
    log(f"[22] process group: {dist.get_backend()}, world size "
        f"{dist.get_world_size()}, {mesh} (on {card})")
    launches = {}

    # (a) config #1 in the host-window mode over the mesh.
    eng16, ate16, infos16 = host16
    reset_launch_counts(bl)
    with step_infos() as infos, kernel_inputs(lm) as stacks, \
            collective_rounds() as rounds:
        eng, dt, ate = run_config(cfg1, "cuda", device_master=False,
                                  mesh=mesh)
    launches["mesh_config1"] = launches_by_d(bl)
    by_shape = dict(bl.spd_inverse_cuda.launches_by_shape)
    solves = sum("skipped" not in i for i in infos)
    kfs = eng.num_keyframes
    check(eng.mesh is mesh and eng.device_master is None,
          "[22] the mesh engine is not in the host-window mode")
    check(np.array_equal(eng.state.k2k_pose, eng16.state.k2k_pose)
          and np.array_equal(eng.state.lm_state, eng16.state.lm_state)
          and ate == ate16 and infos == infos16,
          "[22] config #1 over a one-rank mesh is not bitwise phase 16")
    check(launches["mesh_config1"].get(2, 0) > 0,
          "[22] config #1 never launched the kernel on [L, 2, 2]")
    log(f"[22] config #1 host-window over the mesh on {card}: {kfs} KFs in "
        f"{dt:.3f} s = {kfs / dt:.2f} KF/s (each collective waits for the "
        f"card), ATE {ate:.6f} m; edge and landmark tables, ATE and the "
        f"{len(infos)} window solves' errors, iterations and lambdas "
        f"bitwise phase 16's; {rounds_line(rounds, solves, 'solve')}; "
        f"spd_inverse kernel launches by [B, d]: {shapes(by_shape)}")
    check_kernel_on("[22] config #1", bl, stacks)

    # (b) pgo20k, edge-sharded.
    prob, G9 = pgo9
    reset_launch_counts(bl)
    with kernel_inputs(pgo) as stacks, collective_rounds() as rounds:
        t0 = time.perf_counter()
        G, info = optimize_global_pose_graph(prob, pgo20k_config(),
                                             mesh=mesh, device="cuda")
        dt = time.perf_counter() - t0
    launches["mesh_pgo20k"] = launches_by_d(bl)
    check(np.array_equal(G, G9) and info["converged"] == 1.0,
          f"[22] pgo20k over the mesh is not bitwise phase 9: {info}")
    log(f"[22] pgo20k over the mesh on {card}: {dt:.3f} s, err "
        f"{info['err_init']:.6e} -> {info['err_final']:.6e}, iters "
        f"{info['iters']:.0f}, cg_iters_total {info['cg_iters_total']:.0f}; "
        f"nodes bitwise phase 9's; {rounds_line(rounds, 1, 'solve')}; "
        f"kernel launches by [B, d]: "
        f"{shapes(bl.spd_inverse_cuda.launches_by_shape)}")
    check_kernel_on("[22] pgo20k", bl, stacks)

    # (c) config #4's optimize_global(mesh=...) on phase 8's map.
    ckpt4, (G_lm10, info_lm10), (G10, info10) = pgo10
    eng4 = load_checkpoint(ckpt4, device="cuda")
    shutil.rmtree(os.path.dirname(ckpt4))
    reset_launch_counts(bl)
    with kernel_inputs(pgo) as stacks, collective_rounds() as rounds:
        G_lm, info_lm = eng4.optimize_global(
            PGOConfig(group="SE2", robust_delta=0.1), write_back=False,
            mesh=mesh)
        G, info = eng4.optimize_global(mesh=mesh)
    launches["mesh_config4_pgo"] = launches_by_d(bl)
    check(np.array_equal(G_lm, G_lm10) and info_lm == info_lm10
          and np.array_equal(G, G10) and info == info10,
          "[22] config #4's optimize_global(mesh=...) is not bitwise "
          "phase 10")
    log(f"[22] config #4 (phase 8's map from a checkpoint) "
        f"optimize_global(mesh=...) on {card}: the LM-PCG "
        f"({info_lm['iters']:.0f} LM iterations) and the terminal call "
        f"({info['iters']:.0f}) bitwise phase 10's nodes and infos; "
        f"{rounds_line(rounds, 2, 'solve')}; kernel launches by [B, d]: "
        f"{shapes(bl.spd_inverse_cuda.launches_by_shape)}")
    check_kernel_on("[22] config #4", bl, stacks)

    # (d) refine_map(mesh=...) on config #1 from raw odometry.
    eng18, _ = refine18
    eng_r, _, _ = run_config(cfg1, "cuda", run_local=False)
    reset_launch_counts(bl)
    with sweep_records(keep_stacks=True) as (phases, stacks), \
            collective_rounds() as rounds:
        t0 = time.perf_counter()
        eng_r.refine_map(sweeps=REFINE_SWEEPS, mesh=mesh)
        eng_r.fence()
        dt = time.perf_counter() - t0
    launches["mesh_refine_map_config1"] = launches_by_d(bl)
    check(masters_equal(eng_r, eng18),
          "[22] refine_map(mesh=...) is not bitwise phase 18")
    log(f"[22] config #1 refine_map(sweeps={REFINE_SWEEPS}, mesh=...) on "
        f"{card}: {dt:.3f} s, {len(phases)} phases; masters bitwise phase "
        f"18's; {rounds_line(rounds, len(phases), 'phase')}; kernel "
        f"launches by [B, d]: "
        f"{shapes(bl.spd_inverse_cuda.launches_by_shape)}")
    check_kernel_on("[22] refine_map", bl, stacks, per_block=True)
    dist.destroy_process_group()
    log(f"[22] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "ate": ate}


def ring_worker(rank: int, nprocs: int, store: str, out: str) -> int:
    """One rank of phase 23's ring (``--ring-worker``): gloo on the file
    ``store``, the card shared with the other rank.  Writes its results to
    ``{out}.{rank}.json``."""
    import torch
    import torch.distributed as dist

    import srba_tpu_torch as port
    from srba_tpu_torch.models.noise import NoiseIdentity
    from srba_tpu_torch.ops import block_linalg as bl
    from srba_tpu_torch.parallel import make_mesh
    from srba_tpu_torch.parallel import multihost as mh
    from srba_tpu_torch.solver import global_graphslam as pgo
    from srba_tpu_torch.solver import lm
    from srba_tpu_torch.utils.datasets import ate_rmse

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    tag = f"[23] rank {rank}"
    mh.initialize(f"file://{store}", nprocs, rank, device="cuda",
                  timeout=RING_GROUP_TIMEOUT)
    mesh = make_mesh()
    check(dist.get_backend() == "gloo" and mesh.size() == nprocs,
          f"{tag}: expected {nprocs} gloo ranks")
    bl.load_kernel_library()
    res = {"rank": rank, "backend": dist.get_backend(), "launches": {}}

    cfg1 = make_config("config1")
    world, ds, model, sigma, d, engine_kw = cfg1
    for B in RING_BATCHES:
        reset_launch_counts(bl)
        with kernel_inputs(lm) as stacks, collective_rounds() as rounds, \
                step_infos() as infos:
            eng = mh.MultiHostEngine(model, noise=NoiseIdentity(sigma),
                                     mesh=mesh, broadcast_batch=B,
                                     **engine_kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mh.is_coordinator():
                for k, frame in enumerate(ds.frames):
                    eng.define_new_keyframe(
                        [port.Observation(lm_id=m, z=z) for m, z in frame],
                        edge_init={k - 1: ds.odometry[k - 1]} if k else None)
                tail = eng.stop()
                served = eng.num_keyframes
            else:
                served = eng.serve()
            eng.fence()
            dt = time.perf_counter() - t0
        G, _ = eng.create_complete_spanning_tree(0)
        solves = sum("skipped" not in i for i in infos)
        (n_ar, s_ar), (n_bc, s_bc) = rounds["all_reduce"], rounds["broadcast"]
        lm_iters = (n_ar - 2 * solves) // 2
        res[f"b{B}"] = {
            "served": served, "num_kfs": eng.num_keyframes,
            "tail": len(tail) if mh.is_coordinator() else None,
            "ate": float(ate_rmse(G[:, :d], world.gt_poses[:len(G), :d])),
            "digest": state_digest(eng), "seconds": dt,
            "kf_per_s": eng.num_keyframes / dt, "solves": solves,
            "all_reduce": [n_ar, s_ar], "lm_iters": lm_iters,
            "broadcast": [n_bc, s_bc],
            "by_shape": {f"{B_},{d_}": n for (B_, d_), n in
                         bl.spd_inverse_cuda.launches_by_shape.items()}}
        res["launches"][f"ring_b{B}_config1_rank{rank}"] = launches_by_d(bl)
        check_kernel_on(f"{tag} config #1 broadcast_batch={B}", bl, stacks)

    prob = pgo20k_problem()
    reset_launch_counts(bl)
    with kernel_inputs(pgo) as stacks, collective_rounds() as rounds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        G, info = pgo.optimize_global_pose_graph(prob, pgo20k_config(),
                                                 mesh=mesh, device="cuda")
        dt = time.perf_counter() - t0
    res["pgo20k"] = {"info": info, "seconds": dt,
                     "digest": digest(G),
                     "all_reduce": rounds["all_reduce"],
                     "by_shape": {f"{B_},{d_}": n for (B_, d_), n in
                                  bl.spd_inverse_cuda.launches_by_shape
                                  .items()}}
    res["launches"][f"ring_pgo20k_rank{rank}"] = launches_by_d(bl)
    check_kernel_on(f"{tag} pgo20k", bl, stacks)

    eng, _, _ = run_config(cfg1, "cuda", run_local=False)
    err0 = eng.eval_overall_squared_error()
    reset_launch_counts(bl)
    with sweep_records(keep_stacks=True) as (phases, stacks), \
            collective_rounds() as rounds:
        t0 = time.perf_counter()
        eng.refine_map(sweeps=REFINE_SWEEPS, mesh=mesh)
        eng.fence()
        dt = time.perf_counter() - t0
    res["refine_map"] = {"error": eng.eval_overall_squared_error(),
                         "error0": err0,
                         "seconds": dt, "phases": phases,
                         "digest": masters_digest(eng),
                         "all_reduce": rounds["all_reduce"]}
    res["launches"][f"ring_refine_map_config1_rank{rank}"] = \
        launches_by_d(bl)
    check_kernel_on(f"{tag} refine_map", bl, stacks, per_block=True)
    mh.sync_processes("done")
    dist.destroy_process_group()
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(res, f)
    return 0


def phase_ring(card: str, mesh22, info9, err18):
    """Phase 23: a two-rank gloo ring on the one card, each rank a process
    running ``ring_worker``: config #1 through ``MultiHostEngine`` with
    ``broadcast_batch`` 1 and 4 (rank 0 feeds, rank 1 serves), the
    edge-sharded pgo20k and the window-sharded ``refine_map`` on config #1.
    Returns the kernel's launches by path and rank."""
    import os
    import tempfile

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ring_") as tmp:
        store, out = os.path.join(tmp, "store"), os.path.join(tmp, "out")
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(here, "chip_smoke.py"),
             "--ring-worker", str(r), str(RING_RANKS), store, out],
            cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(RING_RANKS)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=RING_TIMEOUT)[0].decode(
                    errors="replace"))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(procs):
            for line in logs[r].splitlines():
                if line.startswith("[23]"):
                    log(line)
            check(p.returncode == 0, f"[23] rank {r} failed (rc "
                  f"{p.returncode}):\n{logs[r][-4000:]}")
        ranks = []
        for r in range(RING_RANKS):
            with open(f"{out}.{r}.json") as f:
                ranks.append(json.load(f))
    r0, r1 = ranks
    for B in RING_BATCHES:
        a, b = r0[f"b{B}"], r1[f"b{B}"]
        check(b["served"] == 100 and a["num_kfs"] == b["num_kfs"] == 100,
              f"[23] broadcast_batch={B}: {b['served']} KFs served")
        check(a["digest"] == b["digest"] and a["ate"] == b["ate"],
              f"[23] broadcast_batch={B}: the replicas differ")
        check(a["ate"] <= ATE_BOUND["config1"]
              and abs(a["ate"] - mesh22["ate"]) <= RING_ATE_ATOL,
              f"[23] broadcast_batch={B}: ATE {a['ate']} (bound "
              f"{ATE_BOUND['config1']}, phase 22 {mesh22['ate']})")
        for r in ranks:
            check(r[f"b{B}"]["by_shape"].get("64,2", 0) > 0,
                  f"[23] rank {r['rank']} never launched the kernel on "
                  "[64,2,2]")
            rb = r[f"b{B}"]
            n_ar, s_ar = rb["all_reduce"]
            n_bc, s_bc = rb["broadcast"]
            log(f"[23] rank {r['rank']} config #1 MultiHostEngine "
                f"broadcast_batch={B} on {card} (2 gloo ranks sharing it; "
                f"each collective waits for the card): {rb['num_kfs']} KFs "
                f"in {rb['seconds']:.3f} s = {rb['kf_per_s']:.2f} KF/s, ATE "
                f"{rb['ate']:.6f} m; broadcasts {n_bc} = "
                f"{1e3 * s_bc / rb['num_kfs']:.3f} ms per KF; all-reduces "
                f"{n_ar} over {rb['solves']} solves and {rb['lm_iters']} LM "
                f"iterations = {1e3 * s_ar / max(rb['lm_iters'], 1):.3f} ms "
                f"per LM iteration (mean {1e3 * s_ar / max(n_ar, 1):.3f} ms "
                f"per round); kernel launches by [B,d]: {rb['by_shape']}"
                + (f"; stop() returned {rb['tail']} infos"
                   if rb["tail"] is not None else ""))
    check(r0[f"b{RING_BATCHES[1]}"]["digest"]
          == r0[f"b{RING_BATCHES[0]}"]["digest"],
          "[23] broadcast_batch=4 is not bitwise broadcast_batch=1")
    log(f"[23] config #1: the replicas' edge and landmark tables bitwise "
        f"equal, broadcast_batch=4 bitwise broadcast_batch=1, ATE "
        f"{r0['b1']['ate']:.6f} m within {RING_ATE_ATOL} m of phase 22's "
        f"{mesh22['ate']:.6f} m")
    p0, p1 = r0["pgo20k"], r1["pgo20k"]
    err = p0["info"]["err_final"]
    check(p0["digest"] == p1["digest"],
          "[23] pgo20k: the replicas' nodes differ")
    check(p0["info"]["converged"] == 1.0
          and abs(err - info9["err_final"]) <= RING_PGO_ERR_RTOL
          * info9["err_final"],
          f"[23] pgo20k: {p0['info']} (phase 9 err_final "
          f"{info9['err_final']:.6e})")
    n_ar, s_ar = p0["all_reduce"]
    log(f"[23] pgo20k edge-sharded over 2 ranks on {card}: "
        f"{p0['seconds']:.3f} s, certified, err_final {err:.6e} (phase 9 "
        f"{info9['err_final']:.6e}, rel diff "
        f"{abs(err - info9['err_final']) / info9['err_final']:.3e}), iters "
        f"{p0['info']['iters']:.0f}, cg_iters_total "
        f"{p0['info']['cg_iters_total']:.0f}; nodes bitwise equal across "
        f"ranks; {n_ar} all-reduce rounds, mean "
        f"{1e3 * s_ar / max(n_ar, 1):.3f} ms; kernel launches by [B,d] "
        f"{p0['by_shape']} (rank 0), {p1['by_shape']} (rank 1)")
    s0, s1 = r0["refine_map"], r1["refine_map"]
    rel = abs(s0["error"] - err18) / err18
    check(s0["digest"] == s1["digest"],
          "[23] refine_map: the replicas' masters differ")
    check(rel <= RING_REFINE_RTOL
          and s0["error"] < REFINE_GAIN * s0["error0"],
          f"[23] refine_map error {s0['error0']} -> {s0['error']} (phase 18 "
          f"{err18})")
    n_ar, s_ar = s0["all_reduce"]
    log(f"[23] config #1 refine_map(sweeps={REFINE_SWEEPS}) window-sharded "
        f"over 2 ranks on {card}: {s0['seconds']:.3f} s, error "
        f"{s0['error0']:.6e} -> {s0['error']:.6e} (phase 18 {err18:.6e}, "
        f"rel diff {rel:.3e}, "
        f"rtol {RING_REFINE_RTOL}); masters bitwise equal across ranks; "
        f"{n_ar} all-reduce rounds over {len(s0['phases'])} phases, mean "
        f"{1e3 * s_ar / max(n_ar, 1):.3f} ms")
    log(f"[23] phase wall time {time.perf_counter() - t_phase:.1f} s")
    launches = {}
    for r in ranks:
        for path, by_d in r["launches"].items():
            launches[path] = {int(k): v for k, v in by_d.items()}
    return launches


def torch_sync() -> None:
    import torch
    torch.cuda.synchronize()


def phase_kernel(card: str, bl, tiles):
    """Phase 3: the kernel against its plain version on the card, then its
    times at ``spd_inverse_bench.SHAPES``.  Returns (times by shape, the
    largest difference from plain)."""
    import torch

    from srba_tpu_torch.tools import spd_inverse_bench as kb

    t_phase = time.perf_counter()
    max_err = max_rel = 0.0
    # The B of the paths: 64 and 256 (window buckets), 256 (config #4's
    # PGO), 512 (config #3's PGO), 1024 and 8192 at d = 6 (config #5's PGO
    # at 1000 and 5000 keyframes), 32768 (pgo20k); others test odd and
    # large stacks and the edges of a CTA's T blocks (T - 1, T + 1, 2T + 1).
    kernel_shapes = [(B, d) for d in (1, 2, 3, 6)
                     for B in (1, 7, 300, 64, 256, 512, 4096, 32768,
                               131072)]
    kernel_shapes += [(1024, 6), (8192, 6)]
    # refine_map's sweep stacks [W*L, l, l] on configs #1 and #2 (phase 18).
    kernel_shapes += [(768, 2), (832, 2), (768, 3), (2816, 3), (3072, 3)]
    kernel_shapes += [(B, d) for d, T in tiles.items()
                      for B in (T - 1, T + 1, 2 * T + 1)]
    for B, d in kernel_shapes:
        m = torch.as_tensor(kb.spd_stack(B, d), device="cuda")
        out = bl.spd_inverse_cuda(m)
        ref = bl.spd_inverse_unrolled(m)
        torch.cuda.synchronize()
        err, rel = float((out - ref).abs().max()), block_rel_diff(out, ref)
        max_err, max_rel = max(max_err, err), max(max_rel, rel)
        check(torch.allclose(out, ref, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
              and rel <= KERNEL_BLOCK_RTOL,
              f"kernel != plain at [{B},{d},{d}]: max|diff| {err:.3e}, "
              f"per block {rel:.3e}")
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
    log(f"[3] kernel matches plain (rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}, "
        f"per block {KERNEL_BLOCK_RTOL} of its scale: largest "
        f"{max_rel:.3e}) at {len(kernel_shapes)} shapes, d in {{1,2,3,6}}; "
        f"[8192,6,6] with 6·I added max|diff| {err:.3e} (< 1e-3); "
        f"max|diff| overall {max_err:.3e}; a [4097,3,3] view at a 36-byte "
        "offset bitwise equal to the kernel on an aligned copy")
    timer = kb.KernelTimer()
    times = {}
    for B, d in kb.SHAPES:
        times[(B, d)] = kb.measure_shape(B, d, timer)
        log(f"[3] {kb.format_shape(B, d, times[(B, d)])} (on {card})")
    log(f"[3] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return times, max_err


def finish(card: str, times, max_err: float, launches, t_start) -> int:
    """The kernels line, the card line and the result line; returns 0."""
    import torch

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
    import srba_tpu_torch.native as native
    from srba_tpu_torch.tools import spd_inverse_bench as kb
    t0 = time.perf_counter()
    check(native.get_lib() is not None, "the native window builder did not "
          "build (no g++?)")
    info = native.build_info
    log(f"[2] native window builder built and loaded in "
        f"{time.perf_counter() - t0:.2f} s: {info['cmd']}; library "
        f"{info['so']}; source+flags hash {info['digest']}")
    engines = require_native()
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
    times, max_err = phase_kernel(card, bl, tiles)

    if "--config5-full" in sys.argv[1:]:
        launches = run_config5_full(card, bl)
        check_flags()
        return finish(card, times, max_err, launches, t_start)
    if "--bucket-pairs" in sys.argv[1:]:
        launches = run_bucket_pairs(card, bl)
        check_flags()
        return finish(card, times, max_err, launches, t_start)

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
    with window_buckets() as buckets:
        eng, dt, ate = run_config(cfg1, "cuda")
    launches = {"config1": launches_by_d(bl)}
    snap5 = {"by_shape": dict(bl.spd_inverse_cuda.launches_by_shape)}
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
        f"{launches['config1']}, mean device_step "
        f"{mean_device_step_ms(eng):.3f} ms")
    log(f"[5] window steps by padded (E, L, N) and LM iterations: "
        f"{buckets_line(buckets)}")
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
    snap5.update(phase5_snapshot(eng, ate))
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
    launches["config2"], eng2, _ = phase_config(7, "config2", card, bl)
    launches["config4"], eng4, cfg4 = phase_config(8, "config4", card, bl)
    check_flags()

    # -- 9. 20k-node SE(3) PGO, 10. config #4's optimize_global, 11. chordal
    launches["pgo20k"], pgo20k, pgo20k_info, pgo20k_G = phase_pgo20k(card,
                                                                      bl)
    check_flags()
    # Config #4's map before phase 10's solves, for phase 22.
    ckpt4 = save_engine(eng4, "config4")
    launches["config4_pgo"], *pgo10 = phase_config4_pgo(eng4, cfg4, card,
                                                        bl)
    check_flags()
    phase_chordal(card)
    check_flags()

    # -- 12. config #3 end to end, 13. its global PGO ------------------------
    launches["config3"], eng3, cfg3 = phase_config3(card, bl)
    check_flags()
    launches["config3_pgo"] = phase_config3_pgo(eng3, cfg3, card, bl)
    check_flags()

    # -- 14. config #5 at 1000 KFs, 15. its terminal global PGO --------------
    launches["config5"], eng5, cfg5 = phase_config5(card, bl)
    check_flags()
    launches["config5_pgo"], _, _, ate5, _ = phase_config5_pgo(
        eng5, cfg5, card, bl)
    check(ate5 <= ATE_BOUND["config5_1k"], f"config5 PGO ATE {ate5} > bound")
    check_flags()

    # -- 16. host-window config #1, 17. solver variants, 18. refine_map,
    # 19. LocalAreasVar1 ---------------------------------------------------
    launches["host_window_config1"], host16 = phase_host_window(
        eng, ate, cfg1, card, bl)
    check_flags()
    launches["solver_variants"] = phase_solver_variants(eng2, card, bl)
    check_flags()
    timer = kb.KernelTimer()
    refine18 = {}
    for name in ("config1", "config2"):
        launches[f"refine_map_{name}"], refine18[name] = phase_refine_map(
            name, card, bl, timer, times)
    phase_refine_optimized(eng, cfg1, card)
    check_flags()
    launches["var1"], eng_var1 = phase_var1(card, bl)
    check_flags()

    # -- 20. the CLI, 21. the tutorials --------------------------------------
    launches.update(phase_cli(card, bl, cfg1, snap5, pgo20k, pgo20k_info,
                              eng_var1))
    check_flags()
    launches["tutorials"] = phase_tutorials(card, bl)
    check_flags()
    log(f"[21] engines made by the script, the CLI and the tutorials: "
        f"{engines['device_master']} device-master engines, each building "
        f"its windows natively; {engines['host_window']} host-window "
        "engines (the Python builder)")

    # -- 22. the mesh paths on one rank (NCCL), 23. a two-rank gloo ring ----
    mesh22 = phase_mesh_one_rank(card, bl, cfg1, host16, (pgo20k, pgo20k_G),
                                 (ckpt4, *pgo10), refine18["config1"])
    launches.update(mesh22["launches"])
    check_flags()
    launches.update(phase_ring(card, mesh22, pgo20k_info,
                               refine18["config1"][1]))
    check_flags()

    return finish(card, times, max_err, launches, t_start)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ring-worker"]:
        # Phase 23's ranks: the script itself in a fresh process each, as
        # CUDA cannot fork.
        sys.exit(ring_worker(int(sys.argv[2]), int(sys.argv[3]),
                             sys.argv[4], sys.argv[5]))
    sys.exit(main())
