"""``srba_slam_torch`` — dataset-driven offline SLAM runner; the port of
:mod:`srba_tpu.cli` (the analog of the reference's ``apps/srba-slam``
binary: flags, a per-keyframe loop over a text dataset, ground-truth error,
profiler dump).

    python -m srba_tpu_torch.cli --synthetic loop2d --json            # card
    python -m srba_tpu_torch.cli --synthetic loop2d --device cpu --json

Every flag of the JAX package's runner is here with the same meaning, file
formats and summary keys, except ``--jax-cache`` (the XLA compile cache);
``--device`` (default ``cuda``, which raises where there is no CUDA) takes
its place.  The problem type is resolved at run time from the flags.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="srba_slam_torch",
        description="SRBA on PyTorch/CUDA: run SLAM over a dataset file or "
                    "a synthetic world.")
    src = p.add_argument_group("input")
    src.add_argument("--dataset", help="dataset text file (see io.dataset_io)")
    src.add_argument("--pgo-g2o", metavar="FILE",
                     help="standalone pose-graph mode: load a g2o text "
                          "pose graph (VERTEX/EDGE SE2 or SE3:QUAT), run "
                          "the global PGO on --device, print the error "
                          "summary; write the optimized graph with "
                          "--export-g2o.  Lets public benchmarks "
                          "(sphere2500, manhattan, ...) drive the solver "
                          "directly")
    src.add_argument("--use-edge-info", action="store_true",
                     help="--pgo-g2o: whiten each edge with its FULL "
                          "(eig-normalized) information matrix instead of "
                          "a scalar weight (per-problem choice; see "
                          "io/export.py design note)")
    src.add_argument("--gt-path", help="ground-truth poses file for ATE eval")
    src.add_argument("--synthetic", choices=["loop2d", "loop3d", "graphslam2d",
                                             "graphslam3d"],
                     help="generate a synthetic dataset instead of reading one")
    src.add_argument("--num-kfs", type=int, default=100)
    src.add_argument("--num-landmarks", type=int, default=180)
    src.add_argument("--noise-std", type=float, default=0.005)
    src.add_argument("--odo-noise-std", type=float, default=0.01)
    src.add_argument("--seed", type=int, default=0)
    src.add_argument("--save-dataset", help="write the (synthetic) dataset here")

    prob = p.add_argument_group("problem type")
    prob.add_argument("--obs", default="RangeBearing2D",
                      help="observation model (see models.OBSERVATION_MODELS)")
    prob.add_argument("--sensor-ini",
                      help="INI file with [CAMERA]/[CAMERA_STEREO]/"
                           "[SENSOR_POSE] sections (the reference's "
                           "CConfigFile sensor-calibration flow); overrides "
                           "the --fx/--fy/... flags")
    prob.add_argument("--sensor-pose-camera", action="store_true",
                      help="mount the sensor with the standard camera axes "
                           "(z forward) on the robot")
    prob.add_argument("--fx", type=float, default=200.0)
    prob.add_argument("--fy", type=float, default=200.0)
    prob.add_argument("--cx", type=float, default=160.0)
    prob.add_argument("--cy", type=float, default=120.0)
    prob.add_argument("--baseline", type=float, default=0.12)

    srba = p.add_argument_group("srba parameters")
    srba.add_argument("--max-tree-depth", type=int, default=4)
    srba.add_argument("--max-optimize-depth", type=int, default=4)
    srba.add_argument("--robust-kernel", action="store_true")
    srba.add_argument("--kernel-param", type=float, default=3.0)
    srba.add_argument("--max-iters", type=int, default=12)
    srba.add_argument("--ecp", choices=["classic_linear_rba",
                                        "local_areas_fixed_grid",
                                        "local_areas_var1"],
                      default="classic_linear_rba")
    srba.add_argument("--submap-size", type=int, default=10)
    srba.add_argument("--min-obs-loop-closure", type=int, default=4)
    srba.add_argument("--min-obs-join", type=int, default=3,
                      help="local_areas_var1: votes needed to join an area")
    srba.add_argument("--obs-noise-std", type=float, default=1.0,
                      help="observation noise sigma for whitening")
    srba.add_argument("--obs-noise-cov",
                      help="full constant observation covariance, row-major "
                           "obs_dim x obs_dim values (comma/space separated) "
                           "— the reference's observation_noise_constant_"
                           "matrix option; overrides --obs-noise-std")

    out = p.add_argument_group("output")
    out.add_argument("--global-opt", action="store_true",
                     help="run global pose-graph optimization (matrix-free "
                          "LM-PCG over all kf2kf edges) after the sequence")
    out.add_argument("--no-local-opt", action="store_true")
    out.add_argument("--step-by-step", action="store_true",
                     help="print per-KF optimize stats")
    out.add_argument("--profile-stats", action="store_true")
    out.add_argument("--export-dot")
    out.add_argument("--export-g2o")
    out.add_argument("--export-ply")
    out.add_argument("--export-scene-json")
    out.add_argument("--export-html",
                     help="standalone interactive 3D map viewer (orbit/"
                          "zoom/pan, no dependencies) — the headless "
                          "analog of the reference's live GUI")
    out.add_argument("--render",
                     help="render the final map to a PNG (top-down for "
                          "SE(2), 3D for SE(3); overlays ground truth when "
                          "available) — the offline analog of the "
                          "reference's live OpenGL window")
    out.add_argument("--render-spantree-root", type=int,
                     help="highlight the spanning tree of this root keyframe"
                          " in --render output")
    out.add_argument("--save-checkpoint")
    out.add_argument("--resume-checkpoint")
    out.add_argument("--limit-kfs", type=int,
                     help="stop after this many keyframes (with "
                          "--save-checkpoint this simulates preemption: "
                          "resume later with --resume-checkpoint)")
    out.add_argument("--metrics-jsonl",
                     help="write one JSON line of per-keyframe metrics "
                          "(errors, iters, lambda, edge/obs counts, wall "
                          "ms) to this file — the structured observability "
                          "stream (device values resolved lazily at the "
                          "end, so the async per-KF loop stays unsynced)")
    out.add_argument("--autosave-checkpoint",
                     help="preemption safety: save a checkpoint here every "
                          "--autosave-every keyframes AND on SIGTERM/SIGINT "
                          "(then exit 0) — resume with --resume-checkpoint")
    out.add_argument("--autosave-every", type=int, default=200)
    out.add_argument("--json", action="store_true",
                     help="print final summary as one JSON line")
    out.add_argument("--verbose", type=int, default=0)
    out.add_argument("--device", default="cuda",
                     help="torch device to run on (default cuda; raises "
                          "where CUDA is not available — pass cpu to run "
                          "on the host)")
    return p


def _make_engine(args, obs_model):
    from srba_tpu_torch.ecps import (ClassicLinearRBA, LocalAreasFixedGrid,
                                     LocalAreasVar1)
    from srba_tpu_torch.engine.engine import SrbaEngine, SrbaParams
    from srba_tpu_torch.models.noise import NoiseConstantMatrix, NoiseIdentity
    from srba_tpu_torch.models.observations import (OBSERVATION_MODELS,
                                                    CameraCalib, StereoCalib)
    from srba_tpu_torch.models.sensor_pose import (SensorPoseNone,
                                                   SensorPoseSE3)
    from srba_tpu_torch.ops.np_lie import CAMERA_SENSOR_POSE_SE3
    from srba_tpu_torch.utils.registry import lookup

    calib = None
    if obs_model in ("MonocularCamera", "RGBDCamera"):
        calib = CameraCalib.make(args.fx, args.fy, args.cx, args.cy)
    elif obs_model == "StereoCamera":
        calib = StereoCalib.make(args.fx, args.fy, args.cx, args.cy,
                                 args.baseline)
    sensor_pose = (SensorPoseSE3(CAMERA_SENSOR_POSE_SE3)
                   if args.sensor_pose_camera else SensorPoseNone())
    obs_dim = lookup(OBSERVATION_MODELS, obs_model,
                     "observation model").obs_dim
    noise = NoiseIdentity(args.obs_noise_std)
    if getattr(args, "obs_noise_cov", None):
        vals = np.asarray(
            [float(v) for v in args.obs_noise_cov.replace(",", " ").split()],
            np.float64)
        if vals.size != obs_dim * obs_dim:
            raise SystemExit(
                f"--obs-noise-cov needs {obs_dim * obs_dim} values for "
                f"{obs_model} ({obs_dim}-d observations), got {vals.size}")
        noise = NoiseConstantMatrix(vals.reshape(obs_dim, obs_dim))
    if getattr(args, "sensor_ini", None):
        from srba_tpu_torch.io.config_ini import (load_noise_ini,
                                                  load_sensor_ini)
        ini_calib, ini_pose = load_sensor_ini(args.sensor_ini, obs_model)
        calib = ini_calib if ini_calib is not None else calib
        sensor_pose = ini_pose if ini_pose is not None else sensor_pose
        ini_noise = load_noise_ini(args.sensor_ini, obs_dim)
        noise = ini_noise if ini_noise is not None else noise
    ecp = {
        "classic_linear_rba": lambda: ClassicLinearRBA(),
        "local_areas_fixed_grid": lambda: LocalAreasFixedGrid(
            args.submap_size, args.min_obs_loop_closure),
        "local_areas_var1": lambda: LocalAreasVar1(
            min_obs_to_join=args.min_obs_join,
            min_obs_count_loop_closure=args.min_obs_loop_closure),
    }[args.ecp]()
    params = SrbaParams(
        max_tree_depth=args.max_tree_depth,
        max_optimize_depth=args.max_optimize_depth,
        use_robust_kernel=args.robust_kernel,
        kernel_param=args.kernel_param,
        max_iters=args.max_iters,
        verbose=args.verbose,
    )
    return SrbaEngine(obs_model, calib=calib, sensor_pose=sensor_pose,
                      ecp=ecp, noise=noise, params=params,
                      device=args.device)


def _synthetic(args):
    from srba_tpu_torch.models.observations import CameraCalib, StereoCalib
    from srba_tpu_torch.utils.datasets import (make_graph_slam_dataset,
                                               make_world_loop_2d,
                                               make_world_loop_3d, observe)

    if args.synthetic in ("graphslam2d", "graphslam3d"):
        world = (make_world_loop_2d(args.num_kfs, 10.0, 1, args.seed)
                 if args.synthetic.endswith("2d")
                 else make_world_loop_3d(args.num_kfs, 10.0, 1,
                                         seed=args.seed))
        ds = make_graph_slam_dataset(world, noise_std=args.noise_std,
                                     odo_noise_std=args.odo_noise_std,
                                     loop_closure_range=4.0, seed=args.seed)
        return world, ds, ds.obs_model
    world = (make_world_loop_2d(args.num_kfs, 10.0, args.num_landmarks,
                                args.seed)
             if args.synthetic == "loop2d"
             else make_world_loop_3d(args.num_kfs, 10.0, args.num_landmarks,
                                     seed=args.seed))
    if args.synthetic == "loop3d" and args.obs == "RangeBearing2D":
        # A 3D world cannot be observed by the (default) 2D model — the
        # SE(3) odometry would feed an SE(2) engine.  Upgrade the default;
        # an explicit 3D-capable --obs is left untouched.
        print("note: --synthetic loop3d defaults --obs to RangeBearing3D",
              file=sys.stderr)
        args.obs = "RangeBearing3D"
    calib = None
    if args.obs in ("MonocularCamera", "RGBDCamera"):
        calib = CameraCalib.make(args.fx, args.fy, args.cx, args.cy)
    elif args.obs == "StereoCamera":
        calib = StereoCalib.make(args.fx, args.fy, args.cx, args.cy,
                                 args.baseline)
    ds = observe(world, args.obs, calib=calib, noise_std=args.noise_std,
                 sensor_range=8.0, odo_noise_std=args.odo_noise_std,
                 seed=args.seed)
    return world, ds, args.obs


def _run_pgo_g2o(args) -> int:
    """Standalone pose-graph mode (--pgo-g2o)."""
    from srba_tpu_torch.io.g2o import load_g2o
    from srba_tpu_torch.solver.global_graphslam import (
        PGOConfig, optimize_global_pose_graph)

    prob = load_g2o(args.pgo_g2o, with_edge_info=args.use_edge_info)
    K, E = len(prob["nodes"]), len(prob["edges"])
    cfg = PGOConfig(group=prob["group"], chordal_init=True,
                    robust_delta=(args.kernel_param / 10.0
                                  if args.robust_kernel else None))
    t0 = time.perf_counter()
    G, info = optimize_global_pose_graph(prob, cfg, device=args.device)
    dt = time.perf_counter() - t0
    summary = {"group": prob["group"], "nodes": K, "edges": E,
               "seconds": round(dt, 3),
               "err_init": float(info["err_init"]),
               "err_final": float(info["err_final"]),
               "iters": int(info["iters"]),
               "converged": int(info["converged"])}
    print(json.dumps(summary) if args.json else
          f"PGO {prob['group']} {K} nodes / {E} edges: err "
          f"{summary['err_init']:.3e} -> {summary['err_final']:.3e} in "
          f"{summary['iters']} iters ({dt:.2f}s, "
          f"converged={summary['converged']})")
    if args.export_g2o:
        # The engine exporter expects an engine object; emit inline here.
        w = prob.get("edge_weights")
        lines = []
        if prob["group"] == "SE2":
            for i, pp in enumerate(G):
                lines.append(f"VERTEX_SE2 {i} {pp[0]:.9f} {pp[1]:.9f} "
                             f"{pp[2]:.9f}")
            for ei, e in enumerate(prob["edges"]):
                r = e["rel_pose"]
                we = float(w[ei]) if w is not None else 1.0
                lines.append(
                    f"EDGE_SE2 {e['from']} {e['to']} "
                    f"{r[0]:.9f} {r[1]:.9f} {r[2]:.9f} "
                    f"{we:.3f} 0 0 {we:.3f} 0 {we:.3f}")
        else:
            for i, pp in enumerate(G):
                lines.append(
                    f"VERTEX_SE3:QUAT {i} {pp[0]:.9f} {pp[1]:.9f} "
                    f"{pp[2]:.9f} {pp[4]:.9f} {pp[5]:.9f} {pp[6]:.9f} "
                    f"{pp[3]:.9f}")
            iu = np.triu_indices(6)
            for ei, e in enumerate(prob["edges"]):
                r = e["rel_pose"]
                we = float(w[ei]) if w is not None else 1.0
                m = np.eye(6) * we
                info_s = " ".join(f"{v:.3f}" for v in m[iu])
                lines.append(
                    f"EDGE_SE3:QUAT {e['from']} {e['to']} "
                    f"{r[0]:.9f} {r[1]:.9f} {r[2]:.9f} "
                    f"{r[4]:.9f} {r[5]:.9f} {r[6]:.9f} {r[3]:.9f} {info_s}")
        with open(args.export_g2o, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"optimized graph written to {args.export_g2o}",
              file=sys.stderr)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.pgo_g2o:
        return _run_pgo_g2o(args)
    from srba_tpu_torch.engine.engine import Observation
    from srba_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from srba_tpu_torch.io.dataset_io import (load_dataset, load_ground_truth,
                                              save_dataset, save_ground_truth)
    from srba_tpu_torch.utils.datasets import ate_rmse

    world = None
    gt_poses = None
    if args.synthetic:
        world, ds, obs_model = _synthetic(args)
        frames, odometry = ds.frames, list(ds.odometry)
        gt_poses = world.gt_poses
        if args.save_dataset:
            save_dataset(ds, args.save_dataset)
            save_ground_truth(world, args.save_dataset + ".gt")
            print(f"dataset written to {args.save_dataset}", file=sys.stderr)
    elif args.dataset:
        obs_model, frames, odometry = load_dataset(args.dataset)
        if not obs_model:
            obs_model = args.obs
    else:
        print("error: need --dataset or --synthetic", file=sys.stderr)
        return 2
    if args.gt_path:
        gt_poses = load_ground_truth(args.gt_path)

    if args.resume_checkpoint:
        eng = load_checkpoint(args.resume_checkpoint, device=args.device)
        start = eng.num_keyframes
        print(f"resumed at kf {start}", file=sys.stderr)
    else:
        eng = _make_engine(args, obs_model)
        start = 0

    stop = len(frames)
    if args.limit_kfs is not None:
        stop = min(stop, int(args.limit_kfs))

    # Preemption handling (elastic recovery): on SIGTERM/SIGINT save a
    # resumable checkpoint and exit cleanly; the reference has no recovery
    # story at all (SURVEY.md §6 "recovery = re-run the dataset").
    preempted = {"flag": False}
    if args.autosave_checkpoint:
        import signal

        def _on_preempt(signum, frame):
            preempted["flag"] = True

        signal.signal(signal.SIGTERM, _on_preempt)
        signal.signal(signal.SIGINT, _on_preempt)

    metrics = [] if args.metrics_jsonl else None
    t0 = time.perf_counter()
    for k in range(start, stop):
        t_kf = time.perf_counter()
        obs = [Observation(lm_id=m, z=z) for m, z in frames[k]]
        edge_init = None
        if k > 0 and odometry[k - 1] is not None:
            edge_init = {k - 1: odometry[k - 1]}
        info = eng.define_new_keyframe(
            obs, run_local_optimization=not args.no_local_opt,
            edge_init=edge_init)
        if metrics is not None:
            # optimize_results is a LazyInfo: keep the reference, resolve at
            # flush time so the per-KF loop never syncs the device.
            metrics.append((k, len(obs), len(info.created_edge_ids),
                            (time.perf_counter() - t_kf) * 1e3,
                            info.optimize_results))
        if args.step_by_step:
            print(f"kf {k}: edges+={len(info.created_edge_ids)} "
                  f"{info.optimize_results}", file=sys.stderr)
        if args.autosave_checkpoint and (
                preempted["flag"]
                or (k > start and (k - start) % args.autosave_every == 0)):
            save_checkpoint(eng, args.autosave_checkpoint)
            if preempted["flag"]:
                print(f"preempted at kf {k}: checkpoint saved to "
                      f"{args.autosave_checkpoint}", file=sys.stderr)
                return 0
    wall = time.perf_counter() - t0

    if metrics is not None:
        with open(args.metrics_jsonl, "w") as f:
            for k, n_obs, n_edges, ms, r in metrics:
                row = {"kf": k, "num_obs": n_obs, "edges_created": n_edges,
                       "wall_ms": round(ms, 3)}
                row.update({key: float(v) for key, v in r.items()})
                f.write(json.dumps(row) + "\n")

    if args.global_opt:
        _, ginfo = eng.optimize_global()
        print(f"global PGO: err {ginfo['err_init']:.4e} -> "
              f"{ginfo['err_final']:.4e} in {ginfo['iters']:.0f} LM iters",
              file=sys.stderr)

    summary = {
        "num_kfs": eng.num_keyframes,
        "num_landmarks": eng.num_landmarks,
        "num_edges": eng.state.num_edges,
        "num_obs": eng.state.num_obs,
        "wall_s": round(wall, 3),
        "kf_per_sec": round((eng.num_keyframes - start) / max(wall, 1e-9), 2),
        "overall_sq_error": round(eng.eval_overall_squared_error(), 6),
    }
    if gt_poses is not None:
        G, _ = eng.create_complete_spanning_tree(0)
        d = 2 if eng.group.name == "SE2" else 3
        n = min(len(G), len(gt_poses))
        summary["ate_rmse"] = round(ate_rmse(G[:n, :d], gt_poses[:n, :d]), 6)

    if args.render:
        from srba_tpu_torch.io.render import render_engine_png
        gt_xy = None
        if gt_poses is not None:
            d = 2 if eng.group.name == "SE2" else 3
            gt_xy = np.asarray(gt_poses)[:, :d]
        render_engine_png(eng, args.render,
                          span_tree_root=args.render_spantree_root,
                          gt_positions=gt_xy,
                          title=f"{obs_model} — {eng.num_keyframes} KFs")
        print(f"map rendered to {args.render}", file=sys.stderr)

    if args.save_checkpoint:
        save_checkpoint(eng, args.save_checkpoint)
    if args.export_dot:
        from srba_tpu_torch.io.export import save_graph_as_dot
        save_graph_as_dot(eng, args.export_dot)
    if args.export_g2o:
        from srba_tpu_torch.io.export import save_graphslam_g2o
        save_graphslam_g2o(eng, args.export_g2o)
    if args.export_ply or args.export_scene_json or args.export_html:
        from srba_tpu_torch.io.export import (build_opengl_representation,
                                              save_scene_json, save_scene_ply)
        scene = build_opengl_representation(
            eng, span_tree_root=args.render_spantree_root)
        if args.export_ply:
            save_scene_ply(scene, args.export_ply)
        if args.export_scene_json:
            save_scene_json(scene, args.export_scene_json)
        if args.export_html:
            from srba_tpu_torch.io.html_viewer import save_scene_html
            save_scene_html(scene, args.export_html,
                            gt_poses=gt_poses)
            print(f"interactive viewer written to {args.export_html}",
                  file=sys.stderr)
    if args.profile_stats:
        print(eng.profiler.report(), file=sys.stderr)
        if eng.device_master is not None:
            s = eng.device_master.sync_stats
            print(f"mirror syncs: {s['pf_hit']} prefetch-hits "
                  f"({s['pf_hit_s']:.3f}s blocked) / {s['miss']} "
                  f"blocking fetches ({s['miss_s']:.3f}s)", file=sys.stderr)

    if args.json:
        print(json.dumps(summary))
    else:
        for k, v in summary.items():
            print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
