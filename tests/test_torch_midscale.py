"""The port's twins of tests/test_midscale_regression.py (``slow``: not in
tier-1), plus config #5's run as ``chip_smoke.py`` phases 14-15 make it,
and the CPU readings that phase 14's card-vs-CPU limits are set from
(``test_config5_rounding_spread``, the port alone).

Each test runs the same seeded data through the JAX engine and through the
port's engine, both on the CPU, holds the port to the JAX test's own
asserts (closure count, certified terminal PGO, ATE bound) and prints one
line with both packages' closure counts, edges, landmarks and ATE, so that
the port's result can be read beside the reference's:

    python -m pytest tests/test_torch_midscale.py -m slow -s

The port is not held to the JAX package's ATE or edge list here: on these
runs the windows have near-flat directions (monocular ones a scale gauge
too) along which the two frameworks' float32 roundings move the state, and
a closure fit near a gate threshold then goes either way.
"""

import numpy as np
import pytest
import torch

import srba_tpu as J
import srba_tpu_torch as T

torch.set_num_threads(1)


def _stereo_500(pkg):
    """test_stereo_500kf_closures_and_pgo's data and engine."""
    ns = _namespace(pkg)
    world = ns.ds.make_world_loop_3d(num_kfs=500, radius=8.0,
                                     num_landmarks=400, height_amp=0.5,
                                     seed=1)
    calib = ns.obs.StereoCalib.make(fx=200.0, fy=200.0, cx=160.0, cy=120.0,
                                    baseline=0.12)
    data = ns.ds.observe(world, "StereoCamera", calib=calib, noise_std=0.3,
                         sensor_range=9.0, odo_noise_std=0.01, seed=1)
    eng = pkg.SrbaEngine(
        "StereoCamera", calib=calib, noise=ns.noise.NoiseIdentity(0.3),
        sensor_pose=ns.mount.SensorPoseSE3(ns.lie.CAMERA_SENSOR_POSE_SE3),
        ecp=ns.ecps.LocalAreasFixedGrid(submap_size=10,
                                        min_obs_count_loop_closure=5),
        params=pkg.SrbaParams(max_tree_depth=4, max_optimize_depth=3,
                              extra_obs_per_lm_cap=6,
                              incremental_max_iters=3), **ns.kw)
    return world, data, eng


def _mono_1000(pkg, num_kfs=1000, **params):
    """test_mono_1000kf_closures_and_pgo's data and engine (``params`` add
    to its SrbaParams; bench.py's config #5 is the same at 5000 KFs)."""
    ns = _namespace(pkg)
    world = ns.ds.make_world_loop_3d_large(num_kfs=num_kfs, radius=30.0,
                                           num_landmarks=1200,
                                           revolutions=2.5, seed=7)
    calib = ns.obs.CameraCalib.make()
    data = ns.ds.observe_sparse(world, "MonocularCamera", calib=calib,
                                noise_std=0.3, sensor_range=7.0,
                                odo_noise_std=0.005, seed=7)
    eng = pkg.SrbaEngine(
        "MonocularCamera", calib=calib, noise=ns.noise.NoiseIdentity(0.3),
        sensor_pose=ns.mount.SensorPoseSE3(ns.lie.CAMERA_SENSOR_POSE_SE3),
        ecp=ns.ecps.LocalAreasFixedGrid(submap_size=10,
                                        min_obs_count_loop_closure=6),
        params=pkg.SrbaParams(max_tree_depth=3, max_optimize_depth=2,
                              use_robust_kernel=True, kernel_param=3.0,
                              extra_obs_per_lm_cap=4, **params), **ns.kw)
    return world, data, eng


def _namespace(pkg):
    import types
    if pkg is J:
        from srba_tpu import ecps
        from srba_tpu.models import noise, observations, sensor_pose
        from srba_tpu.ops import np_lie
        from srba_tpu.utils import datasets
        kw = {}
    else:
        from srba_tpu_torch import ecps
        from srba_tpu_torch.models import noise, observations, sensor_pose
        from srba_tpu_torch.ops import np_lie
        from srba_tpu_torch.utils import datasets
        kw = {"device": "cpu"}
    return types.SimpleNamespace(ds=datasets, obs=observations, noise=noise,
                                 mount=sensor_pose, lie=np_lie, ecps=ecps,
                                 kw=kw)


def _run(pkg, make, refine_every=None, **pgo_kw):
    """Drive every keyframe (bench.py's calls: the periodic
    ``optimize_global(periodic=True, use_edge_info=True)`` after every
    ``refine_every``-th), count the closure edges, then the terminal
    ``optimize_global(**pgo_kw)``.  Returns a record of the run."""
    from srba_tpu.utils.datasets import ate_rmse
    world, data, eng = make(pkg)
    K = len(data.frames)
    for k, frame in enumerate(data.frames):
        eng.define_new_keyframe(
            [pkg.Observation(lm_id=m, z=z) for m, z in frame],
            edge_init={k - 1: data.odometry[k - 1]} if k else None)
        if refine_every and k and k % refine_every == 0:
            eng.optimize_global(periodic=True, use_edge_info=True)
    eng.fence()
    st = eng.get_rba_state()
    rec = {"closures": st.num_edges - (K - 1),
           "edges": list(zip(st.k2k_from[:st.num_edges].tolist(),
                             st.k2k_to[:st.num_edges].tolist())),
           "landmarks": eng.num_landmarks,
           "ate_before": float(ate_rmse(
               np.asarray(eng.create_complete_spanning_tree(0)[0])[:, :3],
               world.gt_poses[:, :3]))}
    G, info = eng.optimize_global(**pgo_kw)
    rec["info"] = {k: float(v) for k, v in info.items()}
    rec["ate"] = float(ate_rmse(np.asarray(G)[:, :3], world.gt_poses[:, :3]))
    return rec


def _record(name, rj, rt):
    print(f"\n[{name}] JAX: {rj['closures']} closures, {len(rj['edges'])} "
          f"edges, {rj['landmarks']} landmarks, ATE {rj['ate_before']:.4f} "
          f"-> {rj['ate']:.4f} m, PGO iters {rj['info']['iters']:.0f} "
          f"converged {rj['info']['converged']:.0f} | port: "
          f"{rt['closures']} closures, {len(rt['edges'])} edges, "
          f"{rt['landmarks']} landmarks, ATE {rt['ate_before']:.4f} -> "
          f"{rt['ate']:.4f} m, PGO iters {rt['info']['iters']:.0f} "
          f"converged {rt['info']['converged']:.0f} | same edge list: "
          f"{rj['edges'] == rt['edges']}; edges only in JAX's "
          f"{sorted(set(rj['edges']) - set(rt['edges']))}, only in the "
          f"port's {sorted(set(rt['edges']) - set(rj['edges']))}")


@pytest.mark.slow
def test_stereo_500kf_closures_and_pgo():
    rj, rt = _run(J, _stereo_500), _run(T, _stereo_500)
    _record("stereo_500kf", rj, rt)
    assert rt["closures"] >= 5, f"closure starvation: {rt['closures']}"
    assert rt["info"]["converged"] == 1.0
    assert rt["ate"] <= 0.25, f"stereo ATE {rt['ate']:.3f} > 0.25"


@pytest.mark.slow
def test_mono_1000kf_closures_and_pgo():
    rj, rt = _run(J, _mono_1000), _run(T, _mono_1000)
    _record("mono_1000kf", rj, rt)
    assert rt["closures"] >= 10, f"closure starvation: {rt['closures']}"
    assert rt["info"]["converged"] == 1.0
    assert rt["ate"] <= 0.8, f"mono ATE {rt['ate']:.3f} > 0.8"


@pytest.mark.slow
@pytest.mark.parametrize("num_kfs, bound", [(1000, 0.8), (5000, 1.0)])
def test_config5_bench_calls(num_kfs, bound):
    """Config #5 as chip_smoke.py phases 14-15 run it (1000 keyframes) and
    as bench.py's ``bench_config5`` does (5000): bench.py's parameters
    (``incremental_max_iters=6``), the periodic solves after every
    (num_kfs / 4)-th keyframe and the terminal
    ``optimize_global(use_edge_info=True)``; the 1000-KF cut is held to
    tests/test_midscale_regression.py's 0.8 m, the full run to bench's
    1.0 m."""
    def make(pkg):
        return _mono_1000(pkg, num_kfs, incremental_max_iters=6)

    rj = _run(J, make, refine_every=num_kfs // 4, use_edge_info=True)
    rt = _run(T, make, refine_every=num_kfs // 4, use_edge_info=True)
    _record(f"config5_{num_kfs}kf", rj, rt)
    assert rt["closures"] >= 10, f"closure starvation: {rt['closures']}"
    assert rt["info"]["converged"] == 1.0
    assert rt["ate"] <= bound, f"mono ATE {rt['ate']:.3f} > {bound}"


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nudge(tensors, eps, rng):
    for t in tensors:
        t.mul_(1 + eps * torch.as_tensor(rng.standard_normal(t.shape),
                                         dtype=t.dtype))


def _lockstep_cpu(cs, cfg, nudge=0.0, seed=0, fault=None):
    """``chip_smoke.lockstep_steps`` with the CPU in the card's place:
    before each keyframe the first engine's masters are set to the
    second's, then scaled elementwise by (1 + ``nudge`` N(0, 1)); the first
    engine's steps run inside ``fault()`` if given.  Returns the relative
    differences of the steps' final errors by keyframe."""
    from contextlib import nullcontext

    from srba_tpu_torch.models.noise import NoiseIdentity
    _, ds, model, sigma, _, engine_kw = cfg
    engs = [T.SrbaEngine(model, noise=NoiseIdentity(sigma), device="cpu",
                         **engine_kw) for _ in range(2)]
    rng = np.random.default_rng(seed)
    out = {}
    for k, frame in enumerate(ds.frames[:cs.AGREE_KFS]):
        a, b = engs[0].device_master, engs[1].device_master
        for x, y in ((a.pose, b.pose), (a.prior, b.prior), (a.lm, b.lm)):
            x.copy_(y)
        _nudge((a.pose, a.prior, a.lm), nudge, rng)
        errs = []
        for eng, ctx in ((engs[0], fault or nullcontext), (engs[1],
                                                            nullcontext)):
            with ctx():
                info = eng.define_new_keyframe(
                    [T.Observation(lm_id=m, z=z) for m, z in frame],
                    edge_init={k - 1: ds.odometry[k - 1]} if k else None)
            errs.append(dict(info.optimize_results))
        if k and "skipped" not in errs[1]:
            fa, fb = (float(e["err_final"]) for e in errs)
            out[k] = abs(fa - fb) / fb
    return out


@pytest.mark.slow
def test_config5_rounding_spread(monkeypatch):
    """Where ``chip_smoke.py`` phase 14's card-vs-CPU limits on config #5's
    first 20 keyframes come from: the port on the CPU against itself.

    - Each keyframe's window step from the same masters (phase 14's
      ``lockstep_steps``), with one side's masters nudged by 1e-7 or 1e-6
      (relative; 8 seeds each): the median over the steps of the final
      errors' relative difference stays under
      ``CONFIG5_STEP_MEDIAN_RTOL`` and the largest under
      ``CONFIG5_STEP_MAX_RTOL``.  With a fault in one side's steps (robust
      weights dropped, or taken without their square root, or the Schur
      blocks' inverse 1e-3 off) the median passes the limit.
    - The free-running ATE of those keyframes with the masters nudged after
      every keyframe (40 seeds each at 1e-7 and 1e-6): no two runs lie
      ``CONFIG5_ATE_AGREE`` apart.

    ``-s`` prints every reading."""
    from contextlib import contextmanager

    from srba_tpu_torch.solver import lm

    cs = _chip_smoke()
    cfg = cs.make_config("config5")
    sound = {}
    for eps in (1e-7, 1e-6):
        for seed in range(8):
            sound[(eps, seed)] = _lockstep_cpu(cs, cfg, eps, seed)
    weight, inverse = lm.pseudo_huber_weight, lm.spd_inverse
    faults = {
        "robust weights dropped": ("pseudo_huber_weight",
                                   lambda sq, b: torch.ones_like(sq)),
        "robust weights without their square root": (
            "pseudo_huber_weight", lambda sq, b: weight(sq, b) ** 2),
        "Schur inverse 1e-3 off": ("spd_inverse",
                                   lambda m: inverse(m) * (1 + 1e-3)),
    }
    control = {}
    for name, (attr, bad) in faults.items():
        @contextmanager
        def fault():
            with monkeypatch.context() as mp:
                mp.setattr(lm, attr, bad)
                yield
        control[name] = _lockstep_cpu(cs, cfg, fault=fault)
    for key, by_kf in list(sound.items()) + list(control.items()):
        r = np.asarray(list(by_kf.values()))
        print(f"\n[config5 lockstep] {key}: {len(r)} steps, rel diff "
              f"err_final median {np.median(r):.3e}, max {r.max():.3e} (KF "
              f"{max(by_kf, key=by_kf.get)}), above 1e-2 at KFs "
              f"{[k for k, x in by_kf.items() if x > 1e-2]}")

    _, _, ate0 = cs.run_config(cfg, "cpu", cs.AGREE_KFS)
    ates = []
    for eps in (1e-7, 1e-6):
        for seed in range(40):
            rng = np.random.default_rng(seed)

            def nudge(k, eng):
                dm = eng.device_master
                _nudge((dm.pose, dm.prior, dm.lm), eps, rng)

            ates.append(cs.run_config(cfg, "cpu", cs.AGREE_KFS,
                                      on_kf=nudge)[2])
    print(f"\n[config5 ATE, first {cs.AGREE_KFS} KFs] unperturbed "
          f"{ate0:.6f} m; 80 nudged runs {min(ates):.6f} .. {max(ates):.6f} "
          f"m (widest gap {max(ates) - min(ates):.3e}, largest from the "
          f"unperturbed {max(abs(a - ate0) for a in ates):.3e})")

    for key, by_kf in sound.items():
        r = np.asarray(list(by_kf.values()))
        assert np.median(r) < cs.CONFIG5_STEP_MEDIAN_RTOL, key
        assert r.max() < cs.CONFIG5_STEP_MAX_RTOL, key
    for name, by_kf in control.items():
        r = np.asarray(list(by_kf.values()))
        assert np.median(r) > cs.CONFIG5_STEP_MEDIAN_RTOL, name
    assert max(ates) - min(ates) < cs.CONFIG5_ATE_AGREE


@pytest.mark.slow
def test_refine_map_rounding_spread(monkeypatch):
    """Where ``chip_smoke.py`` phase 23's limit on the two-rank sweep comes
    from: phase 18's ``refine_map(sweeps=3)`` on config #1's raw-odometry
    map, on the CPU, unperturbed and with the masters nudged by 1e-7 or
    1e-6 (relative; 15 seeds each) before the sweeps.  A window's LM
    accepts and rejects steps at f32 noise, so the sweeps end up to ~2%
    apart in error; none of the nudged runs lies ``RING_REFINE_RTOL`` from
    the unperturbed one.  With a fault (the deltas of the second half of
    every phase's windows dropped, as a rank whose all-reduce share went
    missing would leave them) the error lies beyond it.  ``-s`` prints
    every reading."""
    from srba_tpu_torch.solver import multi_window as mw

    cs = _chip_smoke()
    cfg = cs.make_config("config1")

    def sweep(eps=0.0, seed=0):
        eng, _, _ = cs.run_config(cfg, "cpu", run_local=False)
        dm = eng.device_master
        _nudge((dm.pose, dm.lm), eps, np.random.default_rng(seed))
        eng.refine_map(sweeps=cs.REFINE_SWEEPS)
        return eng.eval_overall_squared_error()

    e0 = sweep()
    errs = [sweep(eps, seed) for eps in (1e-7, 1e-6) for seed in range(15)]
    make = mw.make_sweep_step

    def half_dropped(c):
        step = make(c)

        def dropping(pose, prior, lm, ints, obs_z, wh, spi, calib, E, L, N):
            ints = ints.copy()
            half = ints.shape[0] // 2
            ints[half:, E: 2 * E] = 0                       # edge_opt
            ints[half:, 2 * E + L: 2 * E + 2 * L] = 0       # lm_opt
            return step(pose, prior, lm, ints, obs_z, wh, spi, calib, E, L,
                        N)
        return dropping

    monkeypatch.setattr(mw, "make_sweep_step", half_dropped)
    e_fault = sweep()
    rel = [abs(e - e0) / e0 for e in errs]
    print(f"\n[refine_map spread] unperturbed {e0:.2f}; 30 nudged runs "
          f"{min(errs):.2f} .. {max(errs):.2f} (widest gap "
          f"{(max(errs) - min(errs)) / e0:.3e}, largest from the "
          f"unperturbed {max(rel):.3e}); half the windows dropped "
          f"{e_fault:.2f} ({abs(e_fault - e0) / e0:.3e})")
    assert max(rel) < cs.RING_REFINE_RTOL
    assert abs(e_fault - e0) / e0 > cs.RING_REFINE_RTOL
