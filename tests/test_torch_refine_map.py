"""Map-parallel refinement of the port (``SrbaEngine.refine_map`` and
:mod:`srba_tpu_torch.solver.multi_window`) against the JAX package: the
twins of tests/test_refine_map.py's three single-device tests, the sweep
planning (roots, windows, ownership, packed ints) identical to the JAX
engine's, one sweep phase from masters carried over from a JAX engine
against JAX's ``make_sweep_step``, whole sweeps against the JAX engine's,
and the batched solve of W windows against each window solved alone.

Tolerances: masters after one phase at atol 1e-4 (one window solve's f32
rounding, the solver tests' delta tolerance) and the phase's summed
``err_final`` at rel 1e-3 (the JAX mesh-vs-single sweep tolerance); the
map error after three sweeps at rel 1e-3; the batched solve against the
single-window solver at rtol 1e-4 in errors and states (atol 1e-5, for
entries near 0), ``iters``, ``lam`` and ``num_obs`` exactly.  Exact
iterations need every accept and stop decision far from a tie: the four
windows' relative improvements per LM step are (0.975, 0.945, 0.027),
(0.992, 0.871, 0.0062), (0.996, 0.731, 1.8e-4) and (0.994, 0.259, 1.1e-5),
then f32 noise, so ``rel_tol`` 0.8 stops windows 0 and 1 on their 3rd step
and windows 2 and 3 on their 2nd.  (Smaller ones stop on a step whose
improvement is ~1e-5, which the two summation orders accept or reject
apart.)
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srba_tpu as J
from srba_tpu.models.noise import NoiseIdentity as JNoise
from srba_tpu.solver import multi_window as jmw
from srba_tpu.utils import datasets as jds
import srba_tpu_torch as T
from srba_tpu_torch.ecps import (ClassicLinearRBA, LocalAreasFixedGrid,
                                 LocalAreasVar1)
from srba_tpu_torch.models.noise import NoiseIdentity as TNoise
from srba_tpu_torch.solver import multi_window as tmw
from srba_tpu_torch.solver.lm import (WindowBatch, make_solver_impl,
                                      scaled_chol_solve)
from srba_tpu_torch.solver.window import build_window
from srba_tpu_torch.utils import datasets as tds

torch.set_num_threads(1)

MASTER_ATOL, ERR_RTOL = 1e-4, 1e-3


def _build(pkg, dsm, noise_cls, num_kfs=30, seed=6, run_local=True, **kw):
    """tests/test_refine_map.py's ``_build_engine``."""
    world = dsm.make_world_loop_2d(num_kfs=num_kfs, radius=8.0,
                                   num_landmarks=70, seed=seed)
    ds = dsm.observe(world, "RangeBearing2D", noise_std=0.004,
                     sensor_range=6.0, odo_noise_std=0.02, seed=seed)
    eng = pkg.SrbaEngine(
        "RangeBearing2D", noise=noise_cls(0.004),
        params=pkg.SrbaParams(max_tree_depth=4, max_optimize_depth=4), **kw)
    for k, frame in enumerate(ds.frames):
        eng.define_new_keyframe(
            [pkg.Observation(lm_id=m, z=z) for m, z in frame],
            edge_init={k - 1: ds.odometry[k - 1]} if k > 0 else None,
            run_local_optimization=run_local)
    return eng, world, ds


def _port(**kw):
    return _build(T, tds, TNoise, device="cpu", **kw)


class _Stop(Exception):
    """Ends a refine_map after its first phase's step was captured."""


def _capture_first_phase(monkeypatch, module, engine, run_real=None):
    """Run ``engine.refine_map(sweeps=1, stride=3)`` up to its first sweep
    step and return that step's inputs (host copies), with the JAX step's
    outputs when ``run_real`` says how to call it.  The engine's own
    masters are never handed to the step (the JAX step donates them)."""
    seen = {}
    real_make = module.make_sweep_step

    def fake_make(cfg):
        def step(pose, prior, lm, ints, obs_z, W_, spinv, calib, E, L, N):
            seen.update(pose=np.array(pose), prior=np.array(prior),
                        lm=np.array(lm), ints=np.array(ints),
                        obs_z=np.array(obs_z), whitener=np.array(W_),
                        spinv=np.array(spinv), E=E, L=L, N=N)
            if run_real is not None:
                seen["out"] = run_real(real_make(cfg), seen, calib)
            raise _Stop
        return step

    monkeypatch.setattr(module, "make_sweep_step", fake_make)
    with pytest.raises(_Stop):
        engine.refine_map(sweeps=1, stride=3)
    monkeypatch.setattr(module, "make_sweep_step", real_make)
    return seen


def _run_jax_step(step, s, calib):
    pose, lm, info = step(
        jnp.asarray(s["pose"]), jnp.asarray(s["prior"]), jnp.asarray(s["lm"]),
        jnp.asarray(s["ints"]), jnp.asarray(s["obs_z"]),
        jnp.asarray(s["whitener"]), jnp.asarray(s["spinv"]), calib,
        s["E"], s["L"], s["N"])
    return jax.device_get((pose, lm, info))


@pytest.fixture(scope="module")
def odo_maps():
    """The 30-KF map built WITHOUT per-KF optimization in both packages,
    its first sweep phase captured in both, then three sweeps in both."""
    mp = pytest.MonkeyPatch()
    try:
        jeng, world, _ = _build(J, jds, JNoise, run_local=False)
        teng, _, _ = _port(run_local=False)
        jcap = _capture_first_phase(mp, jmw, jeng, run_real=_run_jax_step)
        tcap = _capture_first_phase(mp, tmw, teng)
    finally:
        mp.undo()
    err0 = (jeng.eval_overall_squared_error(),
            teng.eval_overall_squared_error())
    prior0 = teng.device_master.prior.clone()
    infos = (jeng.refine_map(sweeps=3, stride=3),
             teng.refine_map(sweeps=3, stride=3))
    err1 = (jeng.eval_overall_squared_error(),
            teng.eval_overall_squared_error())
    return dict(jeng=jeng, teng=teng, jcap=jcap, tcap=tcap, err0=err0,
                err1=err1, infos=infos, prior0=prior0)


def test_sweep_reduces_error_from_odometry(odo_maps):
    # Built WITHOUT per-KF optimization: sweeps must pull the raw-odometry
    # map toward the observations.
    err0, err1 = odo_maps["err0"][1], odo_maps["err1"][1]
    assert odo_maps["infos"][1]["windows"] > 0
    assert err1 < 0.5 * err0, (err0, err1)


def test_sweeps_match_jax(odo_maps):
    (ij, it), (ej, et) = odo_maps["infos"], odo_maps["err1"]
    assert odo_maps["err0"][1] == pytest.approx(odo_maps["err0"][0],
                                                rel=1e-6)
    assert it["windows"] == ij["windows"]
    assert et == pytest.approx(ej, rel=ERR_RTOL)
    assert it["err_final"] == pytest.approx(ij["err_final"], rel=ERR_RTOL)


def test_refine_map_leaves_priors_and_raises_barrier(odo_maps):
    teng = odo_maps["teng"]
    dm = teng.device_master
    assert torch.equal(dm.prior, odo_maps["prior0"])   # scaled on a copy
    assert teng._seed_cache is None
    assert teng._closure_barrier_seq == dm.step_seq


SEGMENTS = ("edge_gids", "edge_own", "lm_gids", "lm_own", "obs_lm",
            "obs_valid", "path_edge", "path_sign")


def _segments(ints, E, L, N, D=4):
    """A packed ``ints [W, T]`` split into its named segments, the path
    ones as ``[W, N, D]``."""
    cols = np.cumsum([E, E, L, L, N, N, N * D])
    segs = dict(zip(SEGMENTS, np.split(ints, cols, axis=1)))
    for k in ("path_edge", "path_sign"):
        segs[k] = segs[k].reshape(len(ints), N, D)
    return segs


def _real_counts(segs):
    """Each window's real (edges, landmarks, rows) from its packed
    segments: rows are the valid ones; landmarks are indexed by them in
    order; edges run to the last slot with an id, an owner or a path
    through it (only edge 0 has id 0, and it leads its window)."""
    out = []
    for w in range(len(segs["obs_valid"])):
        valid = segs["obs_valid"][w] > 0
        used = np.flatnonzero(segs["edge_gids"][w] | segs["edge_own"][w])
        e = max(used.max(initial=-1), segs["path_edge"][w][valid].max()) + 1
        out.append((e, segs["obs_lm"][w][valid].max() + 1, valid.sum()))
    return np.array(out)


def _repad(ints, obs_z, shape, to, D=4):
    """Windows packed at ``shape`` packed again at ``to`` by the bucket
    rule: zeros after every segment, each window's row 0 after its
    observations."""
    segs = _segments(ints, *shape, D)
    W, (E, L, N) = len(ints), to
    parts = []
    for k, n in zip(SEGMENTS, (E, E, L, L, N, N, N, N)):
        a = segs[k]
        out = np.zeros((W, n) + a.shape[2:], a.dtype)
        out[:, : a.shape[1]] = a
        parts.append(out.reshape(W, -1))
    z = np.repeat(obs_z[:, :1], N, axis=1)
    z[:, : obs_z.shape[1]] = obs_z
    return np.concatenate(parts, axis=1), z


def test_sweep_plan_matches_jax(odo_maps):
    """The first phase's windows, ownership masks, packed structure and
    observations are the JAX engine's cut to the port's shape, bit for
    bit, and so are the masters and the scaled prior table it starts
    from.  The sweep packs a phase to its windows' real maxima rounded up
    to 8, not to JAX's bucket: what JAX holds past the cut is padding
    alone."""
    jcap, tcap = odo_maps["jcap"], odo_maps["tcap"]
    shape = (tcap["E"], tcap["L"], tcap["N"])
    jshape = (jcap["E"], jcap["L"], jcap["N"])
    jsegs = _segments(jcap["ints"], *jshape)
    real = _real_counts(jsegs).max(axis=0)
    assert shape == tuple(int(-(-n // 8) * 8) for n in real)
    assert all(s <= j for s, j in zip(shape, jshape)), (shape, jshape)
    tsegs = _segments(tcap["ints"], *shape)
    for k, n in zip(SEGMENTS, (shape[0],) * 2 + (shape[1],) * 2
                    + (shape[2],) * 4):
        np.testing.assert_array_equal(tsegs[k], jsegs[k][:, :n], err_msg=k)
        assert not jsegs[k][:, n:].any(), k
    np.testing.assert_array_equal(tcap["obs_z"],
                                  jcap["obs_z"][:, : shape[2]])
    for k in ("whitener", "spinv"):
        np.testing.assert_array_equal(tcap[k], jcap[k], err_msg=k)
    n_e = odo_maps["teng"].state.num_edges
    n_l = odo_maps["teng"].state.num_lms
    np.testing.assert_array_equal(tcap["pose"][:n_e], jcap["pose"][:n_e])
    np.testing.assert_array_equal(tcap["prior"][:n_e], jcap["prior"][:n_e])
    np.testing.assert_array_equal(tcap["lm"][:n_l], jcap["lm"][:n_l])
    assert tcap["ints"].shape[0] > 1      # several windows in one solve


def test_sweep_step_at_real_sizes_matches_the_bucket(odo_maps):
    """The first phase's windows solved at the port's shape and padded
    again to the bucket the keyframe path would use: the padded slots
    are exact zeros in every product, so the two solves differ only in
    the order of f32 sums."""
    tcap, jcap = odo_maps["tcap"], odo_maps["jcap"]
    shape = (tcap["E"], tcap["L"], tcap["N"])
    bucket = (jcap["E"], jcap["L"], jcap["N"])
    assert shape != bucket
    ints_b, obs_z_b = _repad(tcap["ints"], tcap["obs_z"], shape, bucket)
    np.testing.assert_array_equal(ints_b, jcap["ints"])   # the old pack
    step = tmw.make_sweep_step(odo_maps["teng"]._solver_cfg)
    out = {}
    for key, ints, obs_z, (E, L, N) in (
            ("cut", tcap["ints"], tcap["obs_z"], shape),
            ("bucket", ints_b, obs_z_b, bucket)):
        out[key] = step(
            torch.tensor(tcap["pose"]), torch.tensor(tcap["prior"]),
            torch.tensor(tcap["lm"]), ints, obs_z,
            torch.tensor(tcap["whitener"]), torch.tensor(tcap["spinv"]),
            None, E, L, N)
    (pc, lc, ic), (pb, lb, ib) = out["cut"], out["bucket"]
    np.testing.assert_allclose(pc.numpy(), pb.numpy(), atol=MASTER_ATOL)
    np.testing.assert_allclose(lc.numpy(), lb.numpy(), atol=MASTER_ATOL)
    assert not torch.equal(pc, torch.as_tensor(tcap["pose"]))   # it moved
    assert float(ic["err_final"]) == pytest.approx(float(ib["err_final"]),
                                                   rel=ERR_RTOL)
    assert float(ic["num_obs"]) == float(ib["num_obs"])
    assert len(tcap["ints"]) == len(ints_b)


def test_refine_map_refuses_a_cut_through_real_slots(monkeypatch):
    """Windows whose real counts are understated would lose real slots to
    the phase's cut: the pack raises before any solve, and the masters
    stay as they were."""
    eng, _, _ = _port(run_local=False)
    real = eng._sweep_windows

    def understated(*args):
        return [(a, e_own, l_own, tuple(n // 2 for n in counts))
                for a, e_own, l_own, counts in real(*args)]

    monkeypatch.setattr(eng, "_sweep_windows", understated)
    pose = eng.device_master.pose.clone()
    lm = eng.device_master.lm.clone()
    with pytest.raises(ValueError, match="real slot"):
        eng.refine_map(sweeps=1, stride=3)
    assert torch.equal(eng.device_master.pose, pose)
    assert torch.equal(eng.device_master.lm, lm)


def test_sweep_step_from_jax_masters_matches_jax(odo_maps):
    """The port's sweep step on the JAX engine's first-phase inputs against
    the JAX step's outputs."""
    s = odo_maps["jcap"]
    jpose, jlm, jinfo = s["out"]
    step = tmw.make_sweep_step(odo_maps["teng"]._solver_cfg)
    pose, lm, info = step(
        torch.as_tensor(s["pose"]), torch.as_tensor(s["prior"]),
        torch.as_tensor(s["lm"]), s["ints"], s["obs_z"],
        torch.as_tensor(s["whitener"]), torch.as_tensor(s["spinv"]), None,
        s["E"], s["L"], s["N"])
    np.testing.assert_allclose(pose.numpy(), np.asarray(jpose),
                               atol=MASTER_ATOL)
    np.testing.assert_allclose(lm.numpy(), np.asarray(jlm), atol=MASTER_ATOL)
    assert float(info["err_init"]) == pytest.approx(float(jinfo["err_init"]),
                                                    rel=1e-5)
    assert float(info["err_final"]) == pytest.approx(
        float(jinfo["err_final"]), rel=ERR_RTOL)
    assert float(info["num_obs"]) == float(jinfo["num_obs"])
    # Rows no window owns come back bit-identical.
    moved = np.any(np.asarray(jpose) != s["pose"], axis=1)
    np.testing.assert_array_equal(pose.numpy()[~moved], s["pose"][~moved])


def test_sweep_is_stable_on_optimized_map():
    eng, _, _ = _port(run_local=True)
    err0 = eng.eval_overall_squared_error()
    eng.refine_map(sweeps=2, stride=3)
    err1 = eng.eval_overall_squared_error()
    assert err1 <= err0 * 1.05 + 1e-9


def test_sweep_then_incremental_continues():
    eng, world, _ = _port(run_local=True)
    eng.refine_map(sweeps=1)
    # Engine keeps operating incrementally after a sweep.
    ds = tds.observe(world, "RangeBearing2D", noise_std=0.004,
                     sensor_range=6.0, odo_noise_std=0.02, seed=99)
    frame = ds.frames[-1]
    eng.define_new_keyframe(
        [T.Observation(lm_id=m, z=z) for m, z in frame],
        edge_init={eng.num_keyframes - 1: ds.odometry[-1]})
    assert np.isfinite(eng.eval_overall_squared_error())


def test_mesh_paths_raise_by_name():
    """The mesh sweep is ported: on a one-rank gloo mesh
    ``make_sweep_step_mesh`` and ``refine_map(mesh=...)`` give bitwise the
    one-device sweep (the deltas go through zeroed fields and an
    all-reduce, each master row one delta and exact zeros); a mesh on
    another device than the masters' is refused by name."""
    from tests.test_torch_sharding import one_rank_mesh

    mesh = one_rank_mesh()
    a, b = (_port(num_kfs=12, run_local=False)[0] for _ in range(2))
    assert callable(tmw.make_sweep_step_mesh(a._solver_cfg, mesh))
    ia, ib = a.refine_map(stride=3, mesh=mesh), b.refine_map(stride=3)
    assert ia == ib and ia["windows"] > 0
    assert torch.equal(a.device_master.pose, b.device_master.pose)
    assert torch.equal(a.device_master.lm, b.device_master.lm)

    class CudaMesh:
        device_type = "cuda"

    with pytest.raises((ValueError, RuntimeError), match="cuda|CUDA"):
        a.refine_map(mesh=CudaMesh())


@pytest.mark.parametrize("ecp", ["classic", "grid", "var1"])
@pytest.mark.parametrize("num_kfs", [1, 7, 30, 101])
def test_plan_sweep_roots_matches_jax(ecp, num_kfs):
    policy = {"classic": ClassicLinearRBA(),
              "grid": LocalAreasFixedGrid(submap_size=10),
              "var1": LocalAreasVar1()}[ecp]
    eng = types.SimpleNamespace(ecp=policy, num_keyframes=num_kfs,
                                parameters=T.SrbaParams(max_optimize_depth=3))
    for stride in (None, 1, 2, 3, 5, 10):
        for offset in (0, 1, 2, 5, 13):
            assert tmw.plan_sweep_roots(eng, stride, offset) == \
                jmw.plan_sweep_roots(eng, stride, offset), (stride, offset)


def _padded(a, n):
    out = np.zeros((n,) + a.shape[1:], a.dtype)
    out[: a.shape[0]] = a
    if a.dtype == np.float32 and a.ndim == 2 and a.shape[0] < n:
        out[a.shape[0]:] = a[0]   # valid-valued padding rows
    return out


def _windows():
    """Four windows of the 30-KF odometry map, padded to one bucket."""
    eng, _, _ = _port(run_local=False)
    wins = [build_window(eng.state, eng.graph, r, 4, 4)[0]
            for r in (3, 11, 19, 27)]
    E = max(a.edge_pose.shape[0] for a in wins)
    L = max(a.lm_state.shape[0] for a in wins)
    N = max(a.obs_z.shape[0] for a in wins)

    def batch(a):
        def t(x, n, dt=torch.float32):
            return torch.as_tensor(_padded(np.asarray(x), n), dtype=dt)
        return WindowBatch(
            edge_pose=t(a.edge_pose, E), edge_opt=t(a.edge_opt, E),
            lm_state=t(a.lm_state, L), lm_opt=t(a.lm_opt, L),
            obs_z=t(a.obs_z, N), obs_lm=t(a.obs_lm, N, torch.int32),
            path_edge=t(a.path_edge, N, torch.int32),
            path_sign=t(a.path_sign, N), obs_valid=t(a.obs_valid, N),
            whitener=torch.as_tensor(eng._whitener),
            sensor_pose_inv=torch.as_tensor(eng._sensor_pose_inv),
            edge_prior=t(a.edge_prior, E), edge_prior_w=t(a.edge_prior_w, E))

    cfg = dataclasses.replace(eng._solver_cfg, rel_tol=0.8)
    return cfg, [batch(a) for a in wins]


@pytest.fixture(scope="module")
def windows():
    return _windows()


def _stack(singles):
    shared = ("whitener", "sensor_pose_inv", "calib", "iters_cap")
    return WindowBatch(**{
        f.name: (getattr(singles[0], f.name) if f.name in shared
                 else torch.stack([getattr(s, f.name) for s in singles]))
        for f in dataclasses.fields(WindowBatch)})


@pytest.mark.parametrize("neq", ["onehot", "segmented"])
@pytest.mark.parametrize("solver", ["schur_dense_cholesky",
                                    "no_schur_dense_cholesky"])
def test_batched_solve_matches_single_windows(windows, solver, neq):
    cfg, singles = windows
    cfg = dataclasses.replace(cfg, solver=solver, neq=neq)
    # Window 2 made non-finite (one real observation NaN): its error is
    # NaN, so every step it takes rejects — and only its steps.
    bad = dataclasses.replace(singles[2], obs_z=singles[2].obs_z.clone())
    bad.obs_z[0, 0] = float("nan")
    singles = singles[:2] + [bad] + singles[3:]
    solve1, _ = make_solver_impl(cfg)
    solve_w, eval_w = tmw.make_batched_solver(cfg)
    stacked = _stack(singles)
    edge, lm, info = solve_w(stacked)
    assert edge.shape == stacked.edge_pose.shape
    for w, b in enumerate(singles):
        e1, l1, i1 = solve1(b)
        for k in ("err_init", "err_final"):
            np.testing.assert_allclose(float(info[k][w]), float(i1[k]),
                                       rtol=1e-4)
        for k in ("iters", "lam", "num_obs"):
            assert float(info[k][w]) == float(i1[k]), (w, k)
        np.testing.assert_allclose(edge[w].numpy(), e1.numpy(), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(lm[w].numpy(), l1.numpy(), rtol=1e-4,
                                   atol=1e-5)
    assert not np.isfinite(float(info["err_init"][2]))
    assert torch.equal(edge[2], bad.edge_pose)
    assert torch.equal(lm[2], bad.lm_state)
    assert all(float(info["err_final"][w]) < float(info["err_init"][w])
               for w in (0, 1, 3))
    errs = eval_w(stacked)
    np.testing.assert_allclose(errs.numpy(), info["err_init"].numpy())


def test_batched_solve_inverts_once_per_iteration(windows, monkeypatch):
    """The batched Schur solve hands the SPD inverse ONE stack per LM
    iteration: every window's landmark blocks, [W*L, l, l]."""
    cfg, singles = windows
    shapes = []
    real = tmw.spd_inverse
    monkeypatch.setattr(tmw, "spd_inverse",
                        lambda m: shapes.append(tuple(m.shape)) or real(m))
    stacked = _stack(singles)
    _, _, info = tmw.make_batched_solver(cfg)[0](stacked)
    W, L = stacked.lm_opt.shape
    assert shapes == [(W * L, 2, 2)] * cfg.max_iters


def test_batched_cholesky_fails_only_the_indefinite_window():
    """``scaled_chol_solve`` on a [W, P, P] stack with one indefinite
    matrix: that row alone comes back NaN, the others equal each matrix
    solved alone (rtol 1e-5, f32)."""
    rng = np.random.default_rng(3)
    W, P = 4, 6
    A = rng.standard_normal((W, P, P)).astype(np.float32)
    H = A @ A.transpose(0, 2, 1) + P * np.eye(P, dtype=np.float32)
    H[1, 0, 0] = -1.0                       # finite, not SPD
    rhs = rng.standard_normal((W, P)).astype(np.float32)
    H, rhs = torch.as_tensor(H), torch.as_tensor(rhs)
    x = scaled_chol_solve(H, rhs)
    assert torch.isnan(x[1]).all()
    for w in (0, 2, 3):
        alone = scaled_chol_solve(H[w], rhs[w])
        assert torch.isfinite(alone).all()
        np.testing.assert_allclose(x[w].numpy(), alone.numpy(), rtol=1e-5)
        np.testing.assert_allclose(
            (H[w].double() @ x[w].double()).numpy(), rhs[w].double().numpy(),
            rtol=1e-4, atol=1e-4)
    assert torch.isnan(scaled_chol_solve(H[1], rhs[1])).all()


@pytest.mark.parametrize("solver", ["schur_dense_cholesky",
                                    "no_schur_dense_cholesky"])
def test_batched_solve_rejects_only_the_non_spd_window(windows, solver,
                                                       monkeypatch):
    """Window 1's (finite) system made indefinite at every LM iteration:
    its Cholesky fails (``info != 0``), so it rejects every step and keeps
    its start state, while the other windows' results equal those of the
    unchanged batched solve (atol 1e-6: per-window sums in a batch)."""
    cfg, singles = windows
    cfg = dataclasses.replace(cfg, solver=solver)
    stacked = _stack(singles)
    edge0, lm0, info0 = tmw.make_batched_solver(cfg)[0](stacked)
    real = tmw.scaled_chol_solve

    def indefinite(H, rhs):
        H = H.clone()
        H[1] = -H[1]
        return real(H, rhs)

    monkeypatch.setattr(tmw, "scaled_chol_solve", indefinite)
    edge, lm, info = tmw.make_batched_solver(cfg)[0](stacked)
    assert np.isfinite(float(info["err_init"][1]))
    assert float(info["err_final"][1]) == float(info["err_init"][1])
    assert torch.equal(edge[1], stacked.edge_pose[1])
    assert torch.equal(lm[1], stacked.lm_state[1])
    assert float(info["lam"][1]) > float(info0["lam"][1])
    for w in (0, 2, 3):
        assert float(info["err_final"][w]) < float(info["err_init"][w])
        assert float(info["iters"][w]) == float(info0["iters"][w])
        np.testing.assert_allclose(edge[w].numpy(), edge0[w].numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(lm[w].numpy(), lm0[w].numpy(), atol=1e-6)
        np.testing.assert_allclose(float(info["err_final"][w]),
                                   float(info0["err_final"][w]), rtol=1e-6)
