"""Loop-closure bootstrap of the port (``srba_tpu_torch.engine.closure`` and
the engine's closure branch) against the JAX package, on the CPU.

Primitives (``_kabsch``, ``_se3_from_rt``, the observation-space residual,
``_gn_solve``, ``_fit_sigma``) run the same numpy code in both packages on
the same inputs and must agree bit for bit.  ``bootstrap_closure_edge`` runs
on two engines whose host mirrors hold the same values: the same status,
T at atol 1e-4, sigma at rtol 1e-3.

Then the port's counterparts of ``tests/test_closure.py``'s
``TestEngineClosureBootstrap`` (RangeBearing2D, 80 keyframes, two
revolutions, ``LocalAreasFixedGrid(8, 4)``) run through both engines: the
same edge lists and closure counts, edge poses and landmark states within
atol 1e-3 and ATE within 1e-3 m, plus the reference test's own bounds.  The
fits read float32 state, so a fit whose gate value sits at a threshold
could land on either side in the two packages (a gate tie); these runs'
gates are decisive.

Last, the monocular fit (``_mono_pnp``, multi-start PnP) on
``TestPrimitives``' scenarios and the monocular branch of
``bootstrap_closure_edge`` through both gates (pixel RMS and sigma), at
atol 1e-9, and the inverse-model branch through the shared gate for stereo
and RGB-D.
"""

import functools

import numpy as np
import pytest
import torch

import srba_tpu as J
import srba_tpu_torch as T
from srba_tpu import ecps as jecps
from srba_tpu.engine import closure as jcl
from srba_tpu.utils import datasets as jds
from srba_tpu_torch import ecps as tecps
from srba_tpu_torch.engine import closure as tcl
from srba_tpu_torch.utils import datasets as tds

torch.set_num_threads(1)

T_ATOL, SIGMA_RTOL = 1e-4, 1e-3
STATE_ATOL, ATE_ATOL = 1e-3, 1e-3


# -- primitives ---------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 3])
def test_kabsch_matches_jax(d):
    rng = np.random.default_rng(10 + d)
    P = rng.uniform(-3, 3, (12, d))
    Q = P @ np.linalg.qr(rng.normal(size=(d, d)))[0].T + rng.normal(
        0, 0.01, (12, d)) + 1.5
    Rt, tt = tcl._kabsch(P, Q)
    Rj, tj = jcl._kabsch(P, Q)
    np.testing.assert_array_equal(Rt, Rj)
    np.testing.assert_array_equal(tt, tj)
    assert abs(np.linalg.det(Rt) - 1.0) < 1e-9


@pytest.mark.parametrize("w", [[0.1, 0.1, 0.1], [3.0, 0.1, 0.0],
                               [0.0, 3.0, 0.1], [0.1, 0.0, 3.0],
                               [np.pi, 0, 0], [0, np.pi, 0]], ids=str)
def test_se3_from_rt_matches_jax(w):
    """The rotations of tests/test_closure.py, every branch of
    ``quat_from_matrix``."""
    from srba_tpu.ops.np_lie import NpSE3, quat_rotate
    Tw = NpSE3.pexp(np.asarray([0.0, 0, 0] + list(w), np.float64))
    R = np.stack([quat_rotate(Tw[3:], e) for e in np.eye(3)], axis=-1)
    t = np.asarray([0.5, -1.0, 2.0])
    np.testing.assert_array_equal(tcl._se3_from_rt(R, t),
                                  jcl._se3_from_rt(R, t))
    np.testing.assert_array_equal(tcl._se2_from_rt(R[:2, :2], t[:2]),
                                  jcl._se2_from_rt(R[:2, :2], t[:2]))


def _stereo_engines():
    from srba_tpu.models.observations import StereoCalib as JCalib
    from srba_tpu.models.sensor_pose import SensorPoseSE3 as JMount
    from srba_tpu.ops.np_lie import CAMERA_SENSOR_POSE_SE3
    from srba_tpu_torch.models.observations import StereoCalib as TCalib
    from srba_tpu_torch.models.sensor_pose import SensorPoseSE3 as TMount
    kw = dict(fx=200.0, fy=200.0, cx=160.0, cy=120.0, baseline=0.12)
    je = J.SrbaEngine("StereoCamera", calib=JCalib.make(**kw),
                      sensor_pose=JMount(CAMERA_SENSOR_POSE_SE3))
    te = T.SrbaEngine("StereoCamera", calib=TCalib.make(**kw),
                      sensor_pose=TMount(CAMERA_SENSOR_POSE_SE3),
                      device="cpu")
    return je, te


def _stereo_voters(te, n=14, seed=20, pix_noise=0.3):
    """Center-frame points P and their stereo pixels Z seen from a true
    closure transform (mounted camera), with pixel noise."""
    g = te.np_group
    rng = np.random.default_rng(seed)
    T_true = g.pexp(np.asarray([1.0, -0.5, 0.1, 0.03, -0.02, 0.3]))
    s = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(2.0, 7.0, n)], -1)               # camera frame
    q = g.apply(te._sensor_pose.astype(np.float64), s)          # new-KF frame
    P = g.apply(g.inverse(T_true), q)                           # center frame
    Z = np.asarray(te.model.h(s, te._calib_np), np.float64) + rng.normal(
        0, pix_noise, (n, 4))
    return T_true, P, Z


@pytest.mark.parametrize("noise", [0.0, 0.3, 3.0])
def test_stereo_gn_fit_matches_jax(noise):
    """The observation-space residual through the mount and the stereo
    model, the damped Gauss-Newton polish and the fit's sigma."""
    je, te = _stereo_engines()
    T_true, P, Z = _stereo_voters(te, pix_noise=noise)
    g = te.np_group
    T0 = g.retract(T_true, np.asarray([0.2, -0.1, 0.1, 0.05, 0.05, -0.1]))
    rt, rj = tcl._obs_residual_fn(te, P, Z), jcl._obs_residual_fn(je, P, Z)
    np.testing.assert_array_equal(rt(T0), rj(T0))
    Tt, rms_t, JtJ_t = tcl._gn_solve(g, rt, T0, 6)
    Tj, rms_j, JtJ_j = jcl._gn_solve(je.np_group, rj, T0, 6)
    np.testing.assert_array_equal(Tt, Tj)
    assert rms_t == rms_j
    np.testing.assert_array_equal(JtJ_t, JtJ_j)
    assert tcl._fit_sigma(rms_t, JtJ_t) == jcl._fit_sigma(rms_j, JtJ_j)
    if noise == 0.0:
        np.testing.assert_allclose(Tt, T_true, atol=1e-6)


# -- engine runs --------------------------------------------------------------

RUNS = {"boot_0.03": ("grid", True, 0.03), "plain_0.03": ("grid", False, 0.03),
        "boot_0.02": ("grid", True, 0.02), "chain_0.02": ("chain", True, 0.02)}


def _drive(pkg, dsm, ecpm, ecp, bootstrap, odo_noise, K=80, seed=6, **kw):
    """``TestEngineClosureBootstrap._drifted_run`` through one package."""
    world = dsm.make_world_loop_2d(num_kfs=K, radius=6.0, num_landmarks=120,
                                   seed=seed, revolutions=2.0)
    ds = dsm.observe(world, "RangeBearing2D", noise_std=0.003,
                     sensor_range=4.5, odo_noise_std=odo_noise, seed=seed)
    policy = (ecpm.LocalAreasFixedGrid(submap_size=8,
                                       min_obs_count_loop_closure=4)
              if ecp == "grid" else ecpm.ClassicLinearRBA())
    eng = pkg.SrbaEngine(
        "RangeBearing2D", ecp=policy,
        params=pkg.SrbaParams(max_tree_depth=4, max_optimize_depth=3,
                              closure_bootstrap=bootstrap), **kw)
    for k, frame in enumerate(ds.frames):
        eng.define_new_keyframe(
            [pkg.Observation(lm_id=m, z=z) for m, z in frame],
            edge_init={k - 1: ds.odometry[k - 1]} if k else None)
    G, _ = eng.create_complete_spanning_tree(0)
    n = min(len(G), len(world.gt_poses))
    return eng, ds, float(dsm.ate_rmse(G[:n, :2], world.gt_poses[:n, :2]))


@functools.lru_cache(maxsize=None)
def _runs(key):
    ecp, boot, odo = RUNS[key]
    je, ds, ate_j = _drive(J, jds, jecps, ecp, boot, odo)
    te, _, ate_t = _drive(T, tds, tecps, ecp, boot, odo, device="cpu")
    return je, te, ds, ate_j, ate_t


def _edges(st):
    n = st.num_edges
    return list(zip(st.k2k_from[:n].tolist(), st.k2k_to[:n].tolist()))


@pytest.mark.parametrize("key", list(RUNS))
def test_closure_runs_match_jax(key):
    je, te, _, ate_j, ate_t = _runs(key)
    sj, st = je.get_rba_state(), te.get_rba_state()
    assert _edges(st) == _edges(sj)
    closures = st.num_edges - (st.num_kfs - 1)
    assert closures == sj.num_edges - (sj.num_kfs - 1)
    assert (closures > 0) == (RUNS[key][0] == "grid")
    assert (st.num_lms, st.num_obs) == (sj.num_lms, sj.num_obs)
    np.testing.assert_allclose(st.k2k_pose[:st.num_edges],
                               sj.k2k_pose[:sj.num_edges], atol=STATE_ATOL)
    np.testing.assert_allclose(st.lm_state[:st.num_lms],
                               sj.lm_state[:sj.num_lms], atol=STATE_ATOL)
    assert abs(ate_t - ate_j) < ATE_ATOL
    # No weak fit is left pending, and the same centers cool down.
    assert te._closure_pending.keys() == je._closure_pending.keys()
    assert te._closure_cooldown == je._closure_cooldown


def test_bootstrap_improves_drifted_closures():
    """tests/test_closure.py's bounds, on the port's runs."""
    ate_boot = _runs("boot_0.03")[4]
    ate_plain = _runs("plain_0.03")[4]
    assert ate_boot < 0.4, (ate_boot, ate_plain)
    assert ate_boot <= ate_plain * 1.1 + 0.02


def test_closure_gating_accuracy_dense_revisit():
    _, te, _, _, ate_gated = _runs("boot_0.02")
    ate_chain = _runs("chain_0.02")[4]
    st = te.get_rba_state()
    assert st.num_edges - (st.num_kfs - 1) >= 1
    assert ate_gated <= ate_chain * 1.05 + 0.02, (ate_gated, ate_chain)
    assert ate_gated < 0.35


@pytest.mark.parametrize("max_sigma", [None, 0.5, 0.3, 1e-4])
def test_bootstrap_closure_edge_matches_jax_on_the_same_mirror(max_sigma):
    """Both engines' host mirrors hold the JAX engine's state; every area
    center the last keyframe re-observes is fitted in both, with the sigma
    gate moved so that ``ok``, ``weak`` and ``reject`` all occur."""
    import dataclasses
    je, te, ds, _, _ = _runs("boot_0.03")
    je.sync()
    te.sync()
    je.parameters = dataclasses.replace(je.parameters,
                                        closure_max_sigma=max_sigma)
    te.parameters = dataclasses.replace(te.parameters,
                                        closure_max_sigma=max_sigma)
    ne, nl = te.state.num_edges, te.state.num_lms
    mirror = (te.state.k2k_pose[:ne].copy(), te.state.lm_state[:nl].copy())
    te.state.k2k_pose[:ne] = je.state.k2k_pose[:ne]
    te.state.lm_state[:nl] = je.state.lm_state[:nl]
    try:
        statuses = []
        for frame in ds.frames[-4:]:
            tobs = [T.Observation(lm_id=m, z=z) for m, z in frame]
            jobs = [J.Observation(lm_id=m, z=z) for m, z in frame]
            for center in range(0, te.num_keyframes, 8):
                vt = te._closure_voters(tobs, center)
                vj = je._closure_voters(jobs, center)
                assert [lm for lm, _ in vt] == [lm for lm, _ in vj]
                st, Tt, rt, sgt, it = tcl.bootstrap_closure_edge(
                    te, center, vt, None)
                sj, Tj, rj, sgj, ij = jcl.bootstrap_closure_edge(
                    je, center, vj, None)
                assert st == sj, (center, st, sj)
                statuses.append(st)
                if st in ("ok", "weak"):
                    np.testing.assert_allclose(Tt, Tj, atol=T_ATOL)
                    np.testing.assert_allclose(it, ij, rtol=SIGMA_RTOL)
                if st != "n/a":
                    assert sgt == pytest.approx(sgj, rel=SIGMA_RTOL)
                    assert rt == pytest.approx(rj, rel=SIGMA_RTOL)
        expect = {None: {"ok"}, 0.5: {"ok", "weak", "reject"},
                  0.3: {"weak", "reject"}, 1e-4: {"reject"}}[max_sigma]
        assert expect <= set(statuses), statuses
    finally:
        te.state.k2k_pose[:ne], te.state.lm_state[:nl] = mirror
        je.parameters = dataclasses.replace(je.parameters,
                                            closure_max_sigma=0.3)
        te.parameters = dataclasses.replace(te.parameters,
                                            closure_max_sigma=0.3)


# -- the monocular fit (multi-start PnP) and the accept gate -----------------
# Host numpy in both packages on the same inputs: T, rms, JtJ, sigma and
# the gate ratio at atol 1e-9 (they come out equal to the last bit, but a
# BLAS may order a sum differently), the status exactly.

PNP_ATOL = 1e-9


def _camera_engines(model):
    from srba_tpu.models.observations import CameraCalib as JCalib
    from srba_tpu.models.sensor_pose import SensorPoseSE3 as JMount
    from srba_tpu.ops.np_lie import CAMERA_SENSOR_POSE_SE3
    from srba_tpu_torch.models.observations import CameraCalib as TCalib
    from srba_tpu_torch.models.sensor_pose import SensorPoseSE3 as TMount
    je = J.SrbaEngine(model, calib=JCalib.make(),
                      sensor_pose=JMount(CAMERA_SENSOR_POSE_SE3))
    te = T.SrbaEngine(model, calib=TCalib.make(),
                      sensor_pose=TMount(CAMERA_SENSOR_POSE_SE3),
                      device="cpu")
    return je, te


def _pnp_case(case, te):
    """``tests/test_closure.py``'s PnP scenarios: (P, Z, seed, the voters in
    the new keyframe's frame or None)."""
    g = te.np_group
    if case == "garbage":
        rng = np.random.default_rng(2)
        P = np.stack([rng.uniform(-4, 4, 10), rng.uniform(-4, 4, 10),
                      rng.uniform(-0.5, 2.0, 10)], -1)
        return P, rng.uniform(0, 300, (10, 2)), g.identity(), None
    rng = np.random.default_rng(1)
    T_true = g.pexp(np.asarray([2.0, -1.0, 0.2, 0.05, -0.02, 0.4]))
    # Points in the true camera's frustum, mapped into the center frame.
    s = np.stack([rng.uniform(-2, 2, 16), rng.uniform(-1.5, 1.5, 16),
                  rng.uniform(2.0, 7.0, 16)], -1)
    q = g.apply(te._sensor_pose.astype(np.float64), s)
    P = g.apply(g.inverse(T_true), q)
    Z = np.stack([160 + 200 * s[:, 0] / s[:, 2],
                  120 + 200 * s[:, 1] / s[:, 2]], -1)
    if case == "noisy":
        Z = Z + rng.normal(0, 0.5, Z.shape)
    seed = g.retract(T_true, np.asarray([3.0, -2.0, 0.5, 0.1, -0.1, 0.7]))
    return P, Z, seed, q


@pytest.mark.parametrize("case", ["large_yaw_drift", "noisy", "garbage"])
def test_mono_pnp_matches_jax(case):
    """``TestPrimitives``' PnP cases: the fit from a seed 40 degrees and
    meters off recovers the pose (the voters within 0.05 of where the true
    pose puts them); uncorrelated pixels stay above the pixel gate."""
    je, te = _camera_engines("MonocularCamera")
    P, Z, seed, q = _pnp_case(case, te)
    Tt, rms_t, JtJ_t = tcl._mono_pnp(te, P, Z, seed)
    Tj, rms_j, JtJ_j = jcl._mono_pnp(je, P, Z, seed)
    np.testing.assert_allclose(Tt, Tj, rtol=0, atol=PNP_ATOL)
    assert rms_t == pytest.approx(rms_j, rel=0, abs=PNP_ATOL)
    np.testing.assert_allclose(JtJ_t, JtJ_j, rtol=1e-12, atol=PNP_ATOL)
    if case == "garbage":
        assert rms_t > te.parameters.closure_gate_px
    else:
        assert rms_t < (1.0 if case == "large_yaw_drift" else 2.0), rms_t
        np.testing.assert_allclose(te.np_group.apply(Tt, P), q, atol=0.05)


def _seed_center_landmarks(eng, P):
    """Keyframe 0 with the landmarks P based there (host mirror and
    staging), as a closure's voters see them."""
    eng.state.add_keyframe()
    eng.graph.add_keyframe()
    if getattr(eng, "native", None) is not None:
        eng.native.add_keyframe()
    return [eng._add_landmark(0, np.asarray(p, np.float32)) for p in P]


@pytest.mark.parametrize("case, n, gate_px, max_sigma", [
    ("large_yaw_drift", 16, 25.0, 0.3),
    ("noisy", 16, 25.0, 0.3),
    ("noisy", 16, 25.0, 1e-4),       # sigma gate: reject
    ("noisy", 16, 1e-3, 0.3),        # pixel gate: reject
    ("large_yaw_drift", 16, 25.0, None),
    ("garbage", 10, 25.0, 0.3),
    ("large_yaw_drift", 3, 25.0, 0.3),   # fewer than 4 voters: n/a
])
def test_mono_bootstrap_matches_jax(case, n, gate_px, max_sigma):
    """``bootstrap_closure_edge``'s monocular branch: the same status, T,
    gate ratio, sigma and information in both packages, through both gates
    (pixel RMS over ``closure_gate_px``, sigma over ``closure_max_sigma``)."""
    import dataclasses
    je, te = _camera_engines("MonocularCamera")
    P, Z, seed, _ = _pnp_case(case, te)
    P, Z = P[:n], Z[:n]
    out = []
    for eng, mod in ((je, jcl), (te, tcl)):
        eng.parameters = dataclasses.replace(
            eng.parameters, closure_gate_px=gate_px,
            closure_max_sigma=max_sigma)
        lms = _seed_center_landmarks(eng, P)
        voters = [(lm, np.asarray(z, np.float32)) for lm, z in zip(lms, Z)]
        out.append(mod.bootstrap_closure_edge(eng, 0, voters, seed))
    (sj, Tj, rj, sgj, ij), (st, Tt, rt, sgt, it) = out
    assert st == sj
    expect = {("large_yaw_drift", 16, 25.0, 0.3): "ok",
              ("large_yaw_drift", 16, 25.0, None): "ok",
              ("noisy", 16, 1e-3, 0.3): "reject",
              ("noisy", 16, 25.0, 1e-4): "reject",
              ("garbage", 10, 25.0, 0.3): "reject",
              ("large_yaw_drift", 3, 25.0, 0.3): "n/a"}
    if (case, n, gate_px, max_sigma) in expect:
        assert st == expect[(case, n, gate_px, max_sigma)]
    if st == "n/a":
        assert Tt is None and Tj is None
        return
    assert rt == pytest.approx(rj, rel=0, abs=PNP_ATOL)
    assert sgt == pytest.approx(sgj, rel=1e-12, abs=PNP_ATOL)
    if st == "reject":
        assert Tt is None and Tj is None and it is None
    else:
        np.testing.assert_allclose(Tt, Tj, rtol=0, atol=1e-6)
        assert Tt.dtype == np.float32
        np.testing.assert_allclose(it, ij, rtol=1e-6)


@pytest.mark.parametrize("model", ["StereoCamera", "RGBDCamera"])
def test_inverse_model_bootstrap_unchanged_by_the_gate(model):
    """The Kabsch branch through the shared accept gate: at ``rms_ratio`` 0
    it keeps the sigma-only policy, with the same results as the JAX
    package for every status."""
    import dataclasses
    if model == "StereoCamera":
        je, te = _stereo_engines()
        _, P, Z = _stereo_voters(te, pix_noise=0.3)
    else:
        # _stereo_voters' geometry; (u, v, depth) with pixel and depth noise.
        je, te = _camera_engines(model)
        g = te.np_group
        rng = np.random.default_rng(21)
        T_true = g.pexp(np.asarray([1.0, -0.5, 0.1, 0.03, -0.02, 0.3]))
        s = np.stack([rng.uniform(-2, 2, 14), rng.uniform(-1.5, 1.5, 14),
                      rng.uniform(2.0, 7.0, 14)], -1)
        P = g.apply(g.inverse(T_true),
                    g.apply(te._sensor_pose.astype(np.float64), s))
        Z = np.asarray(te.model.h(s, te._calib_np), np.float64) + \
            rng.normal(0, [0.3, 0.3, 0.02], (14, 3))
    statuses = []
    for max_sigma in (None, 0.3, 0.05, 1e-4):
        out = []
        for eng, mod in ((je, jcl), (te, tcl)):
            eng.parameters = dataclasses.replace(
                eng.parameters, closure_max_sigma=max_sigma)
            if eng.state.num_kfs == 0:
                lms = _seed_center_landmarks(eng, P)
            voters = [(lm, np.asarray(z, np.float32))
                      for lm, z in zip(lms, Z)]
            out.append(mod.bootstrap_closure_edge(eng, 0, voters, None))
        (sj, Tj, rj, sgj, ij), (st, Tt, rt, sgt, it) = out
        assert st == sj
        statuses.append(st)
        assert rt == pytest.approx(rj, rel=1e-6)
        assert sgt == pytest.approx(sgj, rel=1e-6)
        if max_sigma is None:
            assert rt == 0.0
        if st != "reject":
            np.testing.assert_allclose(Tt, Tj, atol=T_ATOL)
            np.testing.assert_allclose(it, ij, rtol=SIGMA_RTOL)
    assert statuses[0] == "ok" and statuses[-1] == "reject"
