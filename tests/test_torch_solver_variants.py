"""The solver variants of the port — the no-Schur solver
(``solver="no_schur_dense_cholesky"``), the segmented normal equations
(``neq="segmented"``), ``get_solver`` and ``optimize_edges`` in both engine
modes — against the JAX package and against the port's default solver:
the twins of tests/test_solver_variants.py, run through the port's engine
on the CPU, plus direct comparisons with the JAX package's variants.

Tolerances: the twins keep the JAX tests' own (no-Schur vs Schur engines:
error rel 5e-3, edges rtol 5e-2 / atol 5e-3; segmented vs one-hot: error
rel 1e-3, states rtol 1e-3 / atol 1e-4; ``optimize_edges``: unlisted
unknowns bitwise equal).  Port variant against JAX variant on
``__graft_entry__._stereo_window()`` (a noise-free two-keyframe stereo
window, solved to ~1e-9): ``err_final`` < 1e-3 in both and states at atol
1e-4 (the solver tests' delta tolerance).  The segmented reduction sums in
a fixed order: its reruns are bitwise equal.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from srba_tpu.solver.lm import make_solver_impl as jax_solver_impl
from srba_tpu_torch import Observation, SrbaEngine, SrbaParams, convert
from srba_tpu_torch.solver import lm as tlm
from srba_tpu_torch.utils.datasets import make_world_loop_2d, observe

torch.set_num_threads(1)

STATE_ATOL = 1e-4
SCHUR, NO_SCHUR = "schur_dense_cholesky", "no_schur_dense_cholesky"


def _run(solver=SCHUR, neq="onehot", device_master=True, seed=5,
         num_kfs=15):
    """tests/test_solver_variants.py's 15-KF range-bearing run."""
    world = make_world_loop_2d(num_kfs=num_kfs, radius=7.0,
                               num_landmarks=40, seed=seed)
    ds = observe(world, "RangeBearing2D", noise_std=0.004, sensor_range=6.0,
                 odo_noise_std=0.015, seed=seed)
    eng = SrbaEngine(
        "RangeBearing2D",
        params=SrbaParams(max_tree_depth=3, max_optimize_depth=3,
                          solver=solver),
        device_master=device_master, device="cpu")
    eng._solver_cfg = dataclasses.replace(eng._solver_cfg, neq=neq)
    for k, frame in enumerate(ds.frames):
        eng.define_new_keyframe(
            [Observation(lm_id=m, z=z) for m, z in frame],
            edge_init={k - 1: ds.odometry[k - 1]} if k > 0 else None)
    return eng


@pytest.fixture(scope="module")
def runs():
    """One engine per (solver, neq) variant, shared by the twins."""
    return {v: _run(*v) for v in [(SCHUR, "onehot"), (NO_SCHUR, "onehot"),
                                  (SCHUR, "segmented")]}


def test_no_schur_matches_schur(runs):
    e1, e2 = runs[(SCHUR, "onehot")], runs[(NO_SCHUR, "onehot")]
    err1 = e1.eval_overall_squared_error()
    err2 = e2.eval_overall_squared_error()
    # Same normal equations, different elimination order: same optimum.
    assert err2 == pytest.approx(err1, rel=5e-3, abs=1e-6)
    st1, st2 = e1.get_rba_state(), e2.get_rba_state()
    np.testing.assert_allclose(st2.k2k_pose[: st2.num_edges],
                               st1.k2k_pose[: st1.num_edges],
                               rtol=5e-2, atol=5e-3)


def test_segmented_neq_matches_onehot():
    """The segmented reduction gives the one-hot path's normal equations in
    another summation order: the solves agree to f32 reduction
    tolerance (the stereo window with its sensor pose)."""
    cfg, batch = ge._stereo_window()
    tb = convert.window_batch_from_jax(batch, device="cpu")
    out = {}
    for neq in ("onehot", "segmented"):
        solve, _ = tlm.make_solver_impl(convert.solver_config_from_jax(
            dataclasses.replace(cfg, neq=neq)))
        out[neq] = solve(tb)
    (e0, l0, i0), (e, l, i) = out["onehot"], out["segmented"]
    assert float(i["err_final"]) == pytest.approx(
        float(i0["err_final"]), rel=1e-3, abs=1e-8)
    np.testing.assert_allclose(e.numpy(), e0.numpy(), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(l.numpy(), l0.numpy(), rtol=1e-3, atol=1e-4)


def test_segmented_neq_engine_equivalence(runs):
    """End to end: the range-bearing run with edge priors under each
    reduction backend lands on the same map."""
    err0 = runs[(SCHUR, "onehot")].eval_overall_squared_error()
    err1 = runs[(SCHUR, "segmented")].eval_overall_squared_error()
    assert err1 == pytest.approx(err0, rel=1e-3, abs=1e-6)


@pytest.mark.parametrize("device_master", [True, False])
def test_optimize_edges_restricts_unknowns(device_master):
    eng = _run(device_master=device_master)
    st = eng.get_rba_state()
    n_e = st.num_edges
    before = st.k2k_pose[:n_e].copy()
    target = {n_e - 1, n_e - 2}
    info = eng.optimize_edges(sorted(target))
    assert "err_final" in info
    assert info["err_final"] <= info["err_init"]
    after = eng.get_rba_state().k2k_pose[:n_e]
    for e in range(n_e):
        if e not in target:
            np.testing.assert_array_equal(after[e], before[e], err_msg=str(e))


@pytest.mark.parametrize("device_master", [True, False])
def test_optimize_edges_with_landmark_list(device_master):
    eng = _run(device_master=device_master)
    st = eng.get_rba_state()
    lm_before = st.lm_state[: st.num_lms].copy()
    keep_lms = {0, 1}
    eng.optimize_edges([st.num_edges - 1], sorted(keep_lms))
    st = eng.get_rba_state()
    for l in range(st.num_lms):
        if l not in keep_lms:
            np.testing.assert_array_equal(st.lm_state[l], lm_before[l])
    assert eng.optimize_edges([]) == {"skipped": 1.0}


@pytest.mark.parametrize("solver,neq", [(NO_SCHUR, "onehot"),
                                        (SCHUR, "segmented")])
def test_variant_matches_jax_variant(solver, neq):
    """The port's variant against the JAX package's same variant on the
    stereo window."""
    cfg, batch = ge._stereo_window()
    cfg = dataclasses.replace(cfg, solver=solver, neq=neq)
    js, _ = jax_solver_impl(cfg)
    je, jl, ji = jax.jit(js)(batch)
    ts, _ = tlm.make_solver_impl(convert.solver_config_from_jax(cfg))
    te, tl, ti = ts(convert.window_batch_from_jax(batch, device="cpu"))
    assert float(ji["err_final"]) < 1e-3 and float(ti["err_final"]) < 1e-3
    assert float(ti["err_init"]) == pytest.approx(float(ji["err_init"]),
                                                  rel=1e-4)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=STATE_ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=STATE_ATOL)


def test_segmented_rerun_is_bitwise_equal():
    cfg, batch = ge._stereo_window()
    solve, _ = tlm.make_solver_impl(convert.solver_config_from_jax(
        dataclasses.replace(cfg, neq="segmented")))
    tb = convert.window_batch_from_jax(batch, device="cpu")
    (e1, l1, i1), (e2, l2, i2) = solve(tb), solve(tb)
    assert torch.equal(e1, e2) and torch.equal(l1, l2)
    assert all(torch.equal(i1[k], i2[k]) for k in i1)


def test_segment_sum_matches_index_add():
    """The fixed-order segment sum equals a float64 index_add_ (with empty
    segments and unsorted keys) to f32 rounding."""
    rng = np.random.default_rng(0)
    keys = torch.as_tensor(rng.integers(0, 50, (300, 3)))
    x = torch.as_tensor(rng.normal(size=(900, 2, 3)).astype(np.float32))
    got = tlm.segment_sum(x, tlm.segment_plan(keys, 60))
    ref = torch.zeros((60, 2, 3), dtype=torch.float64).index_add_(
        0, keys.reshape(-1), x.double())
    assert got.shape == (60, 2, 3)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert torch.all(got[50:] == 0)


def test_no_schur_calls_no_spd_inverse(monkeypatch):
    """Like the JAX package's, the no-Schur branch factors the full system
    and inverts no landmark block."""
    calls = []
    real = tlm.spd_inverse
    monkeypatch.setattr(tlm, "spd_inverse",
                        lambda m: calls.append(m.shape) or real(m))
    cfg, batch = ge._stereo_window()
    tb = convert.window_batch_from_jax(batch, device="cpu")
    for solver in (NO_SCHUR, SCHUR):
        solve, _ = tlm.make_solver_impl(convert.solver_config_from_jax(
            dataclasses.replace(cfg, solver=solver)))
        _, _, info = solve(tb)
        assert (len(calls) > 0) == (solver == SCHUR), solver


def test_get_solver_is_cached():
    cfg = tlm.SolverConfig(obs_model="RangeBearing2D", pose_group="SE2",
                           lm_type="Euclidean2D", max_depth=3)
    a = tlm.get_solver(cfg, "cpu")
    assert tlm.get_solver(cfg, "cpu") is a
    assert tlm.get_solver(dataclasses.replace(cfg), torch.device("cpu")) is a
    assert tlm.get_solver(dataclasses.replace(cfg, neq="segmented"),
                          "cpu") is not a


@pytest.mark.parametrize("field,name", [("solver", "schur_sparse_cholesky"),
                                        ("solver", "Schur_Dense_Cholesky"),
                                        ("neq", "scatter"),
                                        ("neq", "")])
def test_unknown_variant_fails_by_name(field, name):
    """An unknown solver or reduction name raises with the name; it never
    falls through to a default."""
    cfg = tlm.SolverConfig(obs_model="RangeBearing2D", pose_group="SE2",
                           lm_type="Euclidean2D", max_depth=3,
                           **{field: name})
    with pytest.raises(NotImplementedError, match=repr(name)):
        tlm.make_solver_impl(cfg)
