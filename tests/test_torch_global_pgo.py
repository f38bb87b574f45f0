"""The port's global pose-graph optimizer against the JAX package, on the CPU,
from the same seeded numpy problems (tests/test_global_pgo.py's
``_circle_problem``): the hand-written forward-mode edge Jacobians against
``jax.jacfwd``, the deterministic segment sums against
``jax.ops.segment_sum``, whole solves, the behaviour tests of
tests/test_global_pgo.py, and ``SrbaEngine.optimize_global`` against the
JAX engine.

Tolerances: Jacobians at atol 1e-5 (f32 chains of a few compose/log steps
at poses of norm ~5); segment sums at atol 1e-5 (sums of ~50 O(1) terms in
another order); whole solves at atol 1e-3 on nodes and rel 1e-3 on
``err_final`` (f32 LM/CG iterates whose roundings differ between the
frameworks), with equal ``iters``/``cg_iters_total``/``converged`` where
every accept/reject decision is decisive; engines at atol 1e-3 on poses.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srba_tpu as J
import srba_tpu_torch as T
from srba_tpu.ops import lie as jlie
from srba_tpu.solver import global_graphslam as jg
from srba_tpu.utils import datasets as jds
from srba_tpu_torch.ops import lie as tlie
from srba_tpu_torch.ops.np_lie import NpSE2
from srba_tpu_torch.solver import global_graphslam as tg
from srba_tpu_torch.solver.pgo_ops import EdgeIncidence
from srba_tpu_torch.utils import datasets as tds
from srba_tpu_torch.utils.profiler import Profiler
from test_global_pgo import _circle_problem, _pos_ate

torch.set_num_threads(1)

JAC_ATOL, SEG_ATOL = 1e-5, 1e-5
NODE_ATOL, ERR_RTOL = 1e-3, 1e-3
POSE_ATOL = 1e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _edge_inputs(group, point, n=48, seed=0):
    """(Ga, Gb, z) rows: random poses, or zero-noise circle edges between
    their own exact nodes plus identity rows, where the residual's
    ``compose(inv(z), pred)`` is the identity (``quat_log`` at its tie)."""
    rng = np.random.default_rng(seed)
    if point == "random":
        if group == "SE2":
            P = np.concatenate([rng.normal(0, 2, (3 * n, 2)),
                                rng.uniform(-np.pi, np.pi, (3 * n, 1))], -1)
        else:
            q = rng.normal(size=(3 * n, 4))
            q /= np.linalg.norm(q, axis=-1, keepdims=True)
            P = np.concatenate([rng.normal(0, 2, (3 * n, 3)), q], -1)
        P = P.astype(np.float32)
        return P[:n], P[n:2 * n], P[2 * n:]
    prob, _ = _circle_problem(group, K=n, noise=0.0, n_closures=0)
    ea = np.asarray([e["from"] for e in prob["edges"]])
    eb = np.asarray([e["to"] for e in prob["edges"]])
    z = np.stack([e["rel_pose"] for e in prob["edges"]])
    ident = np.asarray(jlie.GROUPS[group].identity())[None].repeat(4, 0)
    G = prob["nodes"]
    return (np.concatenate([G[ea], ident]), np.concatenate([G[eb], ident]),
            np.concatenate([z, ident]).astype(np.float32))


@pytest.mark.parametrize("point", ["random", "identity_residual"])
@pytest.mark.parametrize("group", ["SE2", "SE3"])
def test_residual_jacobians_match_jax_jacfwd(group, point):
    Ga, Gb, z = _edge_inputs(group, point)
    dof = jlie.GROUPS[group].dof
    res = jg._make_residual(jlie.GROUPS[group])
    zeros = jnp.zeros((Ga.shape[0], dof), jnp.float32)
    args = (jnp.asarray(Ga), jnp.asarray(Gb), jnp.asarray(z), zeros, zeros)
    r_ref = np.asarray(jax.vmap(res)(*args))
    A_ref = np.asarray(jax.vmap(jax.jacfwd(res, argnums=3))(*args))
    B_ref = np.asarray(jax.vmap(jax.jacfwd(res, argnums=4))(*args))
    if point == "identity_residual" and group == "SE3":
        G = jlie.SE3
        c = np.asarray(jax.vmap(lambda a, b, zz: G.compose(
            G.inverse(zz), G.compose(G.inverse(a), b)))(*args[:3]))
        assert (c[:, 3] == 1.0).any()   # the quat_log clip tie is hit
    r, A, B = tg._make_residual_jacobians(tlie.GROUPS[group])(
        _t(Ga), _t(Gb), _t(z))
    np.testing.assert_allclose(r.numpy(), r_ref, atol=JAC_ATOL)
    np.testing.assert_allclose(A.numpy(), A_ref, atol=JAC_ATOL)
    np.testing.assert_allclose(B.numpy(), B_ref, atol=JAC_ATOL)


@pytest.mark.parametrize("shape", [(), (3,), (3, 3)])
def test_segment_sum_matches_jax(shape):
    """EdgeIncidence.sum == segment_sum(xa, ea) + segment_sum(xb, eb),
    with a hub node of degree 60 and weight-0 padding rows left out."""
    rng = np.random.default_rng(1)
    K, E_live, E = 40, 90, 128
    ea = rng.integers(0, K, E_live)
    eb = rng.integers(0, K, E_live)
    ea[:30] = 7
    eb[30:60] = 7                                  # node 7: degree >= 60
    inc = EdgeIncidence(ea, eb, K, E, "cpu")
    assert inc.width == max(np.bincount(np.concatenate([ea, eb])))
    assert inc.width >= 60
    xa = rng.normal(size=(E,) + shape).astype(np.float32)
    xb = rng.normal(size=(E,) + shape).astype(np.float32)
    xa[E_live:] = xb[E_live:] = 0.0                 # padding adds zeros
    ea_p = np.concatenate([ea, np.zeros(E - E_live, int)])
    eb_p = np.concatenate([eb, np.zeros(E - E_live, int)])
    ref = (jax.ops.segment_sum(jnp.asarray(xa), jnp.asarray(ea_p),
                               num_segments=K)
           + jax.ops.segment_sum(jnp.asarray(xb), jnp.asarray(eb_p),
                                 num_segments=K))
    out = inc.sum(_t(xa), _t(xb))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=SEG_ATOL)
    # Fixed order: the same call gives the same bits.
    assert torch.equal(out, inc.sum(_t(xa), _t(xb)))


VARIANTS = {
    "default": {},
    "robust_rot_info_chordal": dict(robust_delta=0.1, rot_weight=2.0,
                                    use_edge_info=True, chordal_init=True),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("group", ["SE2", "SE3"])
def test_solve_matches_jax(group, variant):
    prob, _ = _circle_problem(group)
    kw = VARIANTS[variant]
    Gj, ij = jg.optimize_global_pose_graph(prob, jg.PGOConfig(group, **kw))
    Gt, it = tg.optimize_global_pose_graph(prob, tg.PGOConfig(group, **kw),
                                           device="cpu")
    assert set(it) == set(ij)
    np.testing.assert_allclose(Gt, Gj, atol=NODE_ATOL)
    assert it["err_final"] == pytest.approx(ij["err_final"], rel=ERR_RTOL)
    assert it["err_init"] == pytest.approx(ij["err_init"], rel=ERR_RTOL)
    for k in ("iters", "cg_iters_total", "converged", "escalations"):
        assert it[k] == ij[k], k


def test_config_fields_and_defaults_match_jax():
    fj = {f.name: f.default for f in dataclasses.fields(jg.PGOConfig)}
    ft = {f.name: f.default for f in dataclasses.fields(tg.PGOConfig)}
    assert ft == fj


# -- behaviour (the port's counterparts of tests/test_global_pgo.py) ---------


@pytest.mark.parametrize("group,d", [("SE2", 2), ("SE3", 3)])
def test_circle_converges_with_fixed_gauge(group, d):
    prob, gt = _circle_problem(group)
    ate0 = _pos_ate(prob["nodes"], gt, d)
    G, info = tg.optimize_global_pose_graph(prob, device="cpu")
    assert info["err_final"] < info["err_init"]
    assert _pos_ate(G, gt, d) < 0.35 * ate0
    np.testing.assert_allclose(G[0], prob["nodes"][0], atol=1e-6)


def test_zero_noise_is_fixpointish():
    prob, gt = _circle_problem("SE2", noise=0.0)
    G, info = tg.optimize_global_pose_graph(prob, device="cpu")
    assert info["err_final"] < 1e-8
    assert _pos_ate(G, gt, 2) < 1e-3


def test_warm_lambda_converges_from_either_start():
    prob, _ = _circle_problem("SE2", K=50, seed=4)
    cfg = tg.PGOConfig(group="SE2", cg_iters=47)
    G_a, i_a = tg.optimize_global_pose_graph(prob, cfg, device="cpu")
    G_b, i_b = tg.optimize_global_pose_graph(prob, cfg, lam0=1e-2,
                                             device="cpu")
    assert i_a["converged"] and i_b["converged"]
    np.testing.assert_allclose(G_a, G_b, atol=5e-3)
    # The damping path from the warm lambda, over the first three LM steps
    # (each a decisive accept; the steps at the fixed point compare errors
    # that differ in the last f32 bits, where the frameworks may decide
    # apart).
    short = dict(cg_iters=47, max_outer=3)
    _, j_b = jg.optimize_global_pose_graph(prob, jg.PGOConfig("SE2", **short),
                                           lam0=1e-2, max_escalations=0)
    _, t_b = tg.optimize_global_pose_graph(prob, tg.PGOConfig("SE2", **short),
                                           lam0=1e-2, max_escalations=0,
                                           device="cpu")
    assert t_b["lam"] == pytest.approx(1e-5) == j_b["lam"]
    assert (t_b["iters"], t_b["cg_iters_total"]) == (
        j_b["iters"], j_b["cg_iters_total"])
    assert t_b["err_final"] == pytest.approx(j_b["err_final"], rel=ERR_RTOL)


def test_edge_info_identity_matches_scalar_path():
    prob, _ = _circle_problem("SE2", K=50, seed=7)
    G_s, i_s = tg.optimize_global_pose_graph(prob, device="cpu")
    prob_i = dict(prob)
    prob_i["edge_info_sqrt"] = np.tile(np.eye(3, dtype=np.float32),
                                       (len(prob["edges"]), 1, 1))
    G_i, i_i = tg.optimize_global_pose_graph(prob_i, device="cpu")
    assert i_i["err_final"] == pytest.approx(i_s["err_final"], rel=1e-4,
                                             abs=1e-8)
    np.testing.assert_allclose(G_i, G_s, atol=1e-4)


def test_edge_info_downweights_unmeasured_direction():
    prob, gt = _circle_problem("SE2", K=40, n_closures=1, seed=8)
    E = len(prob["edges"])
    prob["edges"][-1]["rel_pose"] = (
        np.asarray(prob["edges"][-1]["rel_pose"], np.float32)
        + np.asarray([0.5, 0, 0], np.float32))
    shapes = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
    G_s, _ = tg.optimize_global_pose_graph(prob, device="cpu")
    shapes[-1, 0, 0] = np.sqrt(0.05)
    prob_i = dict(prob)
    prob_i["edge_info_sqrt"] = shapes
    G_i, i_i = tg.optimize_global_pose_graph(prob_i, device="cpu")
    assert i_i["converged"] == 1.0

    def closure_x_residual(G):
        e = prob["edges"][-1]
        pred = NpSE2.compose(NpSE2.inverse(G[e["from"]]), G[e["to"]])
        return abs(float(pred[0] - e["rel_pose"][0]))

    assert closure_x_residual(G_i) > closure_x_residual(G_s)
    assert _pos_ate(G_i, gt, 2) <= _pos_ate(G_s, gt, 2) + 1e-3


def test_padding_changes_no_output():
    """Bucket padding (identity nodes without edges, weight-0 edges at node
    0) leaves the solution of the live nodes as the unpadded solve's, and
    is sliced back off."""
    prob, _ = _circle_problem("SE2", K=60, seed=5)
    cfg = tg.PGOConfig(group="SE2")
    G_pad, i_pad = tg.optimize_global_pose_graph(prob, cfg, device="cpu")
    assert G_pad.shape == prob["nodes"].shape
    ea = torch.as_tensor([e["from"] for e in prob["edges"]])
    eb = torch.as_tensor([e["to"] for e in prob["edges"]])
    z = _t(np.stack([e["rel_pose"] for e in prob["edges"]]))
    G, info = tg._make_pgo(cfg)(_t(prob["nodes"]), ea, eb, z,
                                torch.ones(len(ea)), cfg.lam0)
    np.testing.assert_allclose(G_pad, G.numpy(), atol=1e-5)
    assert (i_pad["iters"], i_pad["cg_iters_total"]) == (
        info["iters"], info["cg_iters_total"])


def test_bucketed_shapes_slice_back():
    rng = np.random.default_rng(3)
    cfg = tg.PGOConfig(group="SE2", max_outer=5, cg_iters=10)
    for K in (300, 400):
        th = np.linspace(0, 2, K).astype(np.float32)
        gt = np.stack([np.stack([np.cos(t), np.sin(t), t]) for t in th])
        edges = [{"from": k - 1, "to": k, "rel_pose": NpSE2.compose(
            NpSE2.inverse(gt[k - 1]), gt[k])} for k in range(1, K)]
        nodes = (gt + rng.normal(0, 0.01, gt.shape)).astype(np.float32)
        nodes[0] = gt[0]
        G, info = tg.optimize_global_pose_graph(
            {"group": "SE2", "nodes": nodes, "edges": edges}, cfg,
            device="cpu")
        assert G.shape == (K, 3) and np.isfinite(info["err_final"])


def test_escalation_and_warning_match_jax(capfd):
    prob, _ = _circle_problem("SE3", K=40, seed=2)
    Gj, ij = jg.optimize_global_pose_graph(
        prob, jg.PGOConfig("SE3", max_outer=2))
    capfd.readouterr()
    Gt, it = tg.optimize_global_pose_graph(
        prob, tg.PGOConfig("SE3", max_outer=2), device="cpu")
    err = capfd.readouterr().err
    assert it["escalations"] == ij["escalations"] == 1.0
    assert it["iters"] == ij["iters"] == 4.0
    assert it["converged"] == ij["converged"] == 0.0
    assert "[srba] WARNING: global PGO unconverged after 4 LM iterations " \
        "(1 escalations)" in err
    np.testing.assert_allclose(Gt, Gj, atol=NODE_ATOL)


def test_empty_graph_returns_nodes():
    nodes = np.zeros((3, 3), np.float32)
    G, info = tg.optimize_global_pose_graph(
        {"group": "SE2", "nodes": nodes, "edges": []}, device="cpu")
    assert np.array_equal(G, nodes) and info["converged"] == 1


def test_profiler_scopes_and_host_syncs():
    prob, _ = _circle_problem("SE2", K=30, seed=1)
    prof = Profiler()
    _, info = tg.optimize_global_pose_graph(
        prob, tg.PGOConfig("SE2", chordal_init=True), device="cpu",
        profiler=prof)
    for s in ("pgo_chordal", "pgo_linearize", "pgo_cg", "pgo_eval"):
        assert prof.stats[s].count > 0, s
    assert prof.stats["pgo_linearize"].count == info["iters"]
    assert prof.counters["pgo_solves"] == 1
    # One exit-test read per LM iteration and one per CG trip.
    assert prof.counters["pgo_host_syncs"] >= (info["iters"]
                                               + info["cg_iters_total"])
    assert "pgo_host_syncs" in prof.report()
    ends = [e[k] for e in prob["edges"] for k in ("from", "to")]
    assert prof.counters["pgo_incidence_width"] == max(np.bincount(ends))


def test_unported_mesh_paths_raise(monkeypatch):
    """The mesh paths are ported: on a one-rank gloo mesh the edge-sharded
    solve (through ``mesh=``, through :func:`make_pgo_spmd` on the padded
    tables, and with ``axis_name`` over the world's group) is bitwise the
    unsharded one; CUDA where there is none still raises."""
    from tests.test_torch_sharding import one_rank_mesh

    mesh = one_rank_mesh()
    prob, _ = _circle_problem("SE2", K=20)
    G, info = tg.optimize_global_pose_graph(prob, device="cpu")
    G_m, info_m = tg.optimize_global_pose_graph(prob, mesh=mesh,
                                                device="cpu")
    np.testing.assert_array_equal(G_m, G)
    assert info_m == info
    ea = np.asarray([e["from"] for e in prob["edges"]])
    eb = np.asarray([e["to"] for e in prob["edges"]])
    z = np.stack([e["rel_pose"] for e in prob["edges"]])
    w = np.ones(len(ea), np.float32)
    G_s, info_s = tg.make_pgo_spmd(tg.PGOConfig("SE2"), mesh)(
        prob["nodes"], ea, eb, z, w, 1e-4)
    G_1, info_1 = tg._make_pgo(tg.PGOConfig("SE2"))(
        torch.as_tensor(prob["nodes"]), torch.as_tensor(ea),
        torch.as_tensor(eb), torch.as_tensor(z), torch.as_tensor(w), 1e-4)
    assert torch.equal(G_s, G_1) and info_s == info_1
    G_a, info_a = tg.optimize_global_pose_graph(
        prob, tg.PGOConfig("SE2", axis_name="edges"), device="cpu")
    np.testing.assert_array_equal(G_a, G)
    assert info_a == info
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tg.optimize_global_pose_graph(prob, device="cuda")


# -- engine -------------------------------------------------------------------


def _graph_slam_engine(pkg, mod, num_kfs, seed, **kw):
    world = mod.make_world_loop_2d(num_kfs=num_kfs, radius=6.0,
                                   num_landmarks=1, seed=seed)
    ds = mod.make_graph_slam_dataset(world, noise_std=0.01,
                                     loop_closure_range=3.0, seed=seed)
    eng = pkg.SrbaEngine("RelativePoses2D",
                         params=pkg.SrbaParams(max_tree_depth=3,
                                               max_optimize_depth=3), **kw)
    return eng, ds


def _feed(pkg, eng, ds, k):
    frame = ds.frames[k]
    eng.define_new_keyframe(
        [pkg.Observation(lm_id=m, z=z) for m, z in frame],
        edge_init={k - 1: ds.odometry[k - 1]} if k > 0 else None)


def _edges(eng):
    st = eng.get_rba_state()
    return st.k2k_pose[: st.num_edges]


def test_engine_optimize_global_matches_jax():
    """tests/test_global_pgo.py's 30-KF engine through both packages:
    same optimized globals, same solve, the map no worse, and incremental
    operation continuing after the write-back."""
    out = {}
    for pkg, mod, kw in ((J, jds, {}), (T, tds, dict(device="cpu"))):
        eng, ds = _graph_slam_engine(pkg, mod, 30, 2, **kw)
        for k in range(len(ds.frames)):
            _feed(pkg, eng, ds, k)
        err_before = eng.eval_overall_squared_error()
        G, info = eng.optimize_global()
        err_after = eng.eval_overall_squared_error()
        assert info["err_final"] <= info["err_init"] + 1e-9
        assert err_after <= err_before * 1.05 + 1e-6
        edges_wb = _edges(eng).copy()
        eng.define_new_keyframe(
            [pkg.Observation(lm_id=eng.num_keyframes - 1,
                             z=ds.odometry[-1])],
            edge_init={eng.num_keyframes - 1: ds.odometry[-1]})
        out[pkg] = (G, info, err_after, edges_wb, _edges(eng).copy(),
                    eng.eval_overall_squared_error())
    (Gj, ij, ej, wj, nj, fj), (Gt, it, et, wt, nt, ft) = out[J], out[T]
    np.testing.assert_allclose(Gt, Gj, atol=POSE_ATOL)
    for k in ("iters", "cg_iters_total", "converged"):
        assert it[k] == ij[k], k
    assert et == pytest.approx(ej, rel=2e-3)
    np.testing.assert_allclose(wt, wj, atol=POSE_ATOL)
    np.testing.assert_allclose(nt, nj, atol=POSE_ATOL)
    assert ft == pytest.approx(fj, rel=2e-3)


def test_engine_periodic_mode_matches_jax_and_warm_starts():
    out = {}
    for pkg, mod, kw in ((J, jds, {}), (T, tds, dict(device="cpu"))):
        eng, ds = _graph_slam_engine(pkg, mod, 40, 6, **kw)
        infos = []
        for k in range(len(ds.frames)):
            _feed(pkg, eng, ds, k)
            if k == 25:
                _, info_mid = eng.optimize_global(periodic=True)
                assert info_mid["converged"] == 1.0
                assert eng._pgo_warm_lam == pytest.approx(info_mid["lam"])
                infos.append(info_mid)
        _, info2 = eng.optimize_global(periodic=True)
        assert info2["converged"] == 1.0
        G, info_t = eng.optimize_global()
        assert info_t["converged"] == 1.0
        out[pkg] = (infos + [info2, info_t], G)
    (ij, Gj), (it, Gt) = out[J], out[T]
    for a, b in zip(ij, it):
        assert (b["iters"], b["converged"]) == (a["iters"], a["converged"])
    np.testing.assert_allclose(Gt, Gj, atol=POSE_ATOL)


def test_periodic_keeps_a_callers_rel_tol(monkeypatch):
    """Periodic mode applies rel_tol 1e-3 to the engine's default config
    only; a caller's PGOConfig keeps its own (the JAX package overwrites
    it)."""
    seen = []
    real = tg.optimize_global_pose_graph

    def spy(prob, cfg, **kw):
        seen.append(cfg)
        return real(prob, cfg, **kw)

    monkeypatch.setattr(tg, "optimize_global_pose_graph", spy)
    eng, ds = _graph_slam_engine(T, tds, 12, 6, device="cpu")
    for k in range(len(ds.frames)):
        _feed(T, eng, ds, k)
    mine = tg.PGOConfig(group="SE2", rel_tol=1e-7)
    eng.optimize_global(mine, periodic=True)
    eng.optimize_global(periodic=True)
    eng.optimize_global()
    assert [c.rel_tol for c in seen] == [1e-7, 1e-3, 1e-5]
    assert seen[1].chordal_init and seen[1].robust_delta == 0.1


def test_engine_profiles_its_pgo_only_when_asked():
    """The engine's PGO takes a profiler (whose scopes wait for the
    device) only from its caller, never its own keyframe profiler."""
    eng, ds = _graph_slam_engine(T, tds, 12, 6, device="cpu")
    for k in range(len(ds.frames)):
        _feed(T, eng, ds, k)
    _, info = eng.optimize_global(write_back=False)
    assert not any(s.startswith("pgo_") for s in eng.profiler.stats)
    assert not eng.profiler.counters
    prof = Profiler()
    _, info_p = eng.optimize_global(write_back=False, profiler=prof)
    assert info_p == info
    assert prof.counters["pgo_solves"] == 1
    assert prof.stats["pgo_eval"].count > 0


def test_upload_from_host_replaces_masters_and_steps_on():
    """The write-back's upload clears staging, drops a pending prefetch,
    marks the mirror current, and the next keyframe steps from it."""
    eng, ds = _graph_slam_engine(T, tds, 20, 3, device="cpu")
    for k in range(15):
        _feed(T, eng, ds, k)
    dm = eng.device_master
    dm.maybe_prefetch(0, force=True)
    assert dm._prefetch is not None
    st = eng.get_rba_state()
    new_pose = st.k2k_pose.copy()
    new_pose[: st.num_edges, 0] += 0.25
    dm.stage_edge(np.zeros(3, np.float32))
    dm.upload_from_host(new_pose, st.lm_state, st.num_edges, st.num_lms,
                        k2k_prior=st.k2k_prior, k2k_prior_w=st.k2k_prior_w)
    assert dm._prefetch is None and not dm.dirty
    assert not dm._pend_edges and dm.num_edges == st.num_edges
    assert dm.pose.shape[0] >= dm.INIT_EDGE_CAP
    np.testing.assert_array_equal(dm.pose[: st.num_edges].numpy(),
                                  new_pose[: st.num_edges])
    np.testing.assert_array_equal(
        dm.prior[: st.num_edges, :3].numpy(), st.k2k_prior[: st.num_edges])
    st.k2k_pose[:] = new_pose
    for k in range(15, 20):
        _feed(T, eng, ds, k)
    assert np.isfinite(eng.eval_overall_squared_error())


def test_bfs_visitor_matches_jax():
    jw = jds.make_world_loop_2d(num_kfs=12, radius=5.0, num_landmarks=40,
                                seed=9)
    tw = tds.make_world_loop_2d(num_kfs=12, radius=5.0, num_landmarks=40,
                                seed=9)
    seqs = []
    for pkg, mod, w, kw in ((J, jds, jw, {}), (T, tds, tw,
                                                dict(device="cpu"))):
        ds = mod.observe(w, "RangeBearing2D", noise_std=0.005,
                         sensor_range=5.0, odo_noise_std=0.01, seed=9)
        eng = pkg.SrbaEngine("RangeBearing2D", **kw)
        for k in range(len(ds.frames)):
            _feed(pkg, eng, ds, k)
        log = []
        dist = eng.bfs_visitor(
            5, 3, kf_visitor=lambda *a: log.append(("kf",) + a),
            k2k_visitor=lambda *a: log.append(("k2k",) + a),
            lm_visitor=lambda *a: log.append(("lm",) + a),
            k2f_visitor=lambda *a: log.append(("k2f",) + a))
        seqs.append((log, dist))
    assert seqs[1] == seqs[0]
    assert any(e[0] == "lm" for e in seqs[1][0])
