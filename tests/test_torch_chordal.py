"""The port's chordal initializer (srba_tpu_torch/solver/chordal.py) against
the JAX package on the CPU, from the same seeded numpy problems
(tests/test_chordal.py's ``_drifted_problem``), and the port's counterparts
of the behaviour tests in tests/test_chordal.py.

Tolerances: ``make_chordal_init`` at atol 1e-4 on nodes (two f32 Jacobi-CG
solves of a few hundred iterations whose sums run in another order);
``_matrix_to_quat`` and ``_project_so`` at atol 1e-5 (a few f32 operations
on O(1) entries; the SVD projection is unique for near-rotation inputs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srba_tpu.ops.np_lie import NpSE3
from srba_tpu.solver import chordal as jc
from srba_tpu_torch.solver import chordal as tc
from srba_tpu_torch.solver.global_graphslam import (
    PGOConfig, optimize_global_pose_graph)
from srba_tpu_torch.solver.pgo_ops import HostReads
from test_chordal import _ate, _drifted_problem, _se3_circle

torch.set_num_threads(1)

NODE_ATOL, ROT_ATOL = 1e-4, 1e-5


def _se2_circle(K, radius):
    th = 2 * np.pi * np.arange(K) / K
    gt = np.stack([np.asarray([radius * np.cos(t), radius * np.sin(t),
                               t + np.pi / 2], np.float32) for t in th])
    gt[:, 2] = np.arctan2(np.sin(gt[:, 2]), np.cos(gt[:, 2]))
    return gt


def _problem(group):
    """Multi-revolution yaw drift (tests/test_chordal.py) plus two nodes no
    edge touches and two weight-0 padding edges."""
    if group == "SE2":
        K = 100
        gt = _se2_circle(K, 8.0)
        closures = [(i, (i + 50) % K) for i in range(0, K, 10)] + [(0, K - 1)]
        prob = _drifted_problem("SE2", gt, 3.0, closures)
        extra = np.asarray([[9, 9, 0.3], [-9, 9, -2.0]], np.float32)
    else:
        K = 120
        gt = _se3_circle(K, 10.0)
        closures = [(i, (i + 60) % K) for i in range(0, K, 10)] + [(0, K - 1)]
        prob = _drifted_problem("SE3", gt, 4.0, closures)
        extra = np.stack([NpSE3.pexp(np.asarray(
            [9, 9, 9, 0.3, 0.2, 0.1], np.float32))] * 2)
    G0 = np.concatenate([prob["nodes"], extra]).astype(np.float32)
    ea = np.asarray([e["from"] for e in prob["edges"]] + [0, 0])
    eb = np.asarray([e["to"] for e in prob["edges"]] + [0, 0])
    z = np.stack([e["rel_pose"] for e in prob["edges"]]).astype(np.float32)
    z = np.concatenate([z, z[:2]])
    w = np.ones(len(ea), np.float32)
    w[-2:] = 0.0
    return G0, ea, eb, z, w


@pytest.mark.parametrize("group", ["SE2", "SE3"])
def test_chordal_init_matches_jax(group):
    G0, ea, eb, z, w = _problem(group)
    ref = np.asarray(jc.make_chordal_init(group, 300, cg_rtol=1e-7)(
        jnp.asarray(G0), jnp.asarray(ea, jnp.int32),
        jnp.asarray(eb, jnp.int32), jnp.asarray(z), jnp.asarray(w)))
    reads = HostReads()
    out = tc.make_chordal_init(group, 300, cg_rtol=1e-7)(
        torch.from_numpy(G0), torch.from_numpy(ea), torch.from_numpy(eb),
        torch.from_numpy(z), torch.from_numpy(w), reads=reads).numpy()
    np.testing.assert_allclose(out, ref, atol=NODE_ATOL)
    # The two nodes without edges keep their input.
    np.testing.assert_allclose(out[-2:], G0[-2:], atol=NODE_ATOL)
    assert reads.n > 0


def _rotations(n, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    R = np.asarray(jc.quat_to_matrix(jnp.asarray(q, jnp.float32)))
    # Half-turns about x, y, z and the identity: each of Shepperd's four
    # branches wins once (trace, m00, m11, m22 largest).
    special = np.stack([np.eye(3), np.diag([1., -1., -1.]),
                        np.diag([-1., 1., -1.]), np.diag([-1., -1., 1.])])
    return np.concatenate([R, special]).astype(np.float32)


def test_matrix_to_quat_matches_jax():
    R = _rotations(64, 0)
    ref = np.asarray(jc._matrix_to_quat(jnp.asarray(R)))
    out = tc._matrix_to_quat(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(out, ref, atol=ROT_ATOL)
    scores = np.stack([np.trace(R, axis1=1, axis2=2), R[:, 0, 0], R[:, 1, 1],
                       R[:, 2, 2]], -1)
    assert set(np.argmax(scores[-4:], -1)) == {0, 1, 2, 3}


@pytest.mark.parametrize("d", [2, 3])
def test_project_so_matches_jax(d):
    rng = np.random.default_rng(d)
    if d == 2:
        th = rng.uniform(-np.pi, np.pi, 64)
        R = np.asarray(jc._so2_from_theta(jnp.asarray(th, jnp.float32)))
    else:
        R = _rotations(64, 1)
    M = (R + rng.normal(0, 0.1, R.shape)).astype(np.float32)
    R_ref, th_ref = jc._project_so(jnp.asarray(M), d)
    R_out, th_out = tc._project_so(torch.from_numpy(M), d)
    np.testing.assert_allclose(R_out.numpy(), np.asarray(R_ref),
                               atol=ROT_ATOL)
    if d == 2:
        np.testing.assert_allclose(th_out.numpy(), np.asarray(th_ref),
                                   atol=ROT_ATOL)
    else:
        assert th_out is None and th_ref is None
        np.testing.assert_allclose(np.linalg.det(R_out.numpy()), 1.0,
                                   atol=1e-5)


# -- behaviour (the port's counterparts of tests/test_chordal.py) ------------


def test_se3_four_revolutions_yaw_drift_converges():
    radius = 10.0
    gt = _se3_circle(120, radius)
    closures = [(i, (i + 60) % 120) for i in range(0, 120, 10)] + [(0, 119)]
    prob = _drifted_problem("SE3", gt, yaw_revolutions=4.0,
                            closures=closures)
    assert _ate(prob["nodes"], gt, 3) > radius
    G, info = optimize_global_pose_graph(
        prob, PGOConfig(group="SE3", max_outer=40, cg_iters=100,
                        chordal_init=True, chordal_cg_iters=400),
        device="cpu")
    assert _ate(G, gt, 3) < 0.1, info


def test_se3_chordal_not_worse_on_easy_problem():
    gt = _se3_circle(60, 6.0)
    prob = _drifted_problem("SE3", gt, yaw_revolutions=0.02,
                            closures=[(0, 59), (10, 40)])
    cfg = dict(group="SE3", max_outer=30, cg_iters=80)
    G_plain, i_plain = optimize_global_pose_graph(prob, PGOConfig(**cfg),
                                                  device="cpu")
    G, info = optimize_global_pose_graph(
        prob, PGOConfig(chordal_init=True, **cfg), device="cpu")
    assert info["err_final"] == pytest.approx(i_plain["err_final"],
                                              rel=0.05, abs=1e-6)
    assert _ate(G, gt, 3) <= _ate(G_plain, gt, 3) * 1.2 + 0.01
    assert info["err_init"] < i_plain["err_init"] / 10


def test_se3_untouched_nodes_keep_input():
    gt = _se3_circle(20, 5.0)
    prob = _drifted_problem("SE3", gt, yaw_revolutions=0.0,
                            closures=[(0, 19)])
    sentinel = np.tile(NpSE3.pexp(
        np.asarray([9, 9, 9, 0.3, 0.2, 0.1], np.float32)), (2, 1))
    prob["nodes"] = np.concatenate([prob["nodes"], sentinel])
    G, _ = optimize_global_pose_graph(
        prob, PGOConfig(group="SE3", max_outer=10, cg_iters=50,
                        chordal_init=True), device="cpu")
    np.testing.assert_allclose(G[-2:], sentinel, atol=1e-3)


def test_se2_three_revolutions_yaw_drift_converges():
    radius, K = 8.0, 100
    gt = _se2_circle(K, radius)
    closures = [(i, (i + 50) % K) for i in range(0, K, 10)] + [(0, K - 1)]
    prob = _drifted_problem("SE2", gt, yaw_revolutions=3.0,
                            closures=closures)
    assert _ate(prob["nodes"], gt, 2) > radius
    G, _ = optimize_global_pose_graph(
        prob, PGOConfig(group="SE2", max_outer=40, cg_iters=100,
                        chordal_init=True, chordal_cg_iters=400),
        device="cpu")
    assert _ate(G, gt, 2) < 0.1
