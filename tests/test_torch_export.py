"""The port's exporters (srba_tpu_torch/io/export.py) against the JAX
package's, on the same engine state: a JAX engine runs a short seeded
sequence, its state goes into a port engine through
``srba_tpu_torch.convert``, and every exporter runs on both.

Tolerances: the graph dump, the edge tables, the per-edge weights and the
observation support must be equal; global poses (f32 compositions along the
spanning tree) and the information shapes (a float64 eigendecomposition
rounded to f32) within atol 1e-5; numbers in the g2o and scene files within
atol 1e-5 after parsing.
"""

import json

import numpy as np
import pytest
import torch

import srba_tpu as J
import srba_tpu_torch as T
from srba_tpu.io import export as jx
from srba_tpu.utils import datasets as jds
from srba_tpu_torch import convert
from srba_tpu_torch.graph import KeyframeGraph
from srba_tpu_torch.io import export as tx

torch.set_num_threads(1)

ATOL = 1e-5


def _jax_engine(model):
    if model == "RelativePoses2D":
        w = jds.make_world_loop_2d(num_kfs=24, radius=5.0, num_landmarks=1,
                                   seed=3)
        ds = jds.make_graph_slam_dataset(w, noise_std=0.01,
                                         loop_closure_range=3.0, seed=3)
    elif model == "RangeBearing2D":
        w = jds.make_world_loop_2d(num_kfs=14, radius=5.0, num_landmarks=40,
                                   seed=3)
        ds = jds.observe(w, model, noise_std=0.005, sensor_range=5.0,
                         odo_noise_std=0.01, seed=3)
    else:
        w = jds.make_world_loop_3d(num_kfs=12, radius=6.0, num_landmarks=60,
                                   seed=3)
        ds = jds.observe(w, model, noise_std=0.005, sensor_range=5.0,
                         odo_noise_std=0.01, seed=3)
    eng = J.SrbaEngine(model, params=J.SrbaParams(max_tree_depth=3,
                                                  max_optimize_depth=3))
    for k, frame in enumerate(ds.frames):
        eng.define_new_keyframe(
            [J.Observation(lm_id=m, z=z) for m, z in frame],
            edge_init={k - 1: ds.odometry[k - 1]} if k else None)
    st = eng.get_rba_state()
    # Two measured closure fits: a sigma each, and an information matrix on
    # one of them (what the closure bootstrap records).
    dof = st.pose_dof
    st.k2k_sigma[[2, 5]] = (0.5, 0.1)
    a = np.random.default_rng(0).normal(size=(dof, dof))
    st.k2k_info[2] = a @ a.T + 0.1 * np.eye(dof)
    return eng


def _port_engine(jeng, model):
    """A port engine holding ``jeng``'s state and graph."""
    teng = T.SrbaEngine(model, params=T.SrbaParams(max_tree_depth=3,
                                                   max_optimize_depth=3),
                        device="cpu")
    teng.state = convert.problem_state_from_jax(jeng.get_rba_state())
    g = KeyframeGraph(jeng.graph.max_tree_depth)
    for _ in range(jeng.graph.num_kfs):
        g.add_keyframe()
    for a, b in jeng.graph.edges:
        g.add_edge(a, b)
    teng.graph = g
    return teng


MODELS = ["RelativePoses2D", "RangeBearing2D", "RangeBearing3D"]


@pytest.fixture(scope="module", params=MODELS)
def engines(request):
    jeng = _jax_engine(request.param)
    return jeng, _port_engine(jeng, request.param)


def test_state_carries_closure_fits(engines):
    jeng, teng = engines
    js, ts = jeng.get_rba_state(), teng.get_rba_state()
    assert ts.pose_dof == js.pose_dof
    np.testing.assert_array_equal(ts.k2k_sigma, js.k2k_sigma)
    np.testing.assert_array_equal(ts.k2k_info, js.k2k_info)


@pytest.mark.parametrize("with_edge_info", [False, True])
def test_global_graphslam_problem_matches_jax(engines, with_edge_info):
    jeng, teng = engines
    pj = jx.get_global_graphslam_problem(jeng, with_edge_info=with_edge_info)
    pt = tx.get_global_graphslam_problem(teng, with_edge_info=with_edge_info)
    assert set(pt) == set(pj)
    assert pt["group"] == pj["group"] and pt["reachable"] == pj["reachable"]
    np.testing.assert_allclose(pt["nodes"], pj["nodes"], atol=ATOL)
    assert [(e["from"], e["to"]) for e in pt["edges"]] == \
        [(e["from"], e["to"]) for e in pj["edges"]]
    np.testing.assert_array_equal(
        np.stack([e["rel_pose"] for e in pt["edges"]]),
        np.stack([e["rel_pose"] for e in pj["edges"]]))
    np.testing.assert_array_equal(pt["edge_weights"], pj["edge_weights"])
    assert (pt["edge_weights"] < 1).sum() == 1       # sigma 0.5 > 0.25
    assert ("edge_info_sqrt" in pt) == with_edge_info
    if with_edge_info:
        np.testing.assert_allclose(pt["edge_info_sqrt"], pj["edge_info_sqrt"],
                                   atol=ATOL)
    unweighted = tx.get_global_graphslam_problem(teng, with_weights=False)
    assert "edge_weights" not in unweighted


def test_edge_observation_support_matches_jax(engines):
    jeng, teng = engines
    np.testing.assert_array_equal(tx.edge_observation_support(teng),
                                  jx.edge_observation_support(jeng))


@pytest.mark.parametrize("root", [None, 3])
def test_graph_as_dot_matches_jax(engines, root, tmp_path):
    jeng, teng = engines
    pj, pt = tmp_path / "j.dot", tmp_path / "t.dot"
    jx.save_graph_as_dot(jeng, str(pj), show_spanning_tree_root=root)
    tx.save_graph_as_dot(teng, str(pt), show_spanning_tree_root=root)
    assert pt.read_text() == pj.read_text()


def _tokens_close(a: str, b: str):
    """Two text files equal line by line, word by word, numbers within
    ATOL."""
    la, lb = a.splitlines(), b.splitlines()
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        wx, wy = x.split(), y.split()
        assert len(wx) == len(wy), (x, y)
        for u, v in zip(wx, wy):
            try:
                fu, fv = float(u), float(v)
            except ValueError:
                assert u == v, (x, y)
                continue
            assert abs(fu - fv) <= ATOL, (x, y)


def test_graphslam_g2o_matches_jax(engines, tmp_path):
    jeng, teng = engines
    pj, pt = tmp_path / "j.g2o", tmp_path / "t.g2o"
    jx.save_graphslam_g2o(jeng, str(pj))
    tx.save_graphslam_g2o(teng, str(pt))
    _tokens_close(pt.read_text(), pj.read_text())
    head = pt.read_text().split()[0]
    assert head in ("VERTEX_SE2", "VERTEX_SE3:QUAT")


@pytest.mark.parametrize("root", [None, 0])
def test_opengl_scene_and_writers_match_jax(engines, root, tmp_path):
    jeng, teng = engines
    sj = jx.build_opengl_representation(jeng, span_tree_root=root)
    st = tx.build_opengl_representation(teng, span_tree_root=root)
    assert set(st) == set(sj)
    for k in ("kf_positions", "kf_poses", "landmarks"):
        assert st[k].shape == sj[k].shape, k
        np.testing.assert_allclose(st[k], sj[k], atol=ATOL)
    for k in ("k2k_edges", "spanning_tree_edges", "frame_axis_len"):
        assert st[k] == sj[k], k
    if jeng.model.is_pose_landmark:
        assert len(st["landmarks"]) == 0
    else:
        assert len(st["landmarks"]) > 0
    jx.save_scene_json(sj, str(tmp_path / "j.json"))
    tx.save_scene_json(st, str(tmp_path / "t.json"))
    dj = json.loads((tmp_path / "j.json").read_text())
    dt = json.loads((tmp_path / "t.json").read_text())
    assert set(dt) == set(dj)
    for k in dj:
        if k in ("kf_positions", "kf_poses", "landmarks"):
            np.testing.assert_allclose(np.asarray(dt[k]).reshape(-1),
                                       np.asarray(dj[k]).reshape(-1),
                                       atol=ATOL)
        else:
            assert dt[k] == dj[k], k
    jx.save_scene_ply(sj, str(tmp_path / "j.ply"))
    tx.save_scene_ply(st, str(tmp_path / "t.ply"))
    _tokens_close((tmp_path / "t.ply").read_text(),
                  (tmp_path / "j.ply").read_text())
